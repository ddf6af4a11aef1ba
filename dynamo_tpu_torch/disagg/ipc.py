"""CUDA IPC for the direct KV transfer between two processes on one card:
export, open and release, nothing else (``disagg/transfer.py`` decides
when and keeps the offers' lifetimes).

- ``export`` (the prefill worker): each tensor's CUDA IPC memory handle
  (``cuIpcGetMemHandle`` of the allocation that holds it: the caching
  allocator's segment), the tensor's byte offset in it, its shape and
  dtype, the device's UUID, and the handle of an interprocess event the
  gather was recorded behind. Everything is bytes, ints and strings, so
  the descriptor rides the response plane's msgpack.
- ``open`` (the decode worker): maps each handle (``cuIpcOpenMemHandle``,
  one mapping a handle while any pull uses it), wraps the mapped bytes as
  tensors with no copy, and makes the current stream wait for the
  producer's event, so the scatter that reads them runs after the gather
  that wrote them.
- ``release`` (the decode worker, once the reads completed): drops the
  pull's mappings (``cuIpcCloseMemHandle`` when the last user of a handle
  lets go).

torch's own CUDA IPC (``torch.multiprocessing.reductions``) is not used:
its reference counts keep an exported storage alive in the producer until
every consumer freed it, and an offer that is never opened is never
freed. The offer's lifetime here is explicit: a release board and a TTL
in ``transfer.py``. Memory from ``expandable_segments`` cannot be
exported; ``exportable()`` says so and the producer then ships
host-staged.

The driver API is reached through ``ctypes`` (``libcuda.so.1``), loaded at
the first call: importing this module touches no device.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from dynamo_tpu_torch.disagg.protocols import WIRE_DTYPES, dtype_name

#: ``CU_IPC_MEM_LAZY_ENABLE_PEER_ACCESS``, the flag cudaIpcOpenMemHandle
#: passes
_LAZY_PEER = 1


class _Handle(ctypes.Structure):
    # raw bytes: ``bytes(handle)`` is the 64-byte wire form (a c_char
    # array field would read as bytes cut at the first zero)
    _fields_ = [("reserved", ctypes.c_ubyte * 64)]


class _Uuid(ctypes.Structure):
    _fields_ = [("bytes", ctypes.c_ubyte * 16)]


_cu = None


def _driver():
    global _cu
    if _cu is None:
        lib = ctypes.CDLL("libcuda.so.1")
        for name, args in (
                ("cuInit", [ctypes.c_uint]),
                ("cuDeviceGet", [ctypes.POINTER(ctypes.c_int), ctypes.c_int]),
                ("cuCtxGetCurrent", [ctypes.POINTER(ctypes.c_void_p)]),
                ("cuCtxSetCurrent", [ctypes.c_void_p]),
                ("cuDevicePrimaryCtxRetain", [ctypes.POINTER(ctypes.c_void_p),
                                              ctypes.c_int]),
                ("cuMemGetAddressRange_v2", [ctypes.POINTER(ctypes.c_uint64),
                                             ctypes.POINTER(ctypes.c_size_t),
                                             ctypes.c_uint64]),
                ("cuIpcGetMemHandle", [ctypes.POINTER(_Handle),
                                       ctypes.c_uint64]),
                ("cuIpcOpenMemHandle_v2", [ctypes.POINTER(ctypes.c_uint64),
                                           _Handle, ctypes.c_uint]),
                ("cuIpcCloseMemHandle", [ctypes.c_uint64]),
                ("cuDeviceGetUuid", [ctypes.POINTER(_Uuid), ctypes.c_int]),
                ("cuGetErrorString", [ctypes.c_int,
                                      ctypes.POINTER(ctypes.c_char_p)])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _check(lib, lib.cuInit(0), "cuInit")
        _cu = lib
    return _cu


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = ctypes.c_char_p()
        lib.cuGetErrorString(rc, ctypes.byref(msg))
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({(msg.value or b'?').decode()})")


def _bind(device: torch.device):
    """The driver with ``device``'s primary context current on this thread
    (a worker thread has none until it is bound)."""
    cu = _driver()
    ctx = ctypes.c_void_p()
    _check(cu, cu.cuCtxGetCurrent(ctypes.byref(ctx)), "cuCtxGetCurrent")
    if not ctx.value:
        dev = ctypes.c_int()
        idx = device.index if device.index is not None else 0
        _check(cu, cu.cuDeviceGet(ctypes.byref(dev), idx), "cuDeviceGet")
        _check(cu, cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
               "cuDevicePrimaryCtxRetain")
        _check(cu, cu.cuCtxSetCurrent(ctx), "cuCtxSetCurrent")
    return cu


class _Mapped:
    """Mapped device bytes as a ``__cuda_array_interface__`` object, which
    ``torch.as_tensor`` wraps without a copy."""

    def __init__(self, ptr: int, nbytes: int):
        self.__cuda_array_interface__ = {
            "shape": (nbytes,), "typestr": "|u1", "data": (ptr, False),
            "strides": None, "version": 2}


class CudaIpc:
    """Export, open and release of device tensors between processes on one
    card. ``platform`` is what the capability advertises."""

    platform = "cuda"

    def __init__(self, device: torch.device):
        self.device = device
        self._uuid: Optional[str] = None
        #: handle bytes -> [mapped base, users], one mapping a handle
        self._open: dict[bytes, list] = {}

    @staticmethod
    def exportable() -> bool:
        """False when the caching allocator maps its memory with
        ``expandable_segments`` (cuMemCreate memory has no IPC handle)."""
        conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "").replace(" ", "")
        return "expandable_segments:True" not in conf

    def device_uuid(self) -> str:
        if self._uuid is None:
            cu = _bind(self.device)
            u = _Uuid()
            idx = self.device.index if self.device.index is not None else 0
            dev = ctypes.c_int()
            _check(cu, cu.cuDeviceGet(ctypes.byref(dev), idx), "cuDeviceGet")
            _check(cu, cu.cuDeviceGetUuid(ctypes.byref(u), dev),
                   "cuDeviceGetUuid")
            self._uuid = "GPU-" + bytes(u.bytes).hex()
        return self._uuid

    @staticmethod
    def ready_event() -> torch.cuda.Event:
        """An interprocess event recorded now on the current stream: the
        consumer's stream waits for it (behind the gather just enqueued)."""
        ev = torch.cuda.Event(interprocess=True)
        ev.record()
        return ev

    def export(self, tensors: list, ready: torch.cuda.Event) -> dict:
        """The descriptor fields of ``tensors`` (contiguous, on this card):
        ``arrays`` (handle, offset, shape, dtype each), ``event`` and
        ``device``."""
        cu = _bind(self.device)
        arrays = []
        for t in tensors:
            if not t.is_contiguous():
                raise ValueError("only contiguous tensors are exported")
            base, size = ctypes.c_uint64(), ctypes.c_size_t()
            _check(cu, cu.cuMemGetAddressRange_v2(
                ctypes.byref(base), ctypes.byref(size), t.data_ptr()),
                "cuMemGetAddressRange")
            h = _Handle()
            _check(cu, cu.cuIpcGetMemHandle(ctypes.byref(h), base.value),
                   "cuIpcGetMemHandle")
            arrays.append({"shape": list(t.shape), "dtype": dtype_name(t),
                           "handle": bytes(h),
                           "offset": t.data_ptr() - base.value})
        return {"arrays": arrays, "event": bytes(ready.ipc_handle()),
                "device": self.device_uuid()}

    def open(self, desc: dict) -> tuple[list, list]:
        """(tensors over the mapped memory, the handles they hold): the
        current stream waits for the producer's event first. Raises if a
        handle cannot be mapped; nothing stays mapped then."""
        cu = _bind(self.device)
        held, out = [], []
        try:
            for a in desc["arrays"]:
                key = bytes(a["handle"])
                ent = self._open.get(key)
                if ent is None:
                    h = _Handle.from_buffer_copy(key)
                    ptr = ctypes.c_uint64()
                    _check(cu, cu.cuIpcOpenMemHandle_v2(ctypes.byref(ptr), h,
                                                        _LAZY_PEER),
                           "cuIpcOpenMemHandle")
                    ent = self._open[key] = [ptr.value, 0]
                ent[1] += 1
                held.append(key)
                dtype = WIRE_DTYPES[a["dtype"]]
                shape = [int(x) for x in a["shape"]]
                n = 1
                for x in shape:
                    n *= x
                nbytes = n * torch.empty((), dtype=dtype).element_size()
                raw = torch.as_tensor(_Mapped(ent[0] + int(a["offset"]),
                                              nbytes), device=self.device)
                out.append(raw.view(dtype).view(shape))
            ev = torch.cuda.Event.from_ipc_handle(self.device,
                                                  bytes(desc["event"]))
            torch.cuda.current_stream(self.device).wait_event(ev)
        except BaseException:
            self.release(held)
            raise
        return out, held

    def release(self, held: list) -> None:
        """Let go of a pull's handles; a handle no pull uses is unmapped.
        Call once the reads of its tensors completed."""
        cu = None
        for key in held:
            ent = self._open.get(key)
            if ent is None:
                continue
            ent[1] -= 1
            if ent[1] <= 0:
                del self._open[key]
                cu = cu or _bind(self.device)
                _check(cu, cu.cuIpcCloseMemHandle(ent[0]),
                       "cuIpcCloseMemHandle")

    @property
    def mapped(self) -> int:
        """Handles mapped now."""
        return len(self._open)

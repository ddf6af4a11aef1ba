"""The seeded Gumbel draw: one categorical sample per row, bit for bit the
draw of ``jax.random.categorical`` under the JAX package's keys.

The JAX package samples a row with ``jax.random.categorical(key, scaled)``
(``dynamo_tpu/engine/sampling.py``, ``_cat``) where ``key`` wraps the raw
pair (seed, step) as threefry2x32 key data, under
``jax_threefry_partitionable`` (jax's default). Reproduced here exactly:

  bits[v]  = b0 ^ b1 of threefry2x32(key=(seed, step), counter=(0, v))
             (the counter is the 64-bit flat index v, high word first)
  f[v]     = float32 of (bits >> 9 | 0x3F800000) minus 1     in [0, 1)
  u[v]     = max(tiny, f * (1 - tiny) + tiny)                 (= f, or tiny
             where f is 0; 1 - tiny rounds to 1 in float32)
  g[v]     = -log(-log(u))                                    Gumbel, "low"
  token    = the lowest index of the maximum of x + g, where
             x[v] = lg[v] / temp, and -inf where x < cut

``cut`` is the row's top-k/top-p threshold in the scaled domain (-inf: no
mask). The bits and the uniforms are exact integer and float work, equal
to jax's; the two logs may differ from XLA's by an ulp or so, which moves a
token only when two candidates lie within that of each other.

:func:`gumbel_argmax` launches the hand-written Hopper kernel
(``csrc/sample.cu``, one launch a call) for CUDA tensors. It has no TPU counterpart: the JAX
package leaves the draw to XLA. Greedy rows never need it. CPU tensors take
:func:`gumbel_argmax_ref`, which emulates uint32 arithmetic in int64
(torch's uint32 lacks most operators); nothing on the card calls it.
"""

from __future__ import annotations

import ctypes

import torch

from dynamo_tpu_torch.ops import _build

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
#: float32's smallest normal, jax's ``finfo(float32).tiny``
TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32_ref(k0, k1, x0, x1):
    """threefry2x32, 20 rounds, on int64 tensors holding uint32 values
    (keys broadcast against counters). Returns the two output words."""
    k0, k1, x0, x1 = (t.to(torch.int64) & _M32 for t in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits_ref(seed, step, V: int):
    """[B, V] int64 holding uint32: ``jax.random.bits(key, (V,))`` of each
    row's key (seed[b], step[b]), as the partitionable threefry makes them."""
    dev = seed.device
    v = torch.arange(V, dtype=torch.int64, device=dev)[None, :]
    b0, b1 = threefry2x32_ref(seed.to(torch.int64)[:, None],
                              step.to(torch.int64)[:, None],
                              torch.zeros_like(v), v)
    return b0 ^ b1


def uniform_ref(bits):
    """float32 in [0, 1) from uint32 bits: ``jax.random.uniform``'s
    mantissa trick."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def gumbel_ref(bits):
    """The "low" Gumbel noise of ``jax.random.gumbel`` from the same bits:
    -log(-log(u)) with u the uniform on [tiny, 1)."""
    u = torch.clamp_min(uniform_ref(bits) + TINY, TINY)
    return -torch.log(-torch.log(u))


def _check(lg, temp, cut, seed, step):
    if lg.dim() != 2 or lg.dtype != torch.float32:
        raise ValueError("logits must be [B, V] float32")
    B = lg.shape[0]
    for name, t, dt in (("temp", temp, torch.float32),
                        ("cut", cut, torch.float32),
                        ("seed", seed, torch.int32),
                        ("step", step, torch.int32)):
        if t.dtype != dt or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be {dt} [B={B}]")


def gumbel_argmax_ref(lg, temp, cut, seed, step):
    """Plain PyTorch version of the draw (see the module docstring).
    ``seed`` and ``step`` are int32 tensors holding the key words' bits."""
    _check(lg, temp, cut, seed, step)
    x = lg / temp[:, None]
    x = torch.where(x >= cut[:, None], x, float("-inf"))
    g = gumbel_ref(random_bits_ref(seed, step, lg.shape[1]))
    return (x + g).argmax(dim=-1)


def gumbel_argmax(lg, temp, cut, seed, step):
    """[B] int64 tokens of the seeded draw over ``lg`` [B, V] float32 with
    the per-row ``temp``, ``cut`` (float32 [B]) and key words ``seed``,
    ``step`` (int32 [B], the uint32 bits). CUDA tensors launch the kernel
    on the current stream; CPU tensors take :func:`gumbel_argmax_ref`."""
    if lg.device.type == "cpu":
        return gumbel_argmax_ref(lg, temp, cut, seed, step)
    if lg.device.type != "cuda":
        raise ValueError(f"no gumbel_argmax kernel for {lg.device}")
    _check(lg, temp, cut, seed, step)
    if not all(t.is_contiguous() for t in (lg, temp, cut, seed, step)):
        raise ValueError("gumbel_argmax operands must be contiguous")
    B, V = lg.shape
    out = torch.empty((B,), dtype=torch.int64, device=lg.device)
    if B == 0:
        return out
    launch, chunks = _kernel()
    part = torch.empty((2 * B * chunks(V),), dtype=torch.int32,
                       device=lg.device)
    err = launch(lg.data_ptr(), temp.data_ptr(), cut.data_ptr(),
                 seed.data_ptr(), step.data_ptr(), part.data_ptr(),
                 _arrival_counters(lg.device, B).data_ptr(), out.data_ptr(),
                 B, V, torch.cuda.current_stream(lg.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gumbel_argmax kernel launch failed (code {err})")
    gumbel_argmax.launches += 1
    return out


#: kernel launches since the count was last set to 0
gumbel_argmax.launches = 0

#: device -> the kernel's per-row arrival counters, zero between launches
#: (each launch's last CTA of a row sets its counter back). Never freed or
#: moved: a captured graph keeps their address. A batch wider than every
#: buffer so far gets a new one; the old ones stay for the graphs that
#: read them.
_ARRIVED: dict = {}


def _arrival_counters(device, B: int):
    bufs = _ARRIVED.setdefault(device, [])
    if not bufs or bufs[-1].numel() < B:
        bufs.append(torch.zeros((max(B, 256),), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def _kernel():
    lib = _build.load("sample")
    fn = lib.gumbel_argmax_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    nchunks = lib.gumbel_argmax_chunks
    nchunks.argtypes = [ctypes.c_int]
    nchunks.restype = ctypes.c_int
    return fn, nchunks

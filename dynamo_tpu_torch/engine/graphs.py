"""One CUDA graph per step signature: the port's counterpart of what the JAX
engine gets from XLA, one compiled program per static shape and an AOT
warmup of every shape.

A signature is what decides a step's launch sequence: its kind and static
shape (``("ragged", T)`` for a step with prefill chunks, ``("ragged_dec",
T)`` for a decode-only one, a burst's rows and depth), and for the sampler
the rows and the branches the host arrays select. The first use of a
signature runs eagerly, as a JAX program's first call compiles, and is then
captured; every later use replays the capture. A capture counts as a
compile (``AsyncTorchEngine.compile_events``).

What a graph may rely on:

- **Fixed addresses.** A graph reads and writes the tensors its capture
  saw. The engine's step operands are views of one device buffer that never
  moves (``engine._Staging``), the weights and caches stay where they are,
  the logits of every step with R rows land in one buffer, and the
  structured-decoding arenas are allocated once at capacity and updated in
  place. Feeds (the previous step's tokens and FSM states) are copied into
  the operand buffer before the replay.
- **Static outputs.** A replay overwrites the outputs of the previous
  replay of the same graph. Every read of them (the host copy of the
  tokens, the feed into the next step) is queued on the stream before the
  next replay, so stream order keeps them; anything read later is cloned.
- **Nothing built during capture.** The eager first use builds every
  kernel library, the RoPE tables, cuBLAS's handle and workspace, and
  whatever else a first call creates, before the capture starts.
- **One pool.** Every capture of a cache shares one memory pool: graphs
  replay one at a time on one stream, so their temporaries may overlap,
  and outputs a graph keeps stay allocated.
- **No collection during a capture.** The garbage collector runs before
  each capture and is off during it: a dead engine reached by a
  collection mid-capture frees its graphs' pool (a ``cudaFree``) and
  invalidates the capture (ROADMAP C9).

Kernel launch counts: a wrapper adds one to its ``launches`` when it
launches, which under capture happens once. Each graph records the counts
its capture added (and takes them back: nothing ran), and each replay adds
them again, so ``launches`` counts kernels the card executed.

On the CPU there is no cache: torch has no graphs there, and the engine
runs every step eagerly.
"""

from __future__ import annotations

import gc
import time
from typing import Callable

import torch

from dynamo_tpu_torch.ops.flash_prefill import (
    flash_mla_prefill_paged, flash_prefill,
)
from dynamo_tpu_torch.ops.mla_decode import mla_paged_decode
from dynamo_tpu_torch.ops.paged_attention import paged_attention_decode
from dynamo_tpu_torch.ops.qmm import quant_matmul
from dynamo_tpu_torch.ops.ragged_attention import ragged_paged_attention
from dynamo_tpu_torch.ops.sample import gumbel_argmax

#: every kernel wrapper that counts its launches
COUNTED = (ragged_paged_attention, flash_prefill, paged_attention_decode,
           mla_paged_decode, flash_mla_prefill_paged, gumbel_argmax,
           quant_matmul)


class _Graph:
    __slots__ = ("graph", "out", "deltas", "fn")

    def __init__(self, graph, out, deltas, fn):
        self.graph, self.out, self.deltas = graph, out, deltas
        #: the captured callable: it holds the tensors the graph reads
        self.fn = fn


class GraphCache:
    """Captured graphs of one engine on one device, keyed by signature."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self._graphs: dict = {}
        #: bytes the captures added to the device's reserved memory (the
        #: shared pool), and their seconds, eager first use included
        self.pool_bytes = 0
        self.seconds = 0.0

    def clear(self) -> None:
        """Forget every graph (and what its callable holds); later
        captures go to a new pool, and the old one is freed with its
        graphs."""
        self._graphs.clear()
        self.pool = torch.cuda.graph_pool_handle()
        self.pool_bytes = 0

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, key) -> bool:
        return key in self._graphs

    def run(self, key, fn: Callable):
        """(outputs, seconds). A captured ``key`` replays on the current
        stream and returns its static outputs with seconds None. A new one
        runs ``fn`` eagerly, captures it, and returns the eager outputs and
        the seconds both took. A capture that fails raises."""
        g = self._graphs.get(key)
        if g is not None:
            g.graph.replay()
            for wrapper, n in g.deltas:
                wrapper.launches += n
            return g.out, None
        t0 = time.perf_counter()
        out = fn()
        self._graphs[key] = self._capture(fn)
        seconds = time.perf_counter() - t0
        self.seconds += seconds
        return out, seconds

    def _capture(self, fn: Callable) -> _Graph:
        before = [w.launches for w in COUNTED]
        torch.cuda.synchronize(self.device)
        # Dead objects in reference cycles (an engine, with its graphs,
        # their pool, its pinned buffers and events) free CUDA resources
        # when the garbage collector reaches them; a collection inside a
        # capture would cudaFree a pool mid-capture and invalidate it.
        # Collect them now, and hold the collector off until the capture
        # has ended.
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: the serial loop captures in a worker thread
            # while the event loop's thread may query events or embed
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = fn()
        finally:
            if collecting:
                gc.enable()
            deltas = [(w, w.launches - n) for w, n in zip(COUNTED, before)
                      if w.launches != n]
            for w, n in zip(COUNTED, before):
                w.launches = n
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        return _Graph(graph, out, deltas, fn)

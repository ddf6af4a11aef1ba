"""The torch port's paged decode (B4) against the JAX package's.

- ``paged_attention_decode_ref`` against the Pallas ``paged_attention_decode``
  in interpret mode and against ``paged_attention_decode_xla``, over window
  x sinks x int8 pages, the int8 scales in both of the Pallas kernel's
  placements (resident, or fetched per page: a zero scale budget) and
  rebased by ``scale_slot_base``; f32 within 2e-5 (the reference tests'
  tolerance, tests/test_ops.py). The XLA version gives a row that sees no
  key the mean of its values where both kernels give zeros, so it is held
  to the rows with keys.
- The CUDA path's decomposition: ``ragged_attention_ref`` with
  rows3 = (b, 1, kv_len) equals ``paged_attention_decode_ref``, window and
  sinks included (the ragged window ``key > pos - window`` at
  pos = kv_len - 1 is ``key >= kv_len - window``).
- ``make_forward_fn`` with S == 1 on a tiny Llama against JAX
  ``forward(use_pallas=True)`` (the Pallas decode kernel, interpret mode):
  logits within atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.cache import allocate_device_cache as jax_cache
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.ops.paged_attention import (
    paged_attention_decode as jax_decode,
    paged_attention_decode_xla as jax_decode_xla,
)
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.cache import quantize_kv
from dynamo_tpu_torch.engine.config import ModelConfig
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.ops.paged_attention import (
    paged_attention_decode, paged_attention_decode_ref,
)
from dynamo_tpu_torch.ops.ragged_attention import ragged_attention_ref

B, H, KV, HD, BS, NB, W = 4, 8, 2, 64, 8, 40, 6
#: (window, sinks, int8 scale placement): None = bf16/f32 pages, "vmem" =
#: the kernel's resident scales, "dma" = per-page scale copies, "rebased"
#: = per-page copies of a one-layer scale table behind a junk layer
CASES = [(0, False, None), (7, False, None), (0, True, None),
         (7, True, "vmem"), (0, False, "dma"), (7, True, "rebased")]


def _case(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, HD), np.float32)
    kc = rng.standard_normal((NB * BS, KV, HD), np.float32)
    vc = rng.standard_normal((NB * BS, KV, HD), np.float32)
    kv_lens = np.asarray([29, 0, 48, 8], np.int32)  # kv 0, full, one page
    bt = np.zeros((B, W), np.int32)
    for b, n in enumerate(kv_lens):
        used = -(-int(n) // BS)
        bt[b, :used] = rng.choice(np.arange(1, NB), used, replace=False)
    sinks = rng.standard_normal((H,), np.float32)
    return q, kc, vc, bt, kv_lens, sinks


@pytest.mark.parametrize("window,sinks,quant", CASES)
def test_paged_decode_ref_matches_jax(window, sinks, quant, monkeypatch):
    q, kc, vc, bt, kv_lens, sk = _case(window + 3 * sinks)
    kw = dict(block_size=BS, window=window or None,
              sinks=sk if sinks else None)
    if quant:
        kq, ks = (t.numpy() for t in quantize_kv(torch.from_numpy(kc)))
        vq, vs = (t.numpy() for t in quantize_kv(torch.from_numpy(vc)))
        kc, vc = kq, vq
        kw.update(k_scales=ks, v_scales=vs)
        if quant == "rebased":
            slots = kc.shape[0]
            kc = np.concatenate([np.full_like(kc, 7), kc])
            vc = np.concatenate([np.full_like(vc, 7), vc])
            bt = bt + slots // BS
            kw["scale_slot_base"] = slots
        if quant != "vmem":  # no scale budget: per-page scale copies
            monkeypatch.setenv("DYN_KV_SCALE_VMEM_BYTES", "0")
    ops = (q, kc, vc, bt, kv_lens)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    want = np.asarray(jax_decode(*(jnp.asarray(a) for a in ops),
                                 interpret=True, **jkw))
    want_xla = np.asarray(jax_decode_xla(*(jnp.asarray(a) for a in ops),
                                         **jkw))
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = paged_attention_decode(*(torch.from_numpy(a) for a in ops),
                                 **tkw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    seen = kv_lens > 0
    np.testing.assert_allclose(got[seen], want_xla[seen], atol=2e-5,
                               rtol=2e-5)
    if not sinks:
        assert not got[~seen].any()  # a row with no key: zeros


@pytest.mark.parametrize("window,sinks", [(0, False), (7, True)])
def test_ragged_decomposition_matches(window, sinks):
    q, kc, vc, bt, kv_lens, sk = _case(11)
    t = {n: torch.from_numpy(a) for n, a in
         dict(q=q, kc=kc, vc=vc, bt=bt, kv=kv_lens, sk=sk).items()}
    sinks_t = t["sk"] if sinks else None
    rows3 = torch.stack([torch.arange(B, dtype=torch.int32),
                         torch.ones(B, dtype=torch.int32), t["kv"]], dim=1)
    want = paged_attention_decode_ref(t["q"], t["kc"], t["vc"], t["bt"],
                                      t["kv"], block_size=BS, window=window,
                                      sinks=sinks_t)
    got = ragged_attention_ref(t["q"], t["kc"], t["vc"], t["bt"], rows3,
                               block_size=BS, window=window, sinks=sinks_t)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_llama_forward_s1_matches_jax():
    """A 2-row prefill through the JAX forward, then one S == 1 step
    through both packages on lane-aligned heads (KV x hd = 128)."""
    fields = dict(vocab_size=128, hidden_size=128, intermediate_size=96,
                  num_layers=2, num_heads=4, num_kv_heads=2, head_dim=64,
                  dtype="float32", max_position_embeddings=256)
    cfg, jcfg = ModelConfig(**fields), JaxModelConfig(**fields)
    jp = M.init_params(jcfg, jax.random.key(4))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    bs = 4
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    lens = [9, 5]
    toks = np.asarray([[5, 9, 17, 23, 42, 77, 101, 3, 54],
                       [7, 11, 13, 15, 17, 0, 0, 0, 0]], np.int32)
    pos = np.tile(np.arange(9, dtype=np.int32), (2, 1))
    slot = np.where(pos < np.asarray(lens)[:, None],
                    np.take_along_axis(bt, pos // bs, 1) * bs + pos % bs, 0)
    kc, vc = jax_cache(jcfg, 10, bs, dtype=jnp.float32)
    _, kc, vc = M.forward(jp, jnp.asarray(toks), jnp.asarray(pos),
                          jnp.asarray(slot.astype(np.int32)),
                          jnp.asarray(bt), jnp.asarray(lens, jnp.int32),
                          jnp.asarray([8, 4], jnp.int32), kc, vc,
                          cfg=jcfg, block_size=bs)
    tk, tv = torch.from_numpy(np.array(kc)), torch.from_numpy(np.array(vc))
    step = [np.asarray([[61], [62]], np.int32),
            np.asarray([[9], [5]], np.int32),
            np.asarray([[3 * bs + 1], [6 * bs + 1]], np.int32), bt,
            np.asarray([10, 6], np.int32), np.zeros((2,), np.int32)]
    jl, jk, jv = M.forward(jp, *(jnp.asarray(a) for a in step), kc, vc,
                           cfg=jcfg, block_size=bs, use_pallas=True)
    tl, _, _ = TM.make_forward_fn(cfg, bs)(
        tp, *(torch.from_numpy(a) for a in step), tk, tv)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(tk.numpy()[:, bs:], np.asarray(jk)[:, bs:],
                               atol=1e-5)
    np.testing.assert_allclose(tv.numpy()[:, bs:], np.asarray(jv)[:, bs:],
                               atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    q, kc, vc, bt, kv_lens, _ = _case(2)
    ops = [torch.from_numpy(a) for a in (q, kc, vc, bt, kv_lens)]
    before = paged_attention_decode.launches
    got = paged_attention_decode(*ops, block_size=BS)
    assert paged_attention_decode.launches == before
    torch.testing.assert_close(
        got, paged_attention_decode_ref(*ops, block_size=BS))
    with pytest.raises(ValueError, match="no paged decode kernel"):
        paged_attention_decode(*(o.to("meta") for o in ops), block_size=BS)

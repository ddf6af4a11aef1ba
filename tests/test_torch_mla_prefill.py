"""The torch port's MLA flash prefill and the paths it carries, against the
JAX package on the CPU (f32, numpy-seeded inputs):

- ``flash_mla_prefill_ref`` (and the wrapper, which takes it for CPU
  tensors) against JAX ``flash_mla_prefill(interpret=True)``: a first chunk
  and a second chunk with pos_base > 0 and S < T, on the rows that see
  keys (the Pallas kernel returns a tile's mean value for a row that sees
  none, ROADMAP C1; the port returns zeros), atol 1e-5.
- The paged entry's plain version (``flash_mla_prefill_paged`` on CPU
  tensors: the whole table gathered, one softmax) against the port's
  segment walk ``mla_attention_seg`` over several segments, with f32
  pages and with int8 pages, atol 1e-5.
- ``make_forward_fn`` with S > 1 on ``mla_tiny`` (two chunks, the second
  at pos 8) against JAX ``forward``: logits and written caches, atol 1e-4.
- ``make_embed_fn`` on ``mla_tiny`` against JAX ``make_embed_fn``, atol
  1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.cache import allocate_device_cache as jax_cache
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu.ops.flash_prefill import flash_mla_prefill as jax_flash_mla
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.cache import (
    allocate_device_cache, quantize_kv,
)
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.ops import flash_prefill as P


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("chunk", ["first", "second"])
def test_mla_prefill_ref_matches_jax(chunk):
    """mirrors tests/test_mla.py::test_mla_flash_prefill_matches_xla at the
    kernel: a fresh chunk (S == T), then a second chunk at pos_base 8
    attending back over the first (S < T); one row with kv_len 0."""
    rng = np.random.default_rng(7)
    B, H, r, pr, T = 3, 4, 32, 16, 16
    S = 16 if chunk == "first" else 4
    pb = np.asarray([0, 0, 0] if chunk == "first" else [8, 8, 0], np.int32)
    kl = np.asarray([16, 0, 11] if chunk == "first" else [12, 0, 4],
                    np.int32)
    a = [_rand(rng, B, S, H, r), _rand(rng, B, S, H, pr),
         _rand(rng, B, T, r), _rand(rng, B, T, pr)]
    want = np.asarray(jax_flash_mla(*(jnp.asarray(x) for x in a),
                                    jnp.asarray(pb), jnp.asarray(kl),
                                    scale=0.17, interpret=True))
    targs = [torch.from_numpy(x) for x in a + [pb, kl]]
    got = P.flash_mla_prefill_ref(*targs, scale=0.17)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, r)
    assert torch.equal(P.flash_mla_prefill(*targs, scale=0.17), got)
    for b in (0, 2):  # rows that see keys
        np.testing.assert_allclose(got[b].numpy(), want[b], atol=1e-5,
                                   rtol=1e-5)
    assert not got[1].any()  # kv_len 0: zeros


@pytest.mark.parametrize("int8", [False, True])
def test_paged_entry_plain_matches_segment_walk(int8):
    """The paged entry on CPU tensors (its plain version) against the
    online-softmax segment walk the CPU engine runs, with 8-key segments:
    chunk-grid tiles at pos_base 0, deep into a row (pos_base 21) and on a
    row of kv_len 0, over shuffled blocks; int8 pages with each stream's
    scales."""
    rng = np.random.default_rng(3)
    C, S, H, r, pr, bs, nb, W = 3, 6, 4, 32, 16, 4, 32, 8
    q_eff = torch.from_numpy(_rand(rng, C, S, H, r))
    q_rot = torch.from_numpy(_rand(rng, C, S, H, pr))
    lat = torch.from_numpy(_rand(rng, nb * bs, r))
    rope = torch.from_numpy(_rand(rng, nb * bs, pr))
    kw = {}
    if int8:
        cq, cs = quantize_kv(lat[:, None])
        rq, rs = quantize_kv(rope[:, None])
        lat, rope = cq[:, 0], rq[:, 0]
        kw = dict(c_scales=cs, r_scales=rs)
    bt = torch.from_numpy(rng.permutation(np.arange(1, nb))[:C * W]
                          .reshape(C, W).astype(np.int32))
    pos_base = torch.tensor([0, 21, 0], dtype=torch.int32)
    kv_lens = torch.tensor([6, 27, 0], dtype=torch.int32)
    positions = pos_base[:, None] + torch.arange(S, dtype=torch.int32)
    got = P.flash_mla_prefill_paged(q_eff, q_rot, lat, rope, bt, pos_base,
                                    kv_lens, block_size=bs, scale=0.2, **kw)
    want = TM.mla_attention_seg(q_eff, q_rot, lat, rope, bt, positions,
                                kv_lens, block_size=bs, scale=0.2,
                                seg_keys=8, **kw)
    # rows that see keys: the walk, like the JAX package's, gives a row
    # that sees none the mean of its segments' values; the paged entry
    # gives zeros
    np.testing.assert_allclose(got[:2].numpy(), want[:2].numpy(), atol=1e-5,
                               rtol=1e-5)
    assert not got[2].any()


def _mla_tiny(seed=3):
    """mla_tiny's configs and one set of weights in both packages: drawn by
    the port's ``init_params`` (the JAX layout, in milliseconds where the
    JAX draw takes seconds) and handed to JAX as the same numbers."""
    cfg = get_model_config("mla_tiny")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    return cfg, jax_preset("mla_tiny"), jp, tp


def test_mla_forward_s_gt_1_matches_jax():
    """Two rows prefilled in one S = 8 call, then a second chunk of 4
    tokens each at positions 8..11 (pos_base > 0): logits and the written
    latent and rope caches against JAX ``forward``."""
    cfg, jcfg, jp, tp = _mla_tiny()
    bs, W = 4, 3
    bt = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
    toks1 = np.asarray([[5, 9, 17, 23, 42, 77, 101, 3],
                        [6, 10, 18, 24, 43, 78, 102, 4]], np.int32)
    toks2 = np.asarray([[11, 12, 13, 14], [15, 16, 17, 18]], np.int32)
    steps = []
    for toks, p0 in ((toks1, 0), (toks2, 8)):
        S = toks.shape[1]
        pos = np.broadcast_to(np.arange(p0, p0 + S, dtype=np.int32),
                              (2, S)).copy()
        slot = (np.take_along_axis(bt, pos // bs, 1) * bs
                + pos % bs).astype(np.int32)
        steps.append([toks, pos, slot, bt,
                      np.full((2,), p0 + S, np.int32),
                      np.full((2,), S - 1, np.int32)])
    jk, jv = jax_cache(jcfg, 8, bs, dtype=jnp.float32)
    tk, tv = allocate_device_cache(cfg, 8, bs, "cpu", torch.float32)
    fwd = TM.make_forward_fn(cfg, bs)
    jfwd = jax.jit(functools.partial(M.forward, cfg=jcfg, block_size=bs))
    for step in steps:
        jl, jk, jv = jfwd(jp, *(jnp.asarray(a) for a in step), jk, jv)
        tl, _, _ = fwd(tp, *(torch.from_numpy(a) for a in step), tk, tv)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(tk.numpy()[:, bs:], np.asarray(jk)[:, bs:],
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(tv.numpy()[:, bs:], np.asarray(jv)[:, bs:],
                                   atol=1e-4, rtol=1e-4)


def test_mla_embed_matches_jax():
    """Mean-pooled MLA embeddings of a full and a padded row (and a padding
    row of length 0) against JAX ``make_embed_fn``."""
    cfg, jcfg, jp, tp = _mla_tiny(5)
    bs, B, S = 4, 3, 8
    rng = np.random.default_rng(9)
    tokens = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    lengths = np.asarray([8, 5, 0], np.int32)
    nb = B * S // bs + 1
    jk, jv = jax_cache(jcfg, nb, bs, dtype=jnp.float32)
    want = np.asarray(M.make_embed_fn(jcfg, bs)(
        jp, jnp.asarray(tokens), jnp.asarray(lengths), jk, jv))
    tk, tv = allocate_device_cache(cfg, nb, bs, "cpu", torch.float32)
    got = TM.make_embed_fn(cfg, bs)(tp, torch.from_numpy(tokens),
                                    torch.from_numpy(lengths), tk, tv)
    assert got.shape == (B, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    assert not got[2].any()


@pytest.mark.parametrize("entry", ["prefill", "decode"])
def test_narrow_q_rot_reads_its_rope_columns(entry):
    """A q_rot narrower than the rope pages (the engine passes
    qk_rope_head_dim rounded up to 64: 64 of DeepSeek-V2-Lite's 128 cache
    columns, and of mla_tiny's): the MLA wrappers on CPU tensors read only
    its width of the rope keys, whose columns past it are nonzero here.
    The prefill wrapper equals JAX ``flash_mla_prefill(interpret=True)``
    and the decode wrapper JAX ``mla_paged_decode(interpret=True)``, each
    on q_rot zero-padded to the pages' width (atol 1e-5)."""
    from dynamo_tpu.ops.paged_attention import (
        mla_paged_decode as jax_mla_decode,
    )
    from dynamo_tpu_torch.ops.mla_decode import mla_paged_decode

    rng = np.random.default_rng(11)
    B, H, r, pr, live = 2, 4, 32, 128, 64
    q_eff = _rand(rng, B, 5, H, r)
    q_rot = _rand(rng, B, 5, H, live)
    padded = np.pad(q_rot, ((0, 0),) * 3 + ((0, pr - live),))
    if entry == "prefill":
        c, kr = _rand(rng, B, 12, r), _rand(rng, B, 12, pr)
        pb, kl = np.asarray([0, 7], np.int32), np.asarray([5, 12], np.int32)
        want = np.asarray(jax_flash_mla(
            *(jnp.asarray(x) for x in (q_eff, padded, c, kr, pb, kl)),
            scale=0.2, interpret=True))
        got = P.flash_mla_prefill(
            *(torch.from_numpy(x) for x in (q_eff, q_rot, c, kr, pb, kl)),
            scale=0.2)
    else:
        lat, rope = _rand(rng, 64, r), _rand(rng, 64, pr)
        bt = np.asarray([[1, 2], [3, 0]], np.int32)
        kl = np.asarray([20, 9], np.int32)
        want = np.asarray(jax_mla_decode(
            *(jnp.asarray(x) for x in (q_eff[:, 0], padded[:, 0], lat, rope,
                                       bt, kl)),
            block_size=16, scale=0.2, interpret=True))
        got = mla_paged_decode(
            *(torch.from_numpy(np.ascontiguousarray(x)) for x in (
                q_eff[:, 0], q_rot[:, 0], lat, rope, bt, kl)),
            block_size=16, scale=0.2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert TM.mla_rope_live(get_model_config("deepseek_v2_lite")) == 64
    assert TM.mla_rope_live(get_model_config("mla_tiny")) == 64

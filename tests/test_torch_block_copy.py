"""The port's block gather and scatter (``dynamo_tpu_torch/ops/block_copy.py``)
against the JAX package's ``dynamo_tpu/ops/block_copy.py``.

Caches and bundles are drawn from numpy seeds and handed to both. A torch
gather must give the bytes of the JAX gather (sliced to the real block
count: JAX pads the id list to a power of two) for f32, bf16 and int8
(packed uint8) GQA caches and the MLA latent and rope pools; every scatter
branch must leave the cache the JAX scatter returns, while writing into
the tensors it was given (their ``data_ptr`` never moves: the engine's
CUDA graphs hold it).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import cache as JC
from dynamo_tpu.ops import block_copy as JB
from dynamo_tpu_torch.disagg.protocols import tensor_bytes
from dynamo_tpu_torch.engine import cache as TC
from dynamo_tpu_torch.ops import block_copy as TB

BS = 4
#: (layers, blocks, heads, dim) of the GQA case and of the MLA pools
GQA = (3, 10, 2, 16)
MLA_K = (3, 10, 1, 32)  # the latent [L, slots, 1, R]
MLA_V = (3, 10, 1, 8)   # the rope part [L, slots, 1, rope]


def _values(shape, seed):
    L, nb, H, d = shape
    return np.random.default_rng(seed).standard_normal(
        (L, nb * BS, H, d)).astype(np.float32)


def _plain(shape, seed, dtype):
    """The same cache for both packages: (torch tensor, jax array)."""
    x = _values(shape, seed)
    if dtype == "bfloat16":
        return (torch.from_numpy(x).to(torch.bfloat16),
                jnp.asarray(x.astype(ml_dtypes.bfloat16)))
    return torch.from_numpy(x.copy()), jnp.asarray(x)


def _int8(shape, seed):
    q, s = JC.quantize_kv(_values(shape, seed))
    q, s = np.asarray(q), np.asarray(s)
    return ({"q": torch.from_numpy(q.copy()), "s": torch.from_numpy(s.copy())},
            {"q": jnp.asarray(q), "s": jnp.asarray(s)})


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return tensor_bytes(x)
    return np.ascontiguousarray(np.asarray(x)).tobytes()


def _same_cache(t, j):
    if isinstance(t, dict):
        for leaf in ("q", "s"):
            assert _bytes(t[leaf]) == _bytes(j[leaf]), leaf
    else:
        assert _bytes(t) == _bytes(j)


IDS = [7, 2, 9]  # three blocks, padded to four on the JAX side


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8",
                                  "mla_latent", "mla_rope", "mla_int8"])
def test_gather_bytes_equal_jax(kind):
    shape = {"mla_latent": MLA_K, "mla_rope": MLA_V,
             "mla_int8": MLA_V}.get(kind, GQA)
    if kind in ("int8", "mla_int8"):
        tc, jc = _int8(shape, 1)
    else:
        tc, jc = _plain(shape, 1, "bfloat16" if kind != "float32"
                        and kind != "mla_rope" else "float32")
    got = TB.gather_blocks(tc, IDS, block_size=BS)
    want = np.asarray(JB.gather_blocks(jc, IDS, block_size=BS))[:, :len(IDS)]
    assert tuple(got.shape) == want.shape
    assert _bytes(got) == _bytes(want)
    if kind in ("int8", "mla_int8"):
        _L, _nb, H, d = shape
        assert got.dtype == torch.uint8
        assert got.shape[2] == TC.packed_block_width(BS, H, d)


def _bundle(shape, seed, layers=None, n=len(IDS)):
    L, _nb, H, d = shape
    x = np.random.default_rng(seed).standard_normal(
        (layers or L, n, BS, H, d)).astype(np.float32)
    return x


# every branch of the JAX scatter_blocks: (cache, bundle, start_layer)
BRANCHES = [
    ("plain", "values", None),
    ("plain_bf16", "values", None),
    ("int8", "packed", None),
    ("plain", "values", 1),          # _scatter_layers
    ("int8", "packed", 1),           # _scatter_packed_layers
    ("int8", "values", 1),           # _scatter_quant_layers
    ("int8", "values", None),        # _scatter_quant
    ("plain", "packed", None),       # packed into plain: dequantizes
    ("plain", "packed", 2),
    ("mla_plain", "values", None),
    ("mla_int8", "packed", None),
]


@pytest.mark.parametrize("cache,bundle,start_layer", BRANCHES)
def test_scatter_equals_jax_in_place(cache, bundle, start_layer):
    shape = MLA_K if cache.startswith("mla") else GQA
    if cache.endswith("int8"):
        tc, jc = _int8(shape, 2)
    else:
        tc, jc = _plain(shape, 2, "bfloat16" if cache == "plain_bf16"
                        else "float32")
    nL = 1 if start_layer is not None else None
    x = _bundle(shape, 3, layers=nL)
    if bundle == "packed":
        q, s = JC.quantize_kv(x)
        jb = np.asarray(JC.pack_kv_blocks(jnp.asarray(q), jnp.asarray(s)))
        tb = torch.from_numpy(jb.copy())
    else:
        jb, tb = x, torch.from_numpy(x.copy())
    ptrs = ([tc["q"].data_ptr(), tc["s"].data_ptr()] if isinstance(tc, dict)
            else [tc.data_ptr()])
    out = TB.scatter_blocks(tc, IDS, tb, block_size=BS,
                            start_layer=start_layer)
    want = JB.scatter_blocks(jc, IDS, jb, block_size=BS,
                             start_layer=start_layer)
    assert out is tc
    assert ptrs == ([tc["q"].data_ptr(), tc["s"].data_ptr()]
                    if isinstance(tc, dict) else [tc.data_ptr()])
    _same_cache(tc, want)


def test_gather_scatter_roundtrip_bit_exact_int8():
    """The JAX package's int8 round trip (tests/test_int8_kv.py): gather,
    scatter into other blocks, gather back: the same packed bytes, the
    same quantized pages."""
    tc, _ = _int8(GQA, 4)
    L, slots, KV, hd = TC.cache_shape(tc)
    src, dst = [2, 5, 3], [6, 1, 7]
    bundle = TB.gather_blocks(tc, src, block_size=BS)
    assert bundle.shape == (L, 3, TC.packed_block_width(BS, KV, hd))
    q_src = tc["q"].view(L, slots // BS, BS, KV, hd)[:, src].clone()
    TB.scatter_blocks(tc, dst, bundle, block_size=BS)
    back = TB.gather_blocks(tc, dst, block_size=BS)
    assert torch.equal(back, bundle)
    assert torch.equal(tc["q"].view(L, slots // BS, BS, KV, hd)[:, dst],
                       q_src)


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_blocks_digest_follows_the_bytes_and_their_order(kind):
    """The digest of blocks copied elsewhere is the source's, read in any
    group size; two blocks swapped, another block in their place, the k
    and v caches swapped, or one flipped bit change it."""
    k = _int8(GQA, 1)[0] if kind == "int8" else _plain(GQA, 1, kind)[0]
    v = _int8(GQA, 2)[0] if kind == "int8" else _plain(GQA, 2, kind)[0]
    src, dst = [2, 5, 3], [6, 1, 7]

    def digest(ids, group=64):
        return int(TB.blocks_digest((k, v), ids, block_size=BS, group=group))

    want = digest(src)
    assert digest(src, group=2) == digest(src, group=1) == want
    for c in (k, v):
        TB.scatter_blocks(c, dst, TB.gather_blocks(c, src, block_size=BS),
                          block_size=BS)
    assert digest(dst) == want
    assert digest([5, 2, 3]) != want
    assert digest([2, 5, 4]) != want
    assert int(TB.blocks_digest((v, k), src, block_size=BS)) != want
    page = k["q"] if kind == "int8" else k
    flat = page.view(torch.uint8).view(-1)
    slot = flat.numel() // (page.shape[0] * page.shape[1])
    flat[2 * BS * slot] ^= 1  # layer 0, block 2's first byte
    assert digest(src) != want


def test_pack_unpack_equal_jax():
    x = np.random.default_rng(9).standard_normal((2, 3, 4, 2, 16)).astype(
        np.float32)
    q, s = (np.asarray(a) for a in JC.quantize_kv(x))
    want = np.asarray(JC.pack_kv_blocks(jnp.asarray(q), jnp.asarray(s)))
    got = TC.pack_kv_blocks(torch.from_numpy(q), torch.from_numpy(s))
    assert got.dtype == torch.uint8 and _bytes(got) == want.tobytes()
    q2, s2 = TC.unpack_kv_blocks(got, 4, 2, 16)
    assert np.array_equal(q2.numpy(), q) and np.array_equal(s2.numpy(), s)


def test_scatter_refuses_mismatched_bundles():
    tc, _ = _plain(GQA, 5, "float32")
    before = tc.clone()
    with pytest.raises(ValueError, match="block ids"):
        TB.scatter_blocks(tc, [1, 2], torch.zeros(3, 3, BS, 2, 16),
                          block_size=BS)
    with pytest.raises(ValueError, match="outside"):
        TB.scatter_blocks(tc, [1], torch.zeros(2, 1, BS, 2, 16),
                          block_size=BS, start_layer=2)
    assert torch.equal(tc, before)

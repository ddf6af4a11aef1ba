"""The port's on-device weight quantization (``engine/quant.py``,
``ops/qmm.py``'s plain version) against the JAX package's
``dynamo_tpu/engine/quant.py``, on numpy-seeded inputs:

- ``quantize`` bit-equal to JAX ``quantize`` (q and s) for int8, int8-g16
  and int4-g16 on ``[I, O]``, ``[n, I, O]`` and ``[n, E, I, O]`` (int4
  compared through ``unpack_int4``);
- ``parse_spec`` accepts and refuses what the JAX one does, with its
  messages;
- ``pack_int4``/``unpack_int4``: the round trip and the nibble order;
- ``quant_matmul_ref``, ``qmm`` and ``materialize`` against JAX
  ``qmm``/``materialize`` in f32 (rtol 2e-5), with a zero point as in
  ``tests/test_quant.py``'s affine case, and the batched (expert) form;
- ``quant_matmul`` takes the plain version for CPU tensors and counts no
  launch;
- ``quantize_params`` against the JAX walk on ``mla_tiny``, the per-channel
  and full-width fallbacks of a narrow projection included;
- ``params_from_jax`` carries JAX int8 and int4 trees;
- ``init_params(quantization=...)`` equals ``quantize_params`` of the
  unquantized draw;
- a quantized ragged step against the JAX step on the same weights.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as JM
from dynamo_tpu.engine import quant as JQ
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine import quant as Q
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.models import get_model_config
from dynamo_tpu_torch.ops.qmm import quant_matmul, quant_matmul_ref

SPECS = ["int8", "int8-g16", "int4-g16"]
SHAPES = [(32, 24), (3, 32, 24), (2, 4, 32, 24)]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


def _jax_q(qt) -> np.ndarray:
    """A JAX QTensor's q as int8 numpy (int4 widened)."""
    return np.asarray(qt["q"]).astype(np.int8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("spec", SPECS)
def test_quantize_bit_equal_to_jax(spec, shape):
    bits, group = Q.parse_spec(spec)
    rng = np.random.default_rng(len(shape) + bits)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[-1])
         ).astype(np.float32)
    w[..., :, 3] = 0.0  # a zero column: the 1e-12 floor
    want = JQ.quantize(jnp.asarray(w), bits=bits, group=group)
    got = Q.quantize(torch.from_numpy(w), bits=bits, group=group)
    assert got["s"].dtype == torch.float32
    np.testing.assert_array_equal(_np(got["s"]), np.asarray(want["s"]))
    if bits == 4:
        assert got["q"].dtype == torch.uint8
        assert got["q"].shape == (*shape[:-2], shape[-2] // 2, shape[-1])
    else:
        assert got["q"].dtype == torch.int8
    np.testing.assert_array_equal(_np(Q.int_values(got["q"])), _jax_q(want))


def test_quantize_from_bf16_equals_jax():
    """A bf16 weight (the card's model dtype) quantizes as JAX quantizes
    the same bf16 values."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.standard_normal((64, 40)).astype(np.float32)
                         ).to(torch.bfloat16)
    for spec in SPECS:
        bits, group = Q.parse_spec(spec)
        got = Q.quantize(w, bits, group)
        want = JQ.quantize(jnp.asarray(w.float().numpy()).astype(
            jnp.bfloat16), bits=bits, group=group)
        np.testing.assert_array_equal(_np(got["s"]), np.asarray(want["s"]))
        np.testing.assert_array_equal(_np(Q.int_values(got["q"])),
                                      _jax_q(want))


@pytest.mark.parametrize("spec", ["int8", "int8-g128", "int4-g32", "int4-g1",
                                  "int4", "int2", "fp8", "int8-g0",
                                  "int8-g-4", "int4-gx", ""])
def test_parse_spec_matches_jax(spec):
    try:
        want = JQ.parse_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            Q.parse_spec(spec)
        assert str(got.value) == str(e)
        return
    assert Q.parse_spec(spec) == want


def test_pack_int4_round_trip_and_nibble_order():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(-8, 8, (3, 10, 6)).astype(np.int8))
    p = Q.pack_int4(q)
    assert p.dtype == torch.uint8 and p.shape == (3, 5, 6)
    assert torch.equal(Q.unpack_int4(p), q)
    # byte [k, o]: row 2k in the low nibble, row 2k+1 in the high nibble
    assert int(Q.pack_int4(torch.tensor([[-1], [2]], dtype=torch.int8))) \
        == 0x2F
    with pytest.raises(ValueError):
        Q.pack_int4(torch.zeros((3, 4), dtype=torch.int8))


def _qtensor(spec, I, O, lead=(), z=False, seed=0):
    """(JAX QTensor, port QTensor) of the same random weight."""
    bits, group = Q.parse_spec(spec)
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((*lead, I, O)) / np.sqrt(I)).astype(np.float32)
    jq = JQ.quantize(jnp.asarray(w), bits=bits, group=group)
    tq = Q.quantize(torch.from_numpy(w), bits=bits, group=group)
    if z:
        zv = rng.uniform(0, 0.05, tq["s"].shape).astype(np.float32)
        jq = dict(jq, z=jnp.asarray(zv))
        tq = dict(tq, z=torch.from_numpy(zv))
    return jq, tq


CASES = [("int8", False), ("int8-g16", False), ("int4-g16", False),
         ("int8-g16", True), ("int8", True)]


@pytest.mark.parametrize("spec,z", CASES)
def test_qmm_and_materialize_match_jax(spec, z):
    jq, tq = _qtensor(spec, 48, 40, z=z, seed=len(spec) + z)
    x = np.random.default_rng(9).standard_normal((7, 48)).astype(np.float32)
    want = np.asarray(JQ.qmm(jnp.asarray(x), jq))
    xt = torch.from_numpy(x)
    for fn in (Q.qmm, quant_matmul_ref, quant_matmul):
        np.testing.assert_allclose(_np(fn(xt, tq)), want, rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(
        _np(Q.materialize(tq, torch.float32)),
        np.asarray(JQ.materialize(jq, jnp.float32)), rtol=0, atol=0)
    np.testing.assert_array_equal(
        _np(Q.dequantize(tq)), np.asarray(JQ.dequantize(jq)))
    # a plain weight passes through
    assert Q.materialize(xt, torch.float32) is xt


def test_affine_zero_point_matches_jax():
    """tests/test_quant.py's affine case: w = s·q − z exactly."""
    rng = np.random.default_rng(3)
    q = rng.integers(0, 15, (32, 8)).astype(np.int8)
    s = rng.uniform(0.01, 0.1, (2, 8)).astype(np.float32)
    z = rng.uniform(0, 0.5, (2, 8)).astype(np.float32)
    jq = {"q": jnp.asarray(q), "s": jnp.asarray(s), "z": jnp.asarray(z)}
    tq = {k: torch.from_numpy(v) for k, v in (("q", q), ("s", s), ("z", z))}
    want = q * np.repeat(s, 16, axis=0) - np.repeat(z, 16, axis=0)
    np.testing.assert_array_equal(_np(Q.dequantize(tq)), want)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    np.testing.assert_allclose(
        _np(quant_matmul_ref(torch.from_numpy(x), tq)),
        np.asarray(JQ.qmm(jnp.asarray(x), jq)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("spec", ["int8", "int8-g16", "int4-g16"])
@pytest.mark.parametrize("shared_x", [True, False])
def test_batched_form_matches_jax_expert_einsum(spec, shared_x):
    """The expert-stack form: the JAX package's einsum over the
    materialized stack (``_mlp_moe``)."""
    jq, tq = _qtensor(spec, 32, 24, lead=(5,), seed=2)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 32) if shared_x else (5, 6, 32)
                            ).astype(np.float32)
    eq = "nd,edf->enf" if shared_x else "end,edf->enf"
    want = np.asarray(jnp.einsum(eq, jnp.asarray(x),
                                 JQ.materialize(jq, jnp.float32)))
    got = quant_matmul(torch.from_numpy(x), tq)
    assert got.shape == (5, 6, 24)
    np.testing.assert_allclose(_np(got), want, rtol=2e-5, atol=2e-5)


def test_wrapper_takes_the_plain_version_on_cpu():
    _, tq = _qtensor("int4-g16", 32, 16)
    x = torch.randn(3, 32, dtype=torch.bfloat16)
    n = quant_matmul.launches
    got = quant_matmul(x, tq)
    assert quant_matmul.launches == n  # no kernel ran
    assert torch.equal(got, quant_matmul_ref(x, tq))
    with pytest.raises(ValueError, match="quantized weight"):
        quant_matmul(x, torch.zeros(32, 16))


def _tree_equal(got, want, path=""):
    """A port tree equal to a JAX tree, leaf for leaf (int4 unpacked)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_equal(got[k], want[k], f"{path}.{k}")
        return
    if path.endswith(".q"):
        np.testing.assert_array_equal(_np(Q.int_values(got)),
                                      np.asarray(want).astype(np.int8), path)
    else:
        np.testing.assert_array_equal(_np(got), np.asarray(want), path)


@pytest.mark.parametrize("spec", ["int8", "int8-g32", "int4-g32"])
def test_quantize_params_matches_jax_walk_on_mla_tiny(spec, caplog):
    """mla_tiny's q_b (48 rows) does not divide 32: per-channel int8 at
    int8-g32, full width at int4-g32, as the JAX walk decides; both walks
    warn the same."""
    cfg = get_model_config("mla_tiny")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(lambda t: np.asarray(t.numpy()), tp)
    with caplog.at_level(logging.WARNING):
        want = JQ.quantize_params(jp, spec)
        jax_warn = [r.getMessage() for r in caplog.records]
        caplog.clear()
        got = Q.quantize_params(tp, spec)
        port_warn = [r.getMessage() for r in caplog.records]
    assert port_warn == jax_warn
    _tree_equal(got, want)
    q_b = got["layers"]["q_b"]
    if spec == "int8-g32":
        assert Q.is_qtensor(q_b) and q_b["s"].shape[-2] == 1
    if spec == "int4-g32":
        assert not Q.is_qtensor(q_b) and q_b.dtype == torch.float32
    # a quantized tree passes through a second walk unchanged
    again = Q.quantize_params(got, spec)
    assert again["layers"]["wo"]["q"] is got["layers"]["wo"]["q"]


@pytest.mark.parametrize("bits", [8, 4])
def test_params_from_jax_carries_quantized_trees(bits):
    cfg = get_model_config("tiny")
    tp = TM.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    jp = JQ.quantize_params(jax.tree.map(lambda t: np.asarray(t.numpy()),
                                         tp),
                            "int8-g16" if bits == 8 else "int4-g16")
    assert jp["layers"]["wq"]["q"].dtype.name == ("int8" if bits == 8
                                                  else "int4")
    got = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    q = got["layers"]["wq"]["q"]
    assert q.dtype == (torch.int8 if bits == 8 else torch.uint8)
    assert got["layers"]["wq"]["s"].dtype == torch.float32
    _tree_equal(got, jp)


@pytest.mark.parametrize("name", ["tiny", "mla_tiny", "moe_tiny"])
@pytest.mark.parametrize("spec", ["int8", "int8-g32", "int4-g16"])
def test_init_params_quantized_equals_quantize_params(name, spec):
    cfg = get_model_config(name)
    got = TM.init_params(cfg, torch.Generator().manual_seed(2), "cpu",
                         quantization=spec)
    want = Q.quantize_params(
        TM.init_params(cfg, torch.Generator().manual_seed(2), "cpu"), spec)

    def same(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path
    same(got, want, "")
    assert Q.is_qtensor(got["layers"]["w_gate"])


def test_layer_weight_and_draft_slices():
    lw = Q.quantize_params({"wq": torch.randn(3, 32, 16)}, "int4-g16")
    w1 = TM.layer_weight(lw, "wq", 1)
    assert torch.equal(w1["q"], lw["wq"]["q"][1])
    assert torch.equal(w1["s"], lw["wq"]["s"][1])
    cut = Q.slice_layers(lw["wq"], 2)
    assert cut["q"].shape[0] == 2 and cut["s"].shape[0] == 2
    assert cut["q"].data_ptr() == lw["wq"]["q"].data_ptr()  # a view
    # stack_layers undoes a per-layer split, field by field
    layers = [TM.layer_weight(lw, "wq", i) for i in range(3)]
    again = Q.stack_layers(layers)
    assert all(torch.equal(again[k], lw["wq"][k]) for k in ("q", "s"))
    assert torch.equal(Q.stack_layers([torch.ones(2), torch.zeros(2)]),
                       torch.tensor([[1.0, 1.0], [0.0, 0.0]]))


@pytest.mark.parametrize("name", ["tiny", "moe_tiny"])
@pytest.mark.parametrize("spec", ["int8", "int4-g16"])
def test_quantized_ragged_step_matches_jax(name, spec):
    """The port's ragged step on quantized weights (the plain version on
    the CPU) against the JAX step on the same quantized tree: logits and
    written KV within 1e-4."""
    from dynamo_tpu_torch.engine.config import EngineArgs
    from tests.test_torch_model import _pack

    cfg = get_model_config(name)
    args = EngineArgs(block_size=4, num_blocks=64, max_num_seqs=8,
                      max_num_batched_tokens=64, max_model_len=64)
    bs, nb = args.block_size, 64
    plain = TM.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tp = Q.quantize_params(plain, spec)
    jp = JQ.quantize_params(jax.tree.map(lambda t: np.asarray(t.numpy()),
                                         plain), spec)
    rng = np.random.default_rng(0)
    rows = [(8, 1), (12, 1), (0, 7), (4, 5)]
    ops = _pack(rows, args, rng, nb)
    shape = (cfg.num_layers, nb * bs, cfg.num_kv_heads, cfg.head_dim)
    kc0 = rng.standard_normal(shape, np.float32)
    vc0 = rng.standard_normal(shape, np.float32)
    jl, jk, jv = JM.make_ragged_step_fn(jax_preset(name), bs)(
        jp, *(jnp.asarray(a) for a in ops), jnp.asarray(kc0),
        jnp.asarray(vc0))
    tk, tv = torch.from_numpy(kc0.copy()), torch.from_numpy(vc0.copy())
    tl, _, _ = TM.make_ragged_step_fn(cfg, bs)(
        tp, *(torch.from_numpy(a) for a in ops), tk, tv)
    n = len(rows)
    np.testing.assert_allclose(tl.numpy()[:n], np.asarray(jl)[:n],
                               atol=1e-4, rtol=1e-4)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, bs:],
                                   np.asarray(want)[:, bs:], atol=1e-4,
                                   rtol=1e-4)

"""The torch port's forward pieces and ragged step against the JAX package.

Same numpy-seeded operands through both: ``rope_params`` for every scaling
kind (exact), ``rope`` and ``rms_norm`` (f32: 1e-6; bf16 compares after
the same final rounding, so within one bf16 ulp), and one packed ragged
step of the tiny model — decode rows, a fresh and a continuing prefill
chunk, padding tokens and padding rows — on identical weights from
``params_from_jax``. Logits agree within atol 1e-4 (f32; matmul and
transcendental orders differ between XLA and PyTorch) and the caches are
equal after the step within the same tolerance, the null block excepted:
padding tokens write into it, and its contents are garbage by design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import ragged_grid_shape
from dynamo_tpu_torch.engine.weights import params_from_jax

SCALINGS = [
    None,
    {"rope_type": "default"},
    {"rope_type": "linear", "factor": 4.0},
    {"rope_type": "yarn", "factor": 32.0,
     "original_max_position_embeddings": 4096, "beta_fast": 32.0,
     "beta_slow": 1.0},
    {"rope_type": "yarn", "factor": 32.0, "truncate": False,
     "original_max_position_embeddings": 4096},
    {"rope_type": "yarn", "factor": 40.0, "mscale": 1.0,
     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096},
    {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
     "high_freq_factor": 4.0, "original_max_position_embeddings": 8192},
    {"type": "longrope", "max_position_embeddings": 131072,
     "original_max_position_embeddings": 4096,
     "long_factor": list(np.linspace(1.0, 4.0, 32)),
     "short_factor": list(np.linspace(1.0, 1.5, 32))},
]


@pytest.mark.parametrize("scaling", SCALINGS)
def test_rope_params_match(scaling):
    got_inv, got_attn = TM.rope_params(500000.0, 64, scaling)
    want_inv, want_attn = M.rope_params(500000.0, 64, scaling)
    np.testing.assert_array_equal(got_inv, want_inv)
    assert got_attn == want_attn


@pytest.mark.parametrize("scaling", [None, SCALINGS[3], SCALINGS[6]])
def test_rope_matches(scaling):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 9, 4, 64), np.float32)
    pos = rng.integers(0, 4000, (1, 9)).astype(np.int32)
    want = np.asarray(M._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0,
                              scaling))
    inv, attn = TM.rope_params(10000.0, 64, scaling)
    got = TM.rope(torch.from_numpy(x), torch.from_numpy(pos),
                  torch.from_numpy(inv), attn).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("x_dtype,w_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])
def test_rms_norm_matches(x_dtype, w_dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 64), np.float32)
    w = (1 + 0.1 * rng.standard_normal((64,))).astype(np.float32)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    want = M._rms_norm(jnp.asarray(x).astype(x_dtype),
                       jnp.asarray(w).astype(w_dtype), 1e-5)
    got = TM.rms_norm(torch.from_numpy(x).to(tdt[x_dtype]),
                      torch.from_numpy(w).to(tdt[w_dtype]), 1e-5)
    assert str(got.dtype).endswith(x_dtype)
    tol = 1e-6 if x_dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def _pack(rows, args: EngineArgs, tokens_rng, num_blocks):
    """Packed ragged operands for rows of (start, chunk) — decode rows are
    chunk 1 — with disjoint random block tables, laid out as the engines
    pack a plan."""
    bs = args.block_size
    total = sum(c for _, c in rows)
    T = args.bucket_ragged_tokens(total)
    R = args.ragged_rows(T)
    W = args.max_blocks_per_seq
    C, S_C = ragged_grid_shape(T)
    ints5 = np.zeros((5, T), np.int32)
    ints5[3] = C
    rows3 = np.zeros((R, 3), np.int32)
    grid_rows = np.zeros((C,), np.int32)
    bt = np.zeros((R, W), np.int32)
    free = list(tokens_rng.permutation(np.arange(1, num_blocks)))
    t = tile = 0
    for i, (start, chunk) in enumerate(rows):
        end = start + chunk
        n = -(-end // bs)
        bt[i, :n] = [free.pop() for _ in range(n)]
        ints5[0, t:t + chunk] = tokens_rng.integers(1, 256, chunk)
        ints5[1, t:t + chunk] = np.arange(start, end)
        ints5[2, t:t + chunk] = [bt[i, p // bs] * bs + p % bs
                                 for p in range(start, end)]
        if chunk > 1:
            for off in range(0, chunk, S_C):
                width = min(S_C, chunk - off)
                grid_rows[tile] = i
                ints5[3, t + off:t + off + width] = tile
                ints5[4, t + off:t + off + width] = np.arange(width)
                tile += 1
        rows3[i] = (t, chunk, end)
        t += chunk
    return ints5, rows3, grid_rows, bt


def test_ragged_step_matches_jax():
    cfg = ModelConfig.tiny()
    jcfg = JaxModelConfig.tiny()
    args = EngineArgs(block_size=4, num_blocks=64, max_num_seqs=8,
                      max_num_batched_tokens=64, max_model_len=64)
    bs, nb = args.block_size, 64
    jparams = M.init_params(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(0)
    # two decode rows, a fresh prefill chunk, a continuing chunk; 14 real
    # tokens in a 16-token bucket, 4 real rows of 8
    rows = [(8, 1), (12, 1), (0, 7), (4, 5)]
    ops = _pack(rows, args, rng, nb)
    shape = (cfg.num_layers, nb * bs, cfg.num_kv_heads, cfg.head_dim)
    kc0 = rng.standard_normal(shape, np.float32)
    vc0 = rng.standard_normal(shape, np.float32)

    jfn = M.make_ragged_step_fn(jcfg, bs)
    jl, jk, jv = jfn(jparams, *(jnp.asarray(a) for a in ops),
                     jnp.asarray(kc0), jnp.asarray(vc0))
    tk, tv = torch.from_numpy(kc0.copy()), torch.from_numpy(vc0.copy())
    tfn = TM.make_ragged_step_fn(cfg, bs)
    tl, tk2, tv2 = tfn(tparams, *(torch.from_numpy(a) for a in ops), tk, tv)
    assert tk2 is tk and tv2 is tv  # updated in place
    assert tl.dtype == torch.float32 and tl.shape == (8, cfg.vocab_size)
    n_real = len(rows)
    np.testing.assert_allclose(tl.numpy()[:n_real], np.asarray(jl)[:n_real],
                               atol=1e-4, rtol=1e-4)
    for got, want in ((tk, jk), (tv, jv)):
        np.testing.assert_allclose(got.numpy()[:, bs:],
                                   np.asarray(want)[:, bs:],
                                   atol=1e-4, rtol=1e-4)
    # the step really wrote the new tokens' KV
    assert not np.allclose(tk.numpy()[:, bs:], kc0[:, bs:])


@pytest.mark.parametrize("switch", [
    {"num_experts": 4, "moe_activation": "swiglu_oss"},
    {"kv_lora_rank": 16, "attention_sinks": True},
    {"kv_lora_rank": 16, "sliding_window": 8},
    {"kv_lora_rank": 16, "layer_windows": (8, 0)}])
def test_unported_switches_refused(switch):
    """MoE, MLA and the dense-family switches are served (their parity
    cases are tests/test_torch_families.py's); a model with a switch the
    port lacks (the gpt-oss expert activation, or sinks or windows on MLA,
    which the JAX MLA attention ignores) is refused."""
    import dataclasses

    cfg = dataclasses.replace(ModelConfig.tiny(), **switch)
    with pytest.raises(NotImplementedError):
        TM.make_ragged_step_fn(cfg, 4)


def test_unported_engine_knobs_refused():
    with pytest.raises(ValueError, match="use_pallas_attention"):
        EngineArgs(use_pallas_attention=True)
    with pytest.raises(ValueError, match="tp_size"):
        EngineArgs(tp_size=2)

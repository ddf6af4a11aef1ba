"""The torch port's MoE MLP against the JAX package's single-device path.

- ``router_weights`` against ``_router_weights`` for both scoring
  functions, group-limited choice, ``norm_topk_prob``, routed scaling, the
  correction bias (sigmoid) and ``router_logit_bias`` (softmax): the same
  experts chosen for every token, weights within 1e-6.
- ``mlp_moe`` against ``_mlp_moe`` (all experts, f32): atol 1e-5.
- ``init_params`` gives the JAX package's parameter tree (shapes, dtypes,
  the ``dense_layers`` prefix), and ``params_from_jax`` carries a nested
  MLA + MoE tree over value for value.
- A GQA + MoE ragged step (``moe_tiny``) against the JAX step: logits
  within atol 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import model as M
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu.models import get_model_config as jax_preset
from dynamo_tpu_torch.engine import model as TM
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.models import get_model_config

from tests.test_torch_mla import V2_LITE_TINY
from tests.test_torch_model import _pack

ROUTING = {
    "softmax": dict(scoring_func="softmax"),
    "softmax_groups_norm": dict(scoring_func="softmax", n_group=4,
                                topk_group=2, norm_topk_prob=True),
    "softmax_logit_bias": dict(scoring_func="softmax",
                               router_logit_bias=True,
                               routed_scaling_factor=1.5),
    "sigmoid": dict(scoring_func="sigmoid", routed_scaling_factor=2.5),
    "sigmoid_groups_norm": dict(scoring_func="sigmoid", n_group=4,
                                topk_group=2, norm_topk_prob=True,
                                routed_scaling_factor=2.5),
}


def _moe_cfg(**switches):
    return dict(vocab_size=64, hidden_size=32, intermediate_size=48,
                num_layers=2, num_heads=4, num_kv_heads=2, dtype="float32",
                num_experts=16, num_experts_per_tok=3,
                moe_intermediate_size=24, **switches)


def _pair(**switches):
    f = _moe_cfg(**switches)
    return ModelConfig(**f), JaxModelConfig(**f)


@pytest.mark.parametrize("name", sorted(ROUTING))
def test_router_weights_match_jax(name):
    cfg, jcfg = _pair(**ROUTING[name])
    rng = np.random.default_rng(len(name))
    x = rng.standard_normal((40, 32), np.float32)
    w = (rng.standard_normal((32, 16)) / np.sqrt(32)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(16)).astype(np.float32)
    want = np.asarray(M._router_weights(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(bias), jcfg))
    got = TM.router_weights(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(bias), cfg).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got != 0, want != 0)  # same experts
    assert ((got != 0).sum(1) == 3).all()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["softmax", "sigmoid_groups_norm"])
def test_mlp_moe_matches_jax(name):
    cfg, jcfg = _pair(**ROUTING[name])
    rng = np.random.default_rng(3)
    E, D, Fm = 16, 32, 24

    def w(*shape):
        return (rng.standard_normal(shape) / np.sqrt(shape[-2])).astype(
            np.float32)

    lp = {"router": w(D, E), "router_bias": np.zeros(E, np.float32),
          "w_gate": w(E, D, Fm), "w_up": w(E, D, Fm), "w_down": w(E, Fm, D)}
    x = rng.standard_normal((2, 9, D), np.float32)
    want = np.asarray(M._mlp_moe(jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in lp.items()},
                                 jcfg))
    t = {k: torch.from_numpy(v) for k, v in lp.items()}
    got = TM.mlp_moe(torch.from_numpy(x.reshape(18, D)), t["router"],
                     t["router_bias"], t["w_gate"], t["w_up"], t["w_down"],
                     cfg)
    np.testing.assert_allclose(got.numpy(), want.reshape(18, D), atol=1e-5,
                               rtol=1e-5)


def _tree(t):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in _tree(v).items()})
        else:
            out[k] = (tuple(v.shape), str(v.dtype).split(".")[-1])
    return out


@pytest.mark.parametrize("name", ["mla_tiny", "moe_tiny", "v2_lite_tiny"])
def test_init_params_layout_matches_jax(name):
    if name == "v2_lite_tiny":
        cfg, jcfg = (ModelConfig(**V2_LITE_TINY),
                     JaxModelConfig(**V2_LITE_TINY))
    elif name == "moe_tiny":
        jcfg = jax_preset(name)
        cfg = ModelConfig(**dataclasses.asdict(jcfg))
    else:
        cfg, jcfg = get_model_config(name), jax_preset(name)
    want = jax.eval_shape(lambda k: M.init_params(jcfg, k),
                          jax.random.key(0))
    got = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert _tree(got) == _tree(want)
    if cfg.num_dense_prefix_layers:
        assert "dense_layers" in got


def test_params_from_jax_nested_mla_moe():
    jp = M.init_params(jax_preset("mla_tiny"), jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    assert set(tp) == {"embed", "layers", "dense_layers", "final_norm",
                       "lm_head"}
    for stack in ("layers", "dense_layers"):
        assert set(tp[stack]) == set(jp[stack])
        for k, v in jp[stack].items():
            np.testing.assert_array_equal(tp[stack][k].numpy(),
                                          np.asarray(v))


def test_moe_gqa_ragged_step_matches_jax():
    jcfg = jax_preset("moe_tiny")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    args = EngineArgs(block_size=4, num_blocks=64, max_num_seqs=8,
                      max_num_batched_tokens=64, max_model_len=64)
    jp = M.init_params(jcfg, jax.random.key(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(2)
    rows = [(8, 1), (0, 7), (4, 5)]
    ops = _pack(rows, args, rng, 64)
    shape = (cfg.num_layers, 64 * 4, cfg.num_kv_heads, cfg.head_dim)
    kc0 = rng.standard_normal(shape, np.float32)
    vc0 = rng.standard_normal(shape, np.float32)
    jl, _, _ = M.make_ragged_step_fn(jcfg, 4)(
        jp, *(jnp.asarray(a) for a in ops), jnp.asarray(kc0),
        jnp.asarray(vc0))
    tl, _, _ = TM.make_ragged_step_fn(cfg, 4)(
        tp, *(torch.from_numpy(a) for a in ops), torch.from_numpy(kc0),
        torch.from_numpy(vc0))
    np.testing.assert_allclose(tl.numpy()[:3], np.asarray(jl)[:3],
                               atol=1e-4, rtol=1e-4)


def test_unported_moe_activation_refused():
    cfg = ModelConfig(**_moe_cfg(moe_activation="swiglu_oss"))
    with pytest.raises(NotImplementedError, match="moe_activation"):
        TM.make_ragged_step_fn(cfg, 4)

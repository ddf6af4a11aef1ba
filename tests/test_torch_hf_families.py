"""The port's loader and engine on tiny transformers checkpoints of the
dense families (the twins of ``tests/test_parity.py``'s Mistral, Qwen2,
Qwen3, Gemma and Gemma-2 cases, with the same configs):

- ``ModelConfig.from_pretrained`` equal to the JAX package's, field for
  field, and ``load_hf_params`` equal, exactly in f32, to
  ``params_from_jax(dynamo_tpu.engine.loader.load_hf_params(...))``: the
  q/k/v biases, q/k norms, Gemma's (1 + w) norms folded in f32 and
  Gemma-2's four norms a layer, the tied head;
- the port engine's greedy tokens from that checkpoint equal to
  transformers' greedy ``generate`` (eager attention, f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from dynamo_tpu.engine import loader as jloader
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.engine import loader
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions

pytestmark = pytest.mark.anyio

#: tests/test_parity.py's configs
COMMON = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
              num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, rope_theta=10000.0,
              max_position_embeddings=256, attn_implementation="eager")
FAMILIES = {
    "mistral": ("MistralForCausalLM", "MistralConfig",
                dict(sliding_window=8, tie_word_embeddings=False)),
    "qwen2": ("Qwen2ForCausalLM", "Qwen2Config",
              dict(sliding_window=4096, use_sliding_window=False,
                   tie_word_embeddings=False)),
    "qwen3": ("Qwen3ForCausalLM", "Qwen3Config",
              dict(head_dim=32, tie_word_embeddings=False)),
    "gemma": ("GemmaForCausalLM", "GemmaConfig",
              dict(head_dim=32, hidden_activation="gelu_pytorch_tanh",
                   tie_word_embeddings=True)),
    "gemma2": ("Gemma2ForCausalLM", "Gemma2Config",
               dict(num_hidden_layers=4, head_dim=32,
                    hidden_activation="gelu_pytorch_tanh",
                    query_pre_attn_scalar=24, sliding_window=8,
                    attn_logit_softcapping=50.0,
                    final_logit_softcapping=30.0,
                    tie_word_embeddings=True)),
}
PROMPT = 12
NEW_TOKENS = 8


@pytest.fixture(scope="module", params=list(FAMILIES))
def family_ckpt(request, tmp_path_factory):
    """(family, checkpoint path, the transformers model) of one family."""
    model_cls, cfg_cls, extra = FAMILIES[request.param]
    cfg = getattr(transformers, cfg_cls)(**{**COMMON, **extra})
    path = str(tmp_path_factory.mktemp(request.param))
    torch.manual_seed(0)
    model = getattr(transformers, model_cls)(cfg).eval()
    model.save_pretrained(path, safe_serialization=True)
    return request.param, path, model


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def test_config_and_params_equal_jax_loader(family_ckpt):
    family, path, _ = family_ckpt
    cfg = ModelConfig.from_pretrained(path)
    jcfg = JaxModelConfig.from_pretrained(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg.dtype = jcfg.dtype = "float32"
    got = dict(_flat(loader.load_hf_params(cfg, path, "cpu")))
    want = dict(_flat(params_from_jax(jax.tree.map(
        np.asarray, jloader.load_hf_params(jcfg, path, dtype=jnp.float32)),
        "cpu")))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, \
            name
        assert torch.equal(got[name], w), name
    switched = {"qwen2": "layers.bq", "qwen3": "layers.q_norm",
                "gemma2": "layers.post_mlp_norm"}.get(family)
    if switched:
        assert switched in got


async def test_engine_greedy_matches_hf(family_ckpt):
    family, path, model = family_ckpt
    rng = np.random.default_rng(7)
    prompt = [int(t) for t in rng.integers(1, 128, PROMPT)]
    with torch.no_grad():
        out = model.generate(torch.tensor([prompt]),
                             max_new_tokens=NEW_TOKENS, do_sample=False,
                             eos_token_id=None, pad_token_id=0)
    expected = out[0, PROMPT:].tolist()

    cfg, params = loader.load_model(path, "cpu", torch.float32)
    cfg.dtype = "float32"
    if family == "gemma2":  # bf16 in a bf16 model: the folded norms stay f32
        _, bf16 = loader.load_model(path, "cpu")
        assert bf16["layers"]["post_attn_norm"].dtype == torch.float32
        assert bf16["layers"]["wq"].dtype == torch.bfloat16
    eng = AsyncTorchEngine(
        cfg, EngineArgs(block_size=4, num_blocks=64, max_num_seqs=2,
                        max_num_batched_tokens=32, max_model_len=64),
        params=params, device="cpu")
    got = []
    async for o in eng.generate(PreprocessedRequest(
            model=family, token_ids=prompt,
            stop_conditions=StopConditions(max_tokens=NEW_TOKENS,
                                           ignore_eos=True))):
        got.extend(o.token_ids)
    await eng.close()
    assert got == expected

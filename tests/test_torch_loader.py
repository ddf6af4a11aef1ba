"""The port's checkpoint loader against the JAX package's, and against
transformers.

- ``read_safetensors`` (the port's own reader over a file map) against
  ``safetensors.torch.load_file``, dtype by dtype;
- ``ModelConfig.from_hf_config`` against the JAX package's, field by
  field, on the ``tests/hf_fixture.py`` Llama checkpoint and on a tiny
  ``DeepseekV2ForCausalLM`` (MLA + MoE, YaRN ``rope_scaling``) written here
  with transformers;
- ``load_hf_params`` equal, exactly in f32, to
  ``params_from_jax(dynamo_tpu.engine.loader.load_hf_params(...))`` for
  both checkpoints;
- the port engine's greedy tokens on the Llama fixture equal to
  transformers' greedy ``generate`` (the twin of
  ``tests/test_real_checkpoint.py:49``), and on the DeepSeek-V2 YaRN
  checkpoint (MLA, MoE, mscale, the de-interleaved rope).

The dense families' checkpoints are ``tests/test_torch_hf_families.py``'s.
"""

import dataclasses
import json
import os
from contextlib import ExitStack

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")
safetensors_torch = pytest.importorskip("safetensors.torch")

from dynamo_tpu.engine import loader as jloader
from dynamo_tpu.engine.config import ModelConfig as JaxModelConfig
from dynamo_tpu_torch.engine import loader
from dynamo_tpu_torch.engine.config import EngineArgs, ModelConfig
from dynamo_tpu_torch.engine.engine import AsyncTorchEngine
from dynamo_tpu_torch.engine.weights import params_from_jax
from dynamo_tpu_torch.protocols import PreprocessedRequest, StopConditions
from tests.hf_fixture import make_tiny_llama_checkpoint

pytestmark = pytest.mark.anyio

YARN = {"type": "yarn", "factor": 4.0,
        "original_max_position_embeddings": 128, "beta_fast": 32.0,
        "beta_slow": 1.0, "mscale": 0.707, "mscale_all_dim": 0.707}


@pytest.fixture(scope="module")
def llama_ckpt(tmp_path_factory):
    return make_tiny_llama_checkpoint(str(tmp_path_factory.mktemp("llama")))


@pytest.fixture(scope="module")
def deepseek_ckpt(tmp_path_factory):
    from transformers import DeepseekV2Config, DeepseekV2ForCausalLM

    path = str(tmp_path_factory.mktemp("deepseek"))
    cfg = DeepseekV2Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=4, n_routed_experts=4, n_shared_experts=1,
        num_experts_per_tok=2, first_k_dense_replace=1, kv_lora_rank=32,
        q_lora_rank=None, qk_nope_head_dim=16, qk_rope_head_dim=8,
        v_head_dim=16, max_position_embeddings=512, topk_method="greedy",
        n_group=1, topk_group=1, norm_topk_prob=False,
        routed_scaling_factor=1.0, scoring_func="softmax",
        rope_scaling=dict(YARN), tie_word_embeddings=False)
    torch.manual_seed(5)
    DeepseekV2ForCausalLM(cfg).save_pretrained(path, safe_serialization=True)
    return path


def _save(model_cls, cfg, path: str, seed: int) -> str:
    torch.manual_seed(seed)
    model_cls(cfg).save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def mixtral_ckpt(tmp_path_factory):
    """MoE GQA with Mixtral's ``block_sparse_moe`` expert names."""
    from transformers import MixtralConfig, MixtralForCausalLM

    return _save(MixtralForCausalLM, MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=32,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=256, tie_word_embeddings=False),
        str(tmp_path_factory.mktemp("mixtral")), 6)


@pytest.fixture(scope="module")
def phi3_ckpt(tmp_path_factory):
    """Dense GQA with Phi-3's fused qkv and gate|up projections."""
    from transformers import Phi3Config, Phi3ForCausalLM

    return _save(Phi3ForCausalLM, Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, tie_word_embeddings=False,
        pad_token_id=0), str(tmp_path_factory.mktemp("phi3")), 7)


# ------------------------------------------------------------- the reader


@pytest.mark.parametrize("dtype", [
    torch.bfloat16, torch.float16, torch.float32, torch.float64, torch.int8,
    torch.uint8, torch.int16, torch.int32, torch.int64, torch.bool])
def test_reader_matches_safetensors(tmp_path, dtype):
    g = torch.Generator().manual_seed(3)
    base = torch.randn(7, 5, generator=g) * 50
    tensors = {"w": base.to(dtype), "v": base[0].to(dtype),
               "scalar": base[1, 1].to(dtype), "empty": base[:0].to(dtype),
               # an odd-sized int8 neighbour leaves the next tensor
               # unaligned for wider dtypes
               "odd": torch.arange(3, dtype=torch.int8),
               "z": base[2:4].to(dtype)}
    tensors = {k: v.clone() for k, v in tensors.items()}  # no shared storage
    path = str(tmp_path / "m.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    want = safetensors_torch.load_file(path)
    with ExitStack() as files:
        got = loader.read_safetensors(path, files)
        assert sorted(got) == sorted(want)
        for name, t in want.items():
            assert got[name].dtype == t.dtype and got[name].shape == t.shape
            assert torch.equal(got[name], t), name


def test_reader_refuses_a_tensor_past_the_end(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    safetensors_torch.save_file({"w": torch.ones(4)}, path)
    with open(path, "r+b") as f:  # cut the data short
        f.truncate(os.path.getsize(path) - 4)
    with ExitStack() as files, pytest.raises(ValueError, match="outside"):
        loader.read_safetensors(path, files)


# ------------------------------------------------------------- the config


def test_config_matches_jax_llama(llama_ckpt):
    got = ModelConfig.from_pretrained(llama_ckpt)
    want = JaxModelConfig.from_pretrained(llama_ckpt)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.num_kv_heads == 2 and got.rope_theta == 500000.0


def test_config_matches_jax_deepseek_yarn(deepseek_ckpt):
    got = ModelConfig.from_pretrained(deepseek_ckpt)
    want = JaxModelConfig.from_pretrained(deepseek_ckpt)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.is_mla and got.is_moe and got.num_dense_prefix_layers == 1
    assert got.rope_scaling["factor"] == 4.0
    assert got.rope_scaling.get("rope_type", got.rope_scaling.get("type")) \
        == "yarn"


# ------------------------------------------------------------- the params


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _params_equal_jax(path):
    cfg = ModelConfig.from_pretrained(path)
    cfg.dtype = "float32"
    jcfg = JaxModelConfig.from_pretrained(path)
    jcfg.dtype = "float32"
    got = loader.load_hf_params(cfg, path, "cpu")
    want = params_from_jax(jax.tree.map(np.asarray, jloader.load_hf_params(
        jcfg, path, dtype=jnp.float32)), "cpu")
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        assert got[name].shape == w.shape, name
        assert torch.equal(got[name], w), name
    return got


def test_llama_params_equal_jax_loader(llama_ckpt):
    got = _params_equal_jax(llama_ckpt)
    assert got["layers.wq"].shape == (2, 64, 64)  # [L, in, out]


def test_deepseek_params_equal_jax_loader(deepseek_ckpt):
    got = _params_equal_jax(deepseek_ckpt)
    assert got["layers.w_gate"].shape == (2, 4, 64, 32)  # [L, E, D, Fm]
    assert "dense_layers.w_gate" in got and "layers.ws_gate" in got


@pytest.mark.parametrize("family", ["mixtral", "phi3"])
def test_fused_and_expert_layouts_equal_jax_loader(family, request):
    path = request.getfixturevalue(f"{family}_ckpt")
    cfg = ModelConfig.from_pretrained(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        JaxModelConfig.from_pretrained(path))
    got = _params_equal_jax(path)
    if family == "mixtral":
        assert got["layers.w_up"].shape == (2, 4, 64, 32)
    else:  # split at the head and gate|up boundaries
        assert got["layers.wk"].shape == (2, 64, 32)
        assert got["layers.w_up"].shape == (2, 64, 96)


def test_load_model_bf16_and_refusals(llama_ckpt, tmp_path):
    cfg, params = loader.load_model(llama_ckpt, "cpu")
    assert cfg.dtype == "bfloat16"
    assert params["layers"]["wq"].dtype == torch.bfloat16
    # a pre-quantized checkpoint is refused (MXFP4 names its ROADMAP item)
    qdir = tmp_path / "q"
    qdir.mkdir()
    for f in os.listdir(llama_ckpt):
        (qdir / f).write_bytes(open(os.path.join(llama_ckpt, f), "rb").read())
    raw = json.loads((qdir / "config.json").read_text())
    raw["quantization_config"] = {"quant_method": "fp8"}
    (qdir / "config.json").write_text(json.dumps(raw))
    with pytest.raises(NotImplementedError,
                       match=r"quantized checkpoint \(fp8\).*quantization="):
        loader.load_model(str(qdir), "cpu")
    raw["quantization_config"] = {"quant_method": "mxfp4"}
    (qdir / "config.json").write_text(json.dumps(raw))
    with pytest.raises(NotImplementedError, match="A9"):
        loader.load_model(str(qdir), "cpu")
    with pytest.raises(FileNotFoundError):
        loader.load_hf_params(cfg, str(tmp_path), "cpu")


@pytest.mark.parametrize("spec", ["int8", "int4-g32"])
def test_load_quantized_equals_quantize_params(llama_ckpt, spec):
    """``load_hf_params(quantization=...)`` quantizes each weight as it is
    stacked; the tree equals ``quantize_params`` of the unquantized load,
    bit for bit."""
    from dynamo_tpu_torch.engine.quant import is_qtensor, quantize_params

    cfg, plain = loader.load_model(llama_ckpt, "cpu")
    got = loader.load_hf_params(cfg, llama_ckpt, "cpu", quantization=spec)
    want = quantize_params(plain, spec)

    def same(a, b, path):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for k in b:
                same(a[k], b[k], f"{path}.{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path
    same(got, want, "")
    assert is_qtensor(got["layers"]["w_down"])
    assert is_qtensor(got["lm_head"]) and not is_qtensor(got["embed"])


# ------------------------------------------------------------- greedy vs HF


async def test_engine_greedy_matches_hf(llama_ckpt):
    from dynamo_tpu.llm.tokenizer import TokenizerWrapper

    tk = TokenizerWrapper.from_dir(llama_ckpt)
    prompt = tk.encode("the quick brown fox")
    n_new = 12
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        llama_ckpt, attn_implementation="eager").eval()
    with torch.no_grad():
        out = hf.generate(torch.tensor([prompt]), max_new_tokens=n_new,
                          do_sample=False, eos_token_id=None, pad_token_id=0)
    expected = out[0, len(prompt):].tolist()

    cfg, params = loader.load_model(llama_ckpt, "cpu", torch.float32)
    cfg.dtype = "float32"
    eng = AsyncTorchEngine(
        cfg, EngineArgs(block_size=4, num_blocks=128, max_num_seqs=4,
                        max_num_batched_tokens=64, max_model_len=256),
        params=params, device="cpu")
    got = []
    async for o in eng.generate(PreprocessedRequest(
            model="tiny", token_ids=prompt,
            stop_conditions=StopConditions(max_tokens=n_new,
                                           ignore_eos=True))):
        got.extend(o.token_ids)
    await eng.close()
    assert eng.pipelined_steps > 0
    assert got == expected


async def test_engine_greedy_matches_hf_deepseek_yarn(deepseek_ckpt):
    """A10's check: the MLA + MoE checkpoint with YaRN rope scaling (mscale
    into the softmax scale, the rope de-interleaved at load) through the
    port's loader and engine, greedy tokens equal to transformers'."""
    prompt = [int(t) for t in np.random.default_rng(3).integers(1, 128, 12)]
    n_new = 8
    hf = transformers.AutoModelForCausalLM.from_pretrained(
        deepseek_ckpt, attn_implementation="eager").eval()
    with torch.no_grad():
        out = hf.generate(torch.tensor([prompt]), max_new_tokens=n_new,
                          do_sample=False, eos_token_id=None, pad_token_id=0)
    expected = out[0, len(prompt):].tolist()

    cfg, params = loader.load_model(deepseek_ckpt, "cpu", torch.float32)
    cfg.dtype = "float32"
    eng = AsyncTorchEngine(
        cfg, EngineArgs(block_size=4, num_blocks=64, max_num_seqs=2,
                        max_num_batched_tokens=32, max_model_len=64),
        params=params, device="cpu")
    got = []
    async for o in eng.generate(PreprocessedRequest(
            model="tiny", token_ids=prompt,
            stop_conditions=StopConditions(max_tokens=n_new,
                                           ignore_eos=True))):
        got.extend(o.token_ids)
    await eng.close()
    assert got == expected

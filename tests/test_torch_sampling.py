"""The port's sampler against the JAX package's on the same inputs.

The seeded draw must be ``jax.random.categorical``'s: the threefry words
and the uniforms bit for bit, the Gumbel noise within a few float32 steps
(the logs of XLA and of PyTorch may differ by an ulp each), and the tokens
equal. Logits, temperatures and keys are made with numpy from a seed and
handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as JS
from dynamo_tpu.llm.guided import get_machine as jax_get_machine
from dynamo_tpu.structured.compiler import compile_fsm as jax_compile_fsm
from dynamo_tpu.structured.runtime import StructuredRuntime as JaxRuntime
from dynamo_tpu_torch.engine import sampling as TS
from dynamo_tpu_torch.llm.guided import get_machine
from dynamo_tpu_torch.ops import sample as OS
from dynamo_tpu_torch.structured.compiler import compile_fsm
from dynamo_tpu_torch.structured.runtime import StructuredRuntime

EPS = float(np.finfo(np.float32).eps)


def _jax_key(seed, step):
    kd = JS.make_keys([seed], [step])[0]
    return jax.random.wrap_key_data(jnp.asarray(kd), impl="threefry2x32")


def _bits(seed, step, V):
    return OS.random_bits_ref(torch.tensor([seed]), torch.tensor([step]),
                              V)[0]


@pytest.mark.parametrize("V", [1, 7, 1000, 32000])
@pytest.mark.parametrize("step", [0, 2**32 - 1])
@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1])
def test_threefry_bits_and_uniforms_bit_equal(seed, step, V):
    key = _jax_key(seed, step)
    bits = _bits(seed, step, V)
    want = np.asarray(jax.random.bits(key, (V,), jnp.uint32))
    np.testing.assert_array_equal(bits.numpy(), want.astype(np.int64))
    u = OS.uniform_ref(bits).numpy()
    ju = np.asarray(jax.random.uniform(key, (V,)))
    np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))
    # the Gumbel's own uniform, on [tiny, 1)
    tiny = np.finfo(np.float32).tiny
    ju2 = np.asarray(jax.random.uniform(key, (V,), minval=tiny, maxval=1.0))
    u2 = torch.clamp_min(torch.from_numpy(u) + OS.TINY, OS.TINY).numpy()
    np.testing.assert_array_equal(u2.view(np.int32), ju2.view(np.int32))


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 123), (2**31 - 1, 2**32 - 1)])
def test_gumbel_noise_within_4_ulps(seed, step):
    """-log(-log(u)): each log may differ from XLA's by an ulp, which the
    outer log turns into a few float32 steps at the scale max(1, |g|)
    (near g = 0 the relative error of the outer log's input is what
    shows)."""
    V = 32000
    g = OS.gumbel_ref(_bits(seed, step, V)).numpy()
    jg = np.asarray(jax.random.gumbel(_jax_key(seed, step), (V,)))
    scale = np.maximum(1.0, np.abs(jg))
    assert (np.abs(g - jg) <= 4 * EPS * scale).all()


def _batch(V, seed=0):
    """A mixed batch: greedy rows, temperatures 0.3-1.5, top-k 0/1/5/64/100
    (and above V for a V < 64), top-p 0/0.5/0.9/1, seeds and steps."""
    rng = np.random.default_rng(seed)
    temps = [0.0, 0.3, 0.7, 1.0, 1.5, 0.9, 1.2, 0.0, 0.5, 1.1, 0.8, 1.4]
    top_k = [0, 0, 1, 5, 64, 100, 0, 5, V + 3, 0, 5, 64]
    top_p = [1.0, 0.0, 1.0, 0.9, 0.5, 1.0, 0.9, 0.5, 1.0, 0.5, 0.9, 0.0]
    B = len(temps)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    seeds = rng.integers(0, 2**31, B)
    steps = rng.integers(0, 5000, B)
    return (logits, np.asarray(temps, np.float32),
            np.asarray(top_k, np.int32), np.asarray(top_p, np.float32),
            JS.make_keys(seeds, steps))


@pytest.mark.parametrize("V,seed", [(1000, 0), (1000, 1), (40, 2),
                                    (32000, 3)])
def test_sample_tokens_equal_jax(V, seed):
    lg, temp, top_k, top_p, keys = _batch(V, seed)
    jt, jl = JS.sample_jit(jnp.asarray(lg), temp, top_k, top_p, keys)
    tt, tl = TS.sample(torch.from_numpy(lg), temp, top_k, top_p, keys)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6,
                               rtol=0)


def test_all_greedy_batch_never_draws(monkeypatch):
    """An all-greedy batch takes the argmax and the log_softmax only."""
    def boom(*a):
        raise AssertionError("the draw ran for an all-greedy batch")

    monkeypatch.setattr(TS, "gumbel_argmax", boom)
    lg, _, top_k, top_p, keys = _batch(100)
    temp = np.zeros(len(lg), np.float32)
    tt, _ = TS.sample(torch.from_numpy(lg), temp, top_k, top_p, keys)
    np.testing.assert_array_equal(tt.numpy(), lg.argmax(-1))


@pytest.mark.parametrize("V", [40, 1000])
def test_masks_equal_jax(V):
    """Top-k and top-p keep the same tokens as the JAX masks on the scaled
    logits. Top-p's cumulative sum may round otherwise in torch than in
    XLA: a row whose cumulative mass at the boundary token lies within 1e-6
    of top_p is excused (and counted; none in these draws)."""
    lg, temp, top_k, top_p, _ = _batch(V, 5)
    scaled = lg / np.maximum(temp, 1e-6)[:, None]
    jk = np.asarray(JS._mask_top_k(jnp.asarray(scaled), jnp.asarray(top_k)))
    jp = np.asarray(JS._mask_top_p(jnp.asarray(jk), jnp.asarray(top_p)))
    st = torch.from_numpy(scaled)
    cut = torch.full((len(lg),), float("-inf"))
    cut_k = TS._mask_top_k(st, torch.from_numpy(top_k), cut)
    masked = torch.where(st >= cut_k[:, None], st, float("-inf"))
    np.testing.assert_array_equal(np.isfinite(masked.numpy()),
                                  np.isfinite(jk))
    cut_p = torch.maximum(cut_k, TS._mask_top_p(
        masked, torch.from_numpy(top_p), cut_k))
    keep = (st >= cut_p[:, None]).numpy()
    excused = 0
    for r in range(len(lg)):
        if (keep[r] == np.isfinite(jp[r])).all():
            continue
        row = np.sort(jk[r])[::-1].astype(np.float64)
        p = np.exp(row - row.max())
        cum = np.cumsum(p / p.sum())
        assert np.abs(cum - top_p[r]).min() < 1e-6, f"row {r} differs"
        excused += 1
    assert excused == 0


def _fsm_tables(compile_fn, machine_fn, runtime_cls, pattern, vocab, eos, V):
    m, _ = machine_fn(pattern, vocab)
    fsm = compile_fn(m, eos, V, 256)
    rt = runtime_cls(V, 64)
    seg = rt.acquire((pattern, tuple(eos)), fsm)
    return rt, seg


VOCAB = ["", "a", "b", "ab", "{", "}", '"', ":", "1", "2", ",", " ", "x",
         "ba", "12", "yes", "no"]


@pytest.mark.parametrize("pattern", [r"(ab|ba)+", r"(yes|no)", r"\{\"a\":[12]+\}"])
def test_sample_masked_equal_jax(pattern):
    """Tokens, logprobs and next states of the FSM-masked draw equal JAX's,
    on the tables of both compilers (which are equal)."""
    V = 24  # logits wider than the vocabulary, as a padded head is
    eos = [0]
    jrt, jseg = _fsm_tables(jax_compile_fsm, jax_get_machine, JaxRuntime,
                            pattern, VOCAB, eos, V)
    trt, tseg = _fsm_tables(compile_fsm, get_machine, StructuredRuntime,
                            pattern, VOCAB, eos, V)
    np.testing.assert_array_equal(trt._mask_np.view(np.int32),
                                  jrt._mask_np.view(np.int32))
    np.testing.assert_array_equal(trt._next_np, jrt._next_np)
    rng = np.random.default_rng(11)
    B = 6
    lg = rng.standard_normal((B, V)).astype(np.float32)
    temp = np.asarray([0.0, 0.8, 1.0, 0.0, 1.3, 0.6], np.float32)
    top_k = np.asarray([0, 0, 3, 0, 0, 2], np.int32)
    top_p = np.asarray([1.0, 0.9, 1.0, 1.0, 1.0, 1.0], np.float32)
    keys = JS.make_keys(rng.integers(0, 2**31, B), rng.integers(0, 99, B))
    # rows 0 and 4 free, the rest somewhere in the machine
    states = np.asarray([0, jseg.offset + 1, jseg.offset + 1, jseg.offset,
                         0, jseg.offset + min(2, jseg.size - 1)], np.int32)
    mask_j, next_j = jrt.device_tables()
    jt, jl, js = JS.sample_masked_jit(jnp.asarray(lg), temp, top_k, top_p,
                                      keys, jnp.asarray(states), mask_j,
                                      next_j)
    mask_t, next_t = trt.device_tables()
    tt, tl, ts = TS.sample_masked(torch.from_numpy(lg), temp, top_k, top_p,
                                  keys, torch.from_numpy(states), mask_t,
                                  next_t)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("V,masked", [(1000, False), (40, True)])
def test_topk_logprobs_equal_jax(V, masked):
    """Ids equal, values within 1e-6; a row masked to three tokens ties
    the rest of its top 20 at the fill, ordered by id as lax.top_k
    orders them."""
    rng = np.random.default_rng(3)
    lg = rng.standard_normal((4, V)).astype(np.float32)
    if masked:
        lg[1, :] = TS.FSM_MASK_FILL
        lg[1, [5, 9, 30]] = [0.5, 1.5, -0.2]
    toks = lg.argmax(-1).astype(np.int32)
    ji, jv, js = JS.make_topk_logprobs_fn(20)(jnp.asarray(lg),
                                              jnp.asarray(toks))
    ti, tv, ts = TS.topk_logprobs(torch.from_numpy(lg),
                                  torch.from_numpy(toks).long(), 20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)


def test_pack_rows_round_trip():
    temp = np.asarray([0.0, 0.7], np.float32)
    keys = JS.make_keys([2**31 - 1, 5], [2**32 - 1, 0])
    rows = torch.from_numpy(TS.pack_rows(temp, [0, 5], [1.0, 0.9], keys))
    t, k, p, seed, step = TS._device_rows(rows)
    assert t.tolist() == pytest.approx([0.0, 0.7])
    assert k.tolist() == [0, 5] and p.tolist() == pytest.approx([1.0, 0.9])
    assert (seed.numpy().view(np.uint32).tolist()
            == [2**31 - 1, 5])
    assert step.numpy().view(np.uint32).tolist() == [2**32 - 1, 0]


def test_known_answers_of_the_smoke_script_are_jax_random():
    """chip_smoke.py holds the card's known answers itself (no JAX there);
    recompute them with jax.random so they cannot go stale."""
    import chip_smoke

    ka = chip_smoke.SAMPLE_KNOWN
    for (seed, step), words in ka["bits"].items():
        got = np.asarray(jax.random.bits(_jax_key(seed, step),
                                         (len(words),), jnp.uint32))
        assert got.tolist() == words
    for (seed, step), us in ka["uniform"].items():
        got = np.asarray(jax.random.uniform(_jax_key(seed, step),
                                            (len(us),)))
        assert got.view(np.int32).tolist() == us
    lg, temp, keys = chip_smoke.known_draw_inputs()
    toks = JS.sample_jit(jnp.asarray(lg), temp,
                         np.zeros(len(temp), np.int32),
                         np.ones(len(temp), np.float32), keys)[0]
    assert np.asarray(toks).tolist() == ka["tokens"]

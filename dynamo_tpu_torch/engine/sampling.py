"""On-device sampling: greedy, temperature, top-k, top-p and seeded draws
with per-row parameters, the FSM mask of structured decoding, and the
top logprobs. The port of ``dynamo_tpu/engine/sampling.py``.

Only B token ids and B logprobs (plus B·k top logprobs when asked) cross
to the host per step, never the logits. A row's draw depends on its own
key (seed, step) alone, never on the batch around it, and is bit for bit
``jax.random.categorical``'s (``ops/sample.py``, the Gumbel draw kernel).

The JAX package gates its expensive branches with ``lax.cond`` on the
device. The port gates them on the host copies of temperature, top_k and
top_p, which the caller knows before the launch, so nothing here reads a
device value: an all-greedy batch costs one argmax and one
``log_softmax``, as before sampling was ported.
"""

from __future__ import annotations

import numpy as np
import torch

from dynamo_tpu_torch.ops.sample import gumbel_argmax

#: static cap for top-k masking (rows with top_k <= 0 or > cap are
#: unrestricted)
TOP_K_CAP = 64
#: the fill of masked-out tokens on both guided paths (host edits and the
#: device FSM mask): NOT -inf, so the two give the same streams
FSM_MASK_FILL = -1e30


def pack_rows(temperature, top_k, top_p, keys) -> np.ndarray:
    """The per-row sampling operands as one int32 [5, B] array (float32
    and uint32 values by their bits): temperature, top_k, top_p, seed and
    step. It joins a step's other int32 operands in one staged copy."""
    B = len(temperature)
    out = np.empty((5, B), np.int32)
    out[0] = np.asarray(temperature, np.float32).view(np.int32)
    out[1] = np.asarray(top_k, np.int32)
    out[2] = np.asarray(top_p, np.float32).view(np.int32)
    out[3:5] = np.asarray(keys, np.uint32).reshape(B, 2).T.view(np.int32)
    return out


def _device_rows(rows):
    """(temperature f32, top_k i32, top_p f32, seed, step) views of a
    device [5, B] int32 tensor made by :func:`pack_rows`."""
    return (rows[0].view(torch.float32), rows[1], rows[2].view(torch.float32),
            rows[3], rows[4])


def _mask_top_k(logits, top_k, cut):
    """The row's top-k threshold (k per row, capped at TOP_K_CAP; the cap
    clamps to the vocabulary for toy models smaller than it), where the
    row asks for one; -inf elsewhere."""
    cap = min(TOP_K_CAP, logits.shape[-1])
    vals = torch.topk(logits, cap, dim=-1).values  # [B, cap] descending
    k = top_k.long().clamp(1, cap)
    kth = vals.gather(1, (k - 1)[:, None])[:, 0]
    use = (top_k > 0) & (top_k <= cap)
    return torch.where(use, kth, cut)


def _mask_top_p(logits, top_p, cut):
    """Nucleus: the smallest kept logit of the shortest prefix of sorted
    probabilities with mass >= top_p, where the row asks for one."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep positions whose cumulative mass *before* them is < top_p
    keep = (cum - probs) < top_p[:, None]
    thresh = torch.where(keep, sorted_logits, float("inf")).amin(-1)
    use = (top_p > 0.0) & (top_p < 1.0)
    return torch.where(use, thresh, cut)


def branches(temperature, top_k, top_p, V: int) -> tuple:
    """(draw, top-k, top-p): the branches :func:`sample` runs for these
    host arrays over a vocabulary of V. A captured sampler is keyed by
    them, with its rows."""
    temperature = np.asarray(temperature, np.float32)
    top_k = np.asarray(top_k, np.int32)
    top_p = np.asarray(top_p, np.float32)
    if not (temperature > 0.0).any():
        return False, False, False
    use_k = (top_k > 0) & (top_k <= min(TOP_K_CAP, V))
    use_p = (top_p > 0.0) & (top_p < 1.0)
    return True, bool(use_k.any()), bool(use_p.any())


def sample(logits, temperature, top_k, top_p, keys, rows=None):
    """One token per row.

    Args:
      logits: [B, V] float32 on the device.
      temperature: [B] (0 = greedy), top_k: [B] (0 = off), top_p: [B] (0
        or 1 = off): host arrays, which decide which branches run.
      keys: [B, 2] uint32 host array of (seed, step), :func:`make_keys`
        (unread when ``rows`` is given).
      rows: the same operands on the device as :func:`pack_rows` lays them
        out, when the caller staged them (a burst steps its keys there);
        None = copied here.
    Returns (tokens [B] int64, logprob of each token [B] float32), the
    logprob from ``log_softmax`` of the unscaled ``logits``; greedy ties
    take the lowest token id, as ``jnp.argmax`` does.
    """
    tokens = logits.argmax(dim=-1)
    draw, use_k, use_p = branches(temperature, top_k, top_p,
                                  logits.shape[-1])
    if draw:
        if rows is None:
            rows = torch.from_numpy(pack_rows(temperature, top_k, top_p,
                                              keys)).to(logits.device)
        temp_raw, top_k_d, top_p_d, seed_d, step_d = _device_rows(rows)
        temp_d = temp_raw.clamp_min(1e-6)
        cut = torch.full_like(temp_d, float("-inf"))
        if use_k or use_p:
            scaled = logits / temp_d[:, None]
            if use_k:
                cut = _mask_top_k(scaled, top_k_d, cut)
            if use_p:
                # top-p reads the top-k-masked logits
                masked = torch.where(scaled >= cut[:, None], scaled,
                                     float("-inf"))
                cut = torch.maximum(cut, _mask_top_p(masked, top_p_d, cut))
        drawn = gumbel_argmax(logits.contiguous(), temp_d.contiguous(),
                              cut, seed_d.contiguous(), step_d.contiguous())
        tokens = torch.where(temp_raw <= 0.0, tokens, drawn)
    logp = torch.log_softmax(logits, dim=-1).gather(1, tokens[:, None])[:, 0]
    return tokens, logp


# ------------------------------------------------- structured decoding FSM


def apply_fsm_mask(logits, states, mask_table):
    """Mask each row to its FSM state's allowed tokens.

    ``states`` [B] int32 indexes ``mask_table`` [S, ceil(V/32)] int32 (the
    uint32 words' bits), the structured runtime's packed bitmask arena.
    State 0 is the FREE row, all allowed: an exact identity for
    unconstrained rows."""
    return apply_mask_words(logits, mask_table[states.long()])


def apply_mask_words(logits, words):
    """Mask each row of ``logits`` [N, V] to the tokens whose bit is set
    in its packed mask words [N, ceil(V/32)] int32 (uint32 bits; token t is
    bit t % 32 of word t // 32); masked tokens take ``FSM_MASK_FILL``."""
    V = logits.shape[-1]
    ids = torch.arange(V, device=logits.device)
    bits = (words[:, ids // 32] >> (ids % 32).to(words.dtype)) & 1
    return torch.where(bits.bool(), logits, FSM_MASK_FILL)


def sample_masked(logits, temperature, top_k, top_p, keys, states,
                  mask_table, next_table, rows=None):
    """FSM-constrained sampling: mask, sample and advance on the device.
    Returns (tokens [B], logps [B], next states ``next_table[state,
    token]`` [B] int32), the states fed device to device by the pipelined
    decode loop as the token column is."""
    lg = apply_fsm_mask(logits, states, mask_table)
    toks, logps = sample(lg, temperature, top_k, top_p, keys, rows)
    new_states = next_table[states.long(), toks]
    return toks, logps, new_states


def make_keys(seeds, steps) -> np.ndarray:
    """Per-row threefry key data from (seed, step): [B, 2] uint32, the raw
    pair with no fold-in, as the JAX package makes them."""
    out = np.zeros((len(seeds), 2), dtype=np.uint32)
    for i, (s, st) in enumerate(zip(seeds, steps)):
        out[i, 0] = int(s) & 0xFFFFFFFF
        out[i, 1] = int(st) & 0xFFFFFFFF
    return out


def topk_logprobs(logits, toks, k: int = 20):
    """(top ids [B, k], top logprobs [B, k], selected logprob [B]) from ONE
    ``log_softmax``, so the selected value and its own top entry never
    differ by an ulp. Ties order by the lower id first, as ``lax.top_k``
    orders them (a stable sort: masked rows tie at the fill)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    k = min(k, logits.shape[-1])
    vals, ids = torch.sort(lp, dim=-1, descending=True, stable=True)
    sel = lp.gather(1, toks[:, None].long())[:, 0]
    return ids[:, :k], vals[:, :k], sel

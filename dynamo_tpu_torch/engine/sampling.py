"""Greedy sampling on the device: the argmax token of each row and its
log-probability, so only B ids and B floats cross to the host per step.
Ties pick the lowest token id, as ``jnp.argmax`` does. Temperature, top-k/p
and seeded draws are not ported yet (ROADMAP A6)."""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor):
    """logits [B, V] f32 → (tokens [B] int64, logprob of each token [B])."""
    tokens = logits.argmax(dim=-1)
    logp = torch.log_softmax(logits, dim=-1).gather(
        1, tokens[:, None])[:, 0]
    return tokens, logp

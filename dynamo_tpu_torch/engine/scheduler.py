"""Continuous batching scheduler: admission, chunked prefill, decode batching.

The port's copy of ``dynamo_tpu/engine/scheduler.py``. Pure host logic: it
must make the same plans as the JAX package's scheduler whenever swap
copies are ready at the same steps, or the two engines' streams diverge.
Disaggregated serving is in: a prefill sequence can hold its blocks past
its finish (``hold_blocks``) and report each committed chunk
(``progress_cb``), and a decode engine admits a sequence whose prompt KV
was computed elsewhere (``add_prefilled``).

- A sequence's lifecycle: waiting → running (prefill chunks → decode
  steps) → finished, with a ``swapped`` station between waiting and
  running: a preempted victim whose KV the ``swapper`` (the engine) staged
  in host memory parks there and re-enters ``running`` at its old progress
  once blocks free up. Only when the host budget is exhausted, or a copy
  failed, does a victim fall back to release-and-recompute.
- KVBM onboarding: prompt blocks the device pool misses but the host tier
  holds come back through ``onboard_cb`` as fresh device blocks that
  extend the prefix hit.
- ``num_computed`` counts tokens whose KV is in the paged cache;
  ``remaining == 1`` means the next step is a decode, ``remaining > 1`` a
  prefill chunk (which also samples iff it reaches the end).
- Prefix-cache admission matches full prompt blocks against the BlockPool
  by chained sequence hash (dynamo_tpu_torch/tokens.py).
- KV events: filled blocks are registered and reported stored; pool
  eviction reports removed.
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional

from dynamo_tpu_torch.engine.cache import BlockPool
from dynamo_tpu_torch.engine.config import RAGGED_MAX_CHUNKS, EngineArgs
from dynamo_tpu_torch.protocols import (
    FinishReason, LLMEngineOutput, PreprocessedRequest,
)
from dynamo_tpu_torch.qos import CLASS_RANK, DEFAULT_TENANT, normalize_priority
from dynamo_tpu_torch.qos.fair import ClassQueues, QosBook
from dynamo_tpu_torch.router.protocols import StoredBlock
from dynamo_tpu_torch.tokens import KV_HASH_SEED, TokenBlockSequence

logger = logging.getLogger("dynamo_torch.engine.scheduler")

#: starvation guard of the swapped queue: a swap-in candidate whose block
#: reservation fails this many consecutive passes is re-parked behind its
#: peers (swap_in_blocked_total counts it), so a large head-of-line
#: sequence cannot block smaller resumable ones forever
SWAP_IN_SKIP_AFTER = 3


@dataclass
class SeqState:
    request_id: str
    req: PreprocessedRequest
    ctx: object  # runtime Context (has .cancelled)
    sink: object  # asyncio.Queue for outputs (owned by engine)
    tokens: list[int] = field(default_factory=list)  # prompt + generated
    prompt_len: int = 0
    hashes: TokenBlockSequence = None
    block_table: list[int] = field(default_factory=list)
    num_computed: int = 0  # tokens whose KV is resident
    num_registered_blocks: int = 0  # blocks already registered/evented
    generated: int = 0
    #: sampling step of the PRNG key (seed, step): the absolute token
    #: position, so a seeded stream draws the same keys after migration
    #: or recompute preemption as an unbroken run does
    step_idx: int = 0
    #: the key seed of a request that gave none, drawn at admission
    unseeded_seed: int = 0
    finished: Optional[str] = None
    #: sampling penalties: incrementally-folded token history (the
    #: engine's logit edits) — ``gen_counts`` counts GENERATED tokens
    #: (presence/frequency), ``seen_tokens`` is distinct prompt+generated
    #: (repetition), ``pen_indexed`` the fold watermark into ``tokens``
    gen_counts: dict = field(default_factory=dict)
    seen_tokens: set = field(default_factory=set)
    pen_indexed: int = 0
    #: guided decoding cursor (llm/guided.GuidedState on the host oracle,
    #: structured.FsmCursor on the device path), attached by the engine
    guided_state: object = None
    #: per-request KV-event batching: stored blocks accumulated across
    #: prefill chunks, flushed as ONE chained event when the prompt
    #: completes (or at finish/preemption)
    pending_stored: list = field(default_factory=list)
    pending_stored_ids: list = field(default_factory=list)
    pending_parent: object = None
    #: QoS: tenant id + class copied off the Context at add() time
    tenant: str = DEFAULT_TENANT
    priority: str = "standard"
    qos_enqueue_t: float = 0.0
    qos_arrival: Optional[int] = None
    #: disagg: keep the KV blocks past finish (the owner gathers them,
    #: then releases them)
    hold_blocks: bool = False
    #: disagg pipelining: called with num_computed after each prefill
    #: chunk commits, so the owner ships finished blocks while later
    #: chunks run
    progress_cb: Optional[Callable] = None
    #: the owner vanished (``Scheduler.abort``): reaped at the next plan
    aborted: bool = False
    #: prompt-lookup drafting index (engine ``_draft_tokens``): n-gram →
    #: END position of its newest occurrence, extended incrementally up to
    #: ``ngram_indexed``
    ngram_pos: dict = field(default_factory=dict)
    ngram_indexed: int = 0
    #: preempt-to-swap: the engine's swap entry while this sequence's KV
    #: lives in host memory (None = not swapped)
    swap: object = None
    preemptions: int = 0
    swap_in_attempts: int = 0  # consecutive failed swap-in reservations
    parked_t: float = 0.0  # when the sequence entered the swapped queue

    @property
    def remaining(self) -> int:
        return len(self.tokens) - self.num_computed

    def sampling_tuple(self):
        s = self.req.sampling_options
        return (
            float(s.temperature if s.temperature is not None else 0.0),
            int(s.top_k if s.top_k else 0),
            float(s.top_p if s.top_p is not None else 1.0),
            s.seed,  # None = unseeded (seed=0 is a valid pinned seed)
        )


@dataclass
class PrefillWork:
    seq: SeqState
    start: int
    chunk: int  # number of tokens to compute this step
    sample: bool  # True when the chunk reaches the end of tokens


@dataclass
class StepPlan:
    prefill: list[PrefillWork] = field(default_factory=list)
    decode: list[SeqState] = field(default_factory=list)

    @property
    def empty(self) -> bool:
        return not self.prefill and not self.decode


class Scheduler:
    """Plans one engine iteration; owns admission/preemption/bookkeeping."""

    def __init__(self, args: EngineArgs, pool: BlockPool,
                 on_stored: Optional[Callable] = None,
                 onboard_cb: Optional[Callable] = None,
                 swapper: Optional[object] = None):
        self.args = args
        self.pool = pool
        self.on_stored = on_stored  # fn(parent_hash, [StoredBlock], [block_id])
        #: fn(probe: TokenBlockSequence, start_block, end_block) ->
        #: [block_id]: the KVBM onboarding hook; device misses found in the
        #: host tier come back as fresh device blocks extending the hit
        self.onboard_cb = onboard_cb
        #: the preempt-to-swap backend (the engine): swap_out(seq) -> bool,
        #: swap_status(seq) -> "ready" | "pending" | "failed",
        #: swap_in(seq) -> bool, swap_drop(seq). None = recompute only
        self.swapper = swapper
        self.qos = QosBook(args.qos)
        self.waiting: ClassQueues = ClassQueues(
            self.qos, fifo=not args.qos_scheduling)
        self.running: list[SeqState] = []
        #: swapped-out victims, between waiting and running: the swap-in
        #: pass runs before admission, so a resumed sequence takes its old
        #: place ahead of fresh prompts. Best class first (aged ones jump
        #: the order), FIFO within a class; plain FIFO without QoS
        self.swapped: deque[SeqState] = deque()
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0
        #: one KV stored event per REQUEST unless per-chunk publishing
        #: was explicitly requested
        self._batch_events = not args.kv_event_per_chunk
        #: preemptions by kind, sequences swapped back in, the tokens
        #: recompute preemptions threw away (each re-prefilled), and the
        #: starvation guard's re-parks
        self.preempt_swap_total = 0
        self.preempt_recompute_total = 0
        self.swap_in_total = 0
        self.recomputed_tokens_total = 0
        self.swap_in_blocked_total = 0

    # -- api ----------------------------------------------------------------

    def _stamp_qos(self, seq: SeqState) -> None:
        seq.tenant = str(getattr(seq.ctx, "tenant", None) or DEFAULT_TENANT)
        seq.priority = normalize_priority(
            getattr(seq.ctx, "priority", None), warn=False)
        self.qos.enter(seq)

    def _new_hashes(self) -> TokenBlockSequence:
        return TokenBlockSequence(block_size=self.args.block_size,
                                  salt_hash=KV_HASH_SEED)

    def add(self, seq: SeqState) -> None:
        seq.tokens = list(seq.req.token_ids)
        seq.prompt_len = len(seq.tokens)
        # PRNG step = ABSOLUTE token position (see SeqState.step_idx)
        seq.step_idx = seq.prompt_len
        seq.hashes = self._new_hashes()
        self._stamp_qos(seq)
        seq.qos_enqueue_t = time.monotonic()
        self.waiting.append(seq)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running or self.swapped)

    def num_waiting(self) -> int:
        return len(self.waiting)

    def plan(self) -> StepPlan:
        """Admission + prefill chunks + the decode batch, under one token
        budget (the step is ONE packed launch)."""
        self._reap_cancelled()
        self._swap_in_pass()
        self._admit()
        plan = StepPlan()

        budget = self.args.max_num_batched_tokens
        max_b = min(self.args.max_num_seqs, self.args.decode_batch_buckets[-1])
        decode_seqs = [s for s in self.running if s.remaining == 1]
        if self.args.qos_scheduling:
            # class-ordered work within the step; stable within a class
            order = {id(s): i for i, s in enumerate(self.running)}
            by_class = lambda s: (CLASS_RANK.get(s.priority, 1),  # noqa: E731
                                  order[id(s)])
            decode_seqs.sort(key=by_class)

        # each decode seq needs a block for its last position; preempt on
        # allocation failure. _preempt_for may evict a seq already planned,
        # so membership in self.running is re-checked.
        ready_decode = []
        for s in decode_seqs:
            if s not in self.running:
                continue
            if self._ensure_blocks(s, s.num_computed + 1):
                ready_decode.append(s)
            else:
                if not self._preempt_for(s):
                    self._preempt(s)
        row_cap = min(max_b, budget)
        still_ready = [s for s in ready_decode if s in self.running]
        plan.decode = still_ready[:row_cap]
        budget -= len(plan.decode)

        if self.args.enable_chunked_prefill or not plan.decode:
            prefill_seqs = [s for s in self.running if s.remaining > 1]
            if self.args.qos_scheduling:
                prefill_seqs.sort(key=by_class)
            cap = self.args.max_num_batched_tokens
            for s in prefill_seqs:
                if s not in self.running:
                    continue
                chunk = min(s.remaining, max(0, budget), cap)
                if not self.args.enable_chunked_prefill and chunk < s.remaining:
                    if s.remaining > cap:
                        # can never fit in one unchunked step: fail it
                        self.finish(s, FinishReason.ERROR)
                        s.sink.put_nowait(LLMEngineOutput(
                            finish_reason=FinishReason.ERROR,
                            text="prompt exceeds max_num_batched_tokens "
                                 "and chunked prefill is disabled"))
                        s.sink.put_nowait(None)
                    continue
                prefill_cap = min(max_b, RAGGED_MAX_CHUNKS)
                if chunk <= 0 or len(plan.prefill) >= prefill_cap:
                    break
                protected = plan.decode + [w.seq for w in plan.prefill]
                if not self._ensure_blocks(s, s.num_computed + chunk):
                    # preempt, but never a seq this step is about to index
                    if not self._preempt_for(s, exclude=protected):
                        break
                    if not self._ensure_blocks(s, s.num_computed + chunk):
                        break
                plan.prefill.append(PrefillWork(
                    seq=s, start=s.num_computed, chunk=chunk,
                    sample=(s.num_computed + chunk == len(s.tokens)),
                ))
                budget -= chunk
        return plan

    # -- post-step bookkeeping ----------------------------------------------

    def commit_computed(self, seq: SeqState, new_num_computed: int,
                        charge: bool = True) -> None:
        """Advance num_computed; hash/register/event newly-filled blocks.
        Stored events batch per request: chunks of a long prompt publish
        as one chained event when the prompt completes. ``charge=False``
        attaches KV computed (and charged) elsewhere."""
        old = seq.num_computed
        seq.num_computed = new_num_computed
        if charge:
            self.qos.charge(seq.tenant, seq.priority, new_num_computed - old)
        seq.hashes.extend(seq.tokens[len(seq.hashes): new_num_computed])
        bs = self.args.block_size
        full = new_num_computed // bs
        stored: list[StoredBlock] = []
        stored_ids: list[int] = []
        parent = None
        for i in range(seq.num_registered_blocks, full):
            blk = seq.hashes.blocks[i]
            bid = seq.block_table[i]
            fresh = self.pool.register(bid, blk.sequence_hash)
            if fresh:
                if not stored:
                    parent = blk.parent_sequence_hash
                stored.append(StoredBlock(block_hash=blk.sequence_hash,
                                          tokens_hash=blk.block_hash))
                stored_ids.append(bid)
        seq.num_registered_blocks = full
        if not self.on_stored:
            return
        if self._batch_events and new_num_computed < seq.prompt_len:
            # mid-prompt chunk: park the delta until the prompt completes
            if stored:
                if not seq.pending_stored:
                    seq.pending_parent = parent
                seq.pending_stored.extend(stored)
                seq.pending_stored_ids.extend(stored_ids)
            return
        if seq.pending_stored:
            stored = seq.pending_stored + stored
            stored_ids = seq.pending_stored_ids + stored_ids
            parent = seq.pending_parent
            seq.pending_stored, seq.pending_stored_ids = [], []
            seq.pending_parent = None
        if stored:
            self.on_stored(parent, stored, stored_ids)

    def _flush_stored(self, seq: SeqState) -> None:
        """Publish batched-but-unflushed stored blocks (before release)."""
        if seq.pending_stored and self.on_stored:
            self.on_stored(seq.pending_parent, seq.pending_stored,
                           seq.pending_stored_ids)
        seq.pending_stored, seq.pending_stored_ids = [], []
        seq.pending_parent = None

    def append_token(self, seq: SeqState, token: int) -> None:
        seq.tokens.append(token)
        seq.generated += 1
        seq.step_idx += 1

    def check_finish(self, seq: SeqState, token: int) -> Optional[str]:
        sc = seq.req.stop_conditions
        if not sc.ignore_eos and token in (seq.req.eos_token_ids or []):
            if (sc.min_tokens or 0) < seq.generated:
                return FinishReason.EOS
        gs = seq.guided_state
        if gs is not None and (gs.done or gs.exhausted):
            # the constraint completed (or hit a token-level dead end):
            # stop even without EOS ids or with ignore_eos. min_tokens
            # delays only the DONE stop; an exhausted machine has every
            # next token masked, so it stops regardless
            if gs.exhausted or (sc.min_tokens or 0) <= seq.generated:
                return FinishReason.STOP
        if sc.max_tokens is not None and seq.generated >= sc.max_tokens:
            return FinishReason.LENGTH
        if seq.num_computed + 1 >= self.args.max_model_len:
            return FinishReason.LENGTH
        return None

    def finish(self, seq: SeqState, reason: str) -> None:
        seq.finished = reason
        self.qos.leave(seq)
        if seq.guided_state is not None:
            # drop the sequence's device-FSM arena reference so idle
            # constraint tables become evictable (the host oracle has no
            # release)
            rel = getattr(seq.guided_state, "release", None)
            if rel is not None:
                rel()
        self._flush_stored(seq)
        if seq in self.running:
            self.running.remove(seq)
        if seq.swap is not None and self.swapper is not None:
            self.swapper.swap_drop(seq)
        if not seq.hold_blocks:
            self.pool.release(seq.block_table)
            seq.block_table = []

    def release_held(self, seq: SeqState) -> None:
        """Free the blocks of a finished hold_blocks sequence."""
        self.pool.release(seq.block_table)
        seq.block_table = []

    def add_prefilled(self, seq: SeqState, block_table: list[int]) -> None:
        """Admit a sequence whose prompt KV was computed elsewhere and is
        already scattered into ``block_table``: its prompt blocks are
        hashed, registered and announced as a local prefill's would be,
        and its draws resume at the position after the prompt."""
        seq.tokens = list(seq.req.token_ids)
        self._stamp_qos(seq)
        seq.prompt_len = len(seq.tokens)
        seq.step_idx = seq.prompt_len  # position-anchored PRNG (see add())
        seq.hashes = self._new_hashes()
        seq.block_table = list(block_table)
        self.running.append(seq)
        # charge=False: the prefill worker computed (and charged) the KV
        self.commit_computed(seq, seq.prompt_len, charge=False)

    def abort(self, seq: SeqState) -> None:
        """The owner vanished (a cancelled prefill_extract): the sequence's
        blocks return to the pool whatever state it is in."""
        if seq.finished is not None:
            if seq.block_table:
                self.release_held(seq)
            return
        seq.hold_blocks = False  # the eventual finish() releases
        seq.aborted = True

    # -- internals -----------------------------------------------------------

    def _reap_cancelled(self) -> None:
        def dead(s):
            return s.aborted or getattr(s.ctx, "cancelled", False)

        def expired(s):
            return getattr(s.ctx, "expired", False)

        for s in list(self.running):
            if dead(s):
                self.finish(s, FinishReason.CANCELLED)
                s.sink.put_nowait(None)
            elif expired(s):
                self.finish(s, FinishReason.DEADLINE)
                s.sink.put_nowait(LLMEngineOutput(
                    finish_reason=FinishReason.DEADLINE))
        for s in list(self.waiting):
            if dead(s) or expired(s):
                self.waiting.remove(s)
                self.qos.leave(s)
                if dead(s):
                    s.finished = FinishReason.CANCELLED
                    s.sink.put_nowait(None)
                else:
                    s.finished = FinishReason.DEADLINE
                    s.sink.put_nowait(LLMEngineOutput(
                        finish_reason=FinishReason.DEADLINE))
        for s in list(self.swapped):
            # a swapped sequence holds no device blocks, only a host
            # bundle and its reservation: drop both
            if dead(s) or expired(s):
                self.swapped.remove(s)
                self.qos.leave(s)
                if self.swapper is not None:
                    self.swapper.swap_drop(s)
                if dead(s):
                    s.finished = FinishReason.CANCELLED
                    s.sink.put_nowait(None)
                else:
                    s.finished = FinishReason.DEADLINE
                    s.sink.put_nowait(LLMEngineOutput(
                        finish_reason=FinishReason.DEADLINE))

    def _swap_in_candidate(self, exclude: frozenset = frozenset()
                           ) -> SeqState:
        """The next swapped sequence to resume: aged ones first (the
        oldest parked), then the best class, then FIFO by park time; plain
        FIFO without QoS scheduling. ``exclude`` holds the ids re-parked
        this pass, so that a sole best-class candidate is not picked again
        straight after its own skip-ahead."""
        if not self.args.qos_scheduling:
            return self.swapped[0]
        pool = [s for s in self.swapped if id(s) not in exclude] \
            or list(self.swapped)
        now = time.monotonic()
        aging = self.qos.cfg.aging_s
        if aging > 0:
            aged = [s for s in pool if now - s.parked_t >= aging]
            if aged:
                return min(aged, key=lambda s: s.parked_t)
        return min(pool,
                   key=lambda s: (CLASS_RANK.get(s.priority, 1), s.parked_t))

    def _swap_in_fallback(self, seq: SeqState) -> None:
        """A swap-in that cannot happen (a failed copy, a torn bundle) is
        resolved by recompute, and counted as one: the swap-out was counted
        as a swap."""
        self.preempt_recompute_total += 1
        self.recomputed_tokens_total += seq.num_computed
        self._reset_for_recompute(seq)
        seq.qos_enqueue_t = time.monotonic()
        self.waiting.appendleft(seq)

    def _swap_in_pass(self) -> None:
        """Re-activate swapped-out sequences when capacity returns, before
        admission: a resumed sequence reclaims its old place at its old
        progress. A candidate needs blocks for its whole resident prefix
        plus one token of headroom. One whose reservation fails
        ``SWAP_IN_SKIP_AFTER`` passes in a row is re-parked behind its
        peers so that smaller ones get their turn."""
        if self.swapper is None:
            return
        rotations = 0
        skipped: set = set()
        while self.swapped and len(self.running) < self.args.max_num_seqs:
            if rotations > len(self.swapped):
                break  # a full cycle without progress: wait for memory
            seq = self._swap_in_candidate(frozenset(skipped))
            st = self.swapper.swap_status(seq)
            if st == "pending":
                break  # the host copy is in flight; order kept
            if st != "ready":
                self.swapped.remove(seq)
                logger.warning("swap-in of %s unavailable (%s); falling "
                               "back to recompute", seq.request_id, st)
                self.swapper.swap_drop(seq)
                self._swap_in_fallback(seq)
                continue
            bs = self.args.block_size
            need = (seq.num_computed + bs) // bs  # ceil((computed + 1) / bs)
            free_after = self.pool.num_free_blocks - need
            watermarked = (self.running and self.pool.num_free_blocks - need
                           < self.args.watermark * self.pool.num_blocks)
            if free_after < 0 or watermarked:
                seq.swap_in_attempts += 1
                if (len(self.swapped) > 1
                        and seq.swap_in_attempts >= SWAP_IN_SKIP_AFTER):
                    seq.swap_in_attempts = 0
                    seq.parked_t = time.monotonic()  # back of its class
                    self.swapped.remove(seq)  # and of the FIFO order
                    self.swapped.append(seq)
                    skipped.add(id(seq))
                    self.swap_in_blocked_total += 1
                    rotations += 1
                    logger.info("swap-in of %s blocked (needs %d blocks, "
                                "%d free); skipping ahead", seq.request_id,
                                need, self.pool.num_free_blocks)
                    continue
                break  # wait, don't thrash
            self.swapped.remove(seq)
            if not self._ensure_blocks(seq, seq.num_computed + 1):
                seq.swap_in_attempts += 1
                self.swapped.appendleft(seq)
                break
            seq.swap_in_attempts = 0
            if not self.swapper.swap_in(seq):
                self.pool.release(seq.block_table)
                seq.block_table = []
                self._swap_in_fallback(seq)
                continue
            self.swap_in_total += 1
            # its old place: ahead of every later admission, and reached
            # last by the newest-first victim order
            self.running.insert(0, seq)

    def _make_room_for(self, seq: SeqState) -> bool:
        """Admission-time priority preemption: evict one running sequence
        of a strictly worse class; False = no eligible victim."""
        if not self.args.qos_scheduling:
            return False
        rank = CLASS_RANK.get(seq.priority, 1)
        for victim in self._victim_order(seq):
            if CLASS_RANK.get(victim.priority, 1) <= rank:
                continue
            self._preempt(victim)
            return True
        return False

    def _admit(self) -> None:
        bs = self.args.block_size
        now = time.monotonic()
        while self.waiting:
            seq = self.waiting.pick(now)
            while len(self.running) >= self.args.max_num_seqs:
                if not self._make_room_for(seq):
                    return
            # watermark: keep a fraction of blocks free
            needed_first = max(1, min(len(seq.tokens), bs) // bs + 1)
            while (self.pool.num_free_blocks < needed_first
                   or (self.running and self.pool.num_free_blocks
                       < self.args.watermark * self.pool.num_blocks)):
                if not self._make_room_for(seq):
                    return
            self.waiting.remove(seq)
            if seq.num_computed == 0 and not seq.block_table:
                self._prefix_match(seq)
            self.running.append(seq)

    def _prefix_match(self, seq: SeqState) -> None:
        self.prefix_query_tokens += seq.prompt_len
        if not self.args.enable_prefix_caching:
            return
        bs = self.args.block_size
        # match only full prompt blocks, and never the whole prompt — at
        # least one token must be computed to produce logits
        matchable = (seq.prompt_len - 1) // bs
        if matchable <= 0:
            return
        probe = TokenBlockSequence.from_tokens(
            seq.tokens[: matchable * bs], bs, KV_HASH_SEED)
        hit_blocks = self.pool.match_prefix(probe.sequence_hashes())
        if self.onboard_cb is not None and len(hit_blocks) < matchable:
            hit_blocks = hit_blocks + self.onboard_cb(
                probe, len(hit_blocks), matchable)
        if not hit_blocks:
            return
        n = len(hit_blocks)
        seq.block_table = list(hit_blocks)
        seq.num_computed = n * bs
        seq.num_registered_blocks = n
        seq.hashes.extend(seq.tokens[: n * bs])
        self.prefix_hit_tokens += n * bs

    def _ensure_blocks(self, seq: SeqState, target_tokens: int) -> bool:
        bs = self.args.block_size
        need = (target_tokens + bs - 1) // bs - len(seq.block_table)
        if need <= 0:
            return True
        got = self.pool.allocate(need)
        if got is None:
            return False
        seq.block_table.extend(got)
        return True

    def _preempt_for(self, needy: SeqState, exclude=()) -> bool:
        """Preempt another running seq to free memory; True if any. A
        victim of a better class than ``needy`` is never taken; ``exclude``
        protects sequences already planned into this step."""
        for victim in self._victim_order(needy):
            if victim is needy or any(victim is e for e in exclude):
                continue
            self._preempt(victim)
            return True
        return False

    def _victim_order(self, needy: SeqState) -> list[SeqState]:
        if not self.args.qos_scheduling:
            return list(reversed(self.running))
        needy_rank = CLASS_RANK.get(needy.priority, 1)
        idx = {id(s): i for i, s in enumerate(self.running)}
        candidates = [s for s in self.running
                      if CLASS_RANK.get(s.priority, 1) >= needy_rank]
        return sorted(
            candidates,
            key=lambda s: (CLASS_RANK.get(s.priority, 1),
                           self.qos.vt_of(s.tenant), idx[id(s)]),
            reverse=True)

    def _preempt(self, seq: SeqState) -> None:
        """Evict a victim to free its blocks: swap its pages to host memory
        when the swapper accepts (budget left), else release and recompute.
        Either way its device blocks return to the pool in this plan: the
        swap's gather is enqueued before the release, so it reads the pages
        before any later step reuses them."""
        self._flush_stored(seq)  # blocks are still resident
        if (self.swapper is not None and seq.num_computed > 0
                and seq.block_table and self.swapper.swap_out(seq)):
            logger.info("preempting request %s (swap-out, %d tokens)",
                        seq.request_id, seq.num_computed)
            self.pool.release(seq.block_table)
            seq.block_table = []
            seq.preemptions += 1
            self.preempt_swap_total += 1
            if seq in self.running:
                self.running.remove(seq)
            seq.parked_t = time.monotonic()
            seq.swap_in_attempts = 0
            self.swapped.append(seq)
            return
        if seq.num_computed > 0:
            # a victim with nothing computed discards no KV: neither a swap
            # nor a recompute preemption
            logger.warning("preempting request %s (recompute)",
                           seq.request_id)
            self.preempt_recompute_total += 1
            self.recomputed_tokens_total += seq.num_computed
        self.pool.release(seq.block_table)
        seq.block_table = []
        self._reset_for_recompute(seq)
        seq.preemptions += 1
        if seq in self.running:
            self.running.remove(seq)
        seq.qos_enqueue_t = time.monotonic()
        self.waiting.appendleft(seq)

    def _reset_for_recompute(self, seq: SeqState) -> None:
        """Zero a sequence's computed-KV bookkeeping, so that admission runs
        its prefill again from the start."""
        seq.num_computed = 0
        seq.num_registered_blocks = 0
        seq.hashes = self._new_hashes()

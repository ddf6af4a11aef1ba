"""Guided decoding: constrain sampling to a regex / JSON schema / choice set.

The port's copy of ``dynamo_tpu/llm/guided.py``, line for line in what it
computes (the port imports nothing of the JAX package): the semantic
oracle of structured decoding and its host fallback.

1. a small regex engine (subset) compiles the pattern to an NFA (Thompson
   construction) determinized LAZILY into a char-level DFA;
2. :class:`TokenMachine` lifts the char DFA to token level — for each DFA
   state it computes, once, the set of vocabulary tokens whose full text
   walks to a live state, and where each lands;
3. the engine masks every logit outside the allowed set (host edits for a
   host-oracle row, the compiled tables of ``structured/`` on the device
   otherwise) and advances the per-sequence :class:`GuidedState` with the
   sampled token.

``guided_grammar`` (EBNF) is refused loudly rather than approximated.

Regex subset: literals, ``.``, escapes (``\\d \\w \\s \\D \\W \\S`` and
escaped metachars), classes ``[...]``/``[^...]`` with ranges, groups
``(...)``, alternation ``|``, quantifiers ``* + ? {m} {m,} {m,n}``.
Anchoring is implicit (full-match), as in outlines.
"""

from __future__ import annotations

import json
import logging
import re as _pyre
from typing import Optional

_META = set("\\.[](){}|*+?^$")


# --------------------------------------------------------------- regex → NFA

class _Frag:
    """NFA fragment: start state + list of dangling (state, key) out-edges.

    States are dicts: key → list of next-state ids, where key is None
    (epsilon) or a frozenset of chars, or the sentinel ``ANY``.
    """

    def __init__(self, start, outs):
        self.start = start
        self.outs = outs


ANY = "<any>"
_DIGITS = frozenset("0123456789")
_WORD = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")
_SPACE = frozenset(" \t\n\r\f\v")


class _Neg:
    """Complement charclass edge key: matches any char NOT in ``excl``.

    Kept as an exclusion set (not materialized against an ASCII universe)
    so the full Unicode space survives — guided_json string values are
    built from ``[^"\\\\]`` and must be able to emit non-ASCII text."""

    __slots__ = ("excl",)

    def __init__(self, excl):
        self.excl = frozenset(excl)

    def __contains__(self, ch) -> bool:
        return ch not in self.excl


#: hard ceiling on NFA size: a 17-byte pattern like "(a{9999}){9999}"
#: would otherwise expand to ~1e8 states at parse time (request-body DoS —
#: validate_guided runs in the frontend parser)
_MAX_NFA_STATES = 100_000
_MAX_COUNTED_REPEAT = 256


class _Nfa:
    def __init__(self):
        self.trans: list[list] = []  # state -> [(charset|None|ANY, next)]

    def state(self) -> int:
        if len(self.trans) >= _MAX_NFA_STATES:
            raise ValueError(
                f"regex too large (> {_MAX_NFA_STATES} NFA states)")
        self.trans.append([])
        return len(self.trans) - 1

    def edge(self, a, key, b):
        self.trans[a].append((key, b))


class _RegexParser:
    """Recursive-descent parser for the supported subset."""

    def __init__(self, pattern: str, nfa: _Nfa):
        self.p = pattern
        self.i = 0
        self.nfa = nfa

    def _peek(self):
        return self.p[self.i] if self.i < len(self.p) else None

    def _eat(self):
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self):
        frag = self._alt()
        if self.i != len(self.p):
            raise ValueError(f"unexpected {self.p[self.i]!r} at {self.i} "
                             f"in regex {self.p!r}")
        return frag

    def _alt(self):
        branches = [self._concat()]
        while self._peek() == "|":
            self._eat()
            branches.append(self._concat())
        if len(branches) == 1:
            return branches[0]
        s = self.nfa.state()
        outs = []
        for b in branches:
            self.nfa.edge(s, None, b.start)
            outs += b.outs
        return _Frag(s, outs)

    def _concat(self):
        frags = []
        while self._peek() is not None and self._peek() not in "|)":
            frags.append(self._repeat())
        if not frags:
            s = self.nfa.state()
            return _Frag(s, [(s, None)])
        cur = frags[0]
        for nxt in frags[1:]:
            cur = self._join(cur, nxt)
        return cur

    def _join(self, a, b):
        for st, key in a.outs:
            self.nfa.edge(st, key, b.start)
        return _Frag(a.start, b.outs)

    def _repeat(self):
        atom = self._atom()
        c = self._peek()
        if c == "*":
            self._eat()
            return self._star(atom)
        if c == "+":
            self._eat()
            return self._join(atom, self._star(self._clone(atom)))
        if c == "?":
            self._eat()
            return self._opt(atom)
        if c == "{":
            return self._counted(atom)
        return atom

    def _counted(self, atom):
        j = self.p.index("}", self.i)
        spec = self.p[self.i + 1:j]
        self.i = j + 1
        if "," in spec:
            lo_s, hi_s = spec.split(",", 1)
            lo, hi = int(lo_s or 0), (int(hi_s) if hi_s else None)
        else:
            lo = hi = int(spec)
        if lo > _MAX_COUNTED_REPEAT or (hi or 0) > _MAX_COUNTED_REPEAT:
            raise ValueError(f"counted repetition above "
                             f"{_MAX_COUNTED_REPEAT} is not supported")
        frag = None
        for _ in range(lo):
            c = self._clone(atom)
            frag = c if frag is None else self._join(frag, c)
        if hi is None:
            tail = self._star(self._clone(atom))
            return tail if frag is None else self._join(frag, tail)
        for _ in range(hi - lo):
            c = self._opt(self._clone(atom))
            frag = c if frag is None else self._join(frag, c)
        if frag is None:  # {0}
            s = self.nfa.state()
            return _Frag(s, [(s, None)])
        return frag

    def _star(self, atom):
        s = self.nfa.state()
        self.nfa.edge(s, None, atom.start)
        for st, key in atom.outs:
            self.nfa.edge(st, key, s)
        return _Frag(s, [(s, None)])

    def _opt(self, atom):
        s = self.nfa.state()
        self.nfa.edge(s, None, atom.start)
        return _Frag(s, atom.outs + [(s, None)])

    def _clone(self, frag):
        """Re-parse is simpler than graph cloning: atoms record their span."""
        start, end = frag.span
        sub = _RegexParser(self.p[start:end], self.nfa)
        out = sub._alt_noconsume()
        out.span = frag.span
        return out

    def _alt_noconsume(self):
        return self._alt()

    def _atom(self):
        start_pos = self.i
        c = self._eat()
        if c == "(":
            inner = self._alt()
            if self._peek() != ")":
                raise ValueError(f"unbalanced group in {self.p!r}")
            self._eat()
            frag = inner
        elif c == "[":
            frag = self._charclass()
        elif c == ".":
            frag = self._edge_frag(ANY)
        elif c == "\\":
            frag = self._edge_frag(self._escape(self._eat()))
        elif c in "*+?{":
            raise ValueError(f"dangling quantifier in {self.p!r}")
        else:
            frag = self._edge_frag(frozenset(c))
        frag.span = (start_pos, self.i)
        return frag

    def _edge_frag(self, key):
        a = self.nfa.state()
        return _Frag(a, [(a, key)])

    def _escape(self, c):
        table = {"d": _DIGITS, "w": _WORD, "s": _SPACE,
                 "D": _Neg(_DIGITS), "W": _Neg(_WORD), "S": _Neg(_SPACE),
                 "n": frozenset("\n"), "t": frozenset("\t"),
                 "r": frozenset("\r")}
        if c in table:
            return table[c]
        return frozenset(c)  # escaped literal/metachar

    def _charclass(self):
        neg = self._peek() == "^"
        if neg:
            self._eat()
        chars = set()
        comp = None  # ∩ of exclusion sets from complement escapes (\D\W\S)
        first = True
        while True:
            c = self._peek()
            if c is None:
                raise ValueError(f"unterminated class in {self.p!r}")
            if c == "]" and not first:
                self._eat()
                break
            first = False
            c = self._eat()
            if c == "\\":
                e = self._escape(self._eat())
                if isinstance(e, _Neg):
                    comp = e.excl if comp is None else comp & e.excl
                else:
                    chars |= e
                continue
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._eat()
                hi = self._eat()
                if hi == "\\":
                    hi = self._eat()
                chars |= {chr(x) for x in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        # the class is a union of members: positive chars P plus complement
        # members ¬E1,¬E2… → P ∪ ¬(E1∩E2∩…) = ¬((E1∩…) − P)
        if comp is not None:
            key = frozenset(comp - chars) if neg else _Neg(comp - chars)
        else:
            key = _Neg(chars) if neg else frozenset(chars)
        return self._edge_frag(key)


class CharDfa:
    """Lazily-determinized DFA over characters (subset construction)."""

    def __init__(self, pattern: str):
        self.nfa = _Nfa()
        frag = _RegexParser(pattern, self.nfa).parse()
        accept = self.nfa.state()
        for st, key in frag.outs:
            self.nfa.edge(st, key, accept)
        self.accept_nfa = accept
        self.start = self._closure(frozenset([frag.start]))
        self._step_cache: dict = {}

    def _closure(self, states: frozenset) -> frozenset:
        seen = set(states)
        stack = list(states)
        while stack:
            s = stack.pop()
            for key, nxt in self.nfa.trans[s]:
                if key is None and nxt not in seen:
                    seen.add(nxt)
                    stack.append(nxt)
        return frozenset(seen)

    def step(self, state: frozenset, ch: str) -> Optional[frozenset]:
        """None = dead."""
        cached = self._step_cache.get((state, ch))
        if cached is not None:
            return cached if cached != DEAD else None
        nxt = set()
        for s in state:
            for key, t in self.nfa.trans[s]:
                if key is None:
                    continue
                if (key == ANY and ch != "\n") or (key != ANY
                                                     and ch in key):
                    # '.' excludes newline (python-re default semantics)
                    nxt.add(t)
        out = self._closure(frozenset(nxt)) if nxt else None
        self._step_cache[(state, ch)] = out if out is not None else DEAD
        return out

    def walk(self, state: frozenset, text: str) -> Optional[frozenset]:
        for ch in text:
            state = self.step(state, ch)
            if state is None:
                return None
        return state

    def is_accepting(self, state: frozenset) -> bool:
        return self.accept_nfa in state

    def fullmatch(self, text: str) -> bool:
        s = self.walk(self.start, text)
        return s is not None and self.is_accepting(s)


# ------------------------------------------------------------- token machine

class TokenMachine:
    """Token-level view of a CharDfa over a fixed vocabulary.

    ``allowed(state)`` → {token_id: next_state} for every token whose FULL
    text survives the walk — computed once per distinct state and cached.
    Empty-text tokens (special markers that decode to "") are never allowed.
    """

    #: forward-search cap per liveness query: past this a state is treated
    #: as live (optimistic = char-level semantics, never worse than r2)
    #: and a warning logs once. Each explored state costs one vocab walk,
    #: so the cap bounds pathological patterns, not normal serving.
    MAX_LIVE_SEARCH = 500

    def __init__(self, dfa: CharDfa, vocab: list[str]):
        self.dfa = dfa
        self.vocab = vocab
        self._allowed_cache: dict = {}
        self._ids_cache: dict = {}  # (state, max_id) -> [token_id]
        self._live_memo: dict = {}  # state -> token-level liveness
        self._live_cap_warned = False

    @property
    def start(self):
        return self.dfa.start

    def allowed(self, state) -> dict:
        hit = self._allowed_cache.get(state)
        if hit is not None:
            return hit
        out = {}
        for tid, text in enumerate(self.vocab):
            if not text:
                continue
            nxt = self.dfa.walk(state, text)
            if nxt is not None:
                out[tid] = nxt
        self._allowed_cache[state] = out
        return out

    def allowed_ids_below(self, state, max_id: int) -> list:
        """Cached id list clamped to the model's logits width — the
        per-step fast path (the dict walk + filter would be O(vocab) of
        Python per sampled token otherwise). Callers must not mutate.

        Tokens landing in token-DEAD states (char-alive but no token path
        to acceptance — r2 verdict #6) are excluded, so generation can
        never stall into an all-masked step mid-constraint."""
        key = (state, max_id)
        hit = self._ids_cache.get(key)
        if hit is None:
            hit = [t for t, nxt in self.allowed(state).items()
                   if 0 <= t < max_id and self.token_live(nxt)]
            self._ids_cache[key] = hit
        return hit

    def token_live(self, state) -> bool:
        """True when acceptance is reachable from ``state`` via TOKENS (or
        ``state`` accepts already). Char-level liveness alone strands
        generation on vocabularies missing the needed characters.

        Memoized DFS: proving LIVE stops at the first accepting path (and
        marks the whole discovery path live); proving DEAD requires
        exhausting the state's token-closure, which then bulk-memoizes as
        dead (every closure member shares the verdict)."""
        memo = self._live_memo
        hit = memo.get(state)
        if hit is not None:
            return hit
        if self.is_accepting(state):
            memo[state] = True
            return True
        parents: dict = {state: None}
        stack = [state]
        explored = 0
        while stack:
            s = stack.pop()
            explored += 1
            if explored > self.MAX_LIVE_SEARCH:
                if not self._live_cap_warned:
                    self._live_cap_warned = True
                    logging.getLogger("dynamo.llm.guided").warning(
                        "guided liveness search capped at %d states — "
                        "falling back to char-level liveness for this "
                        "constraint (token-level dead ends possible)",
                        self.MAX_LIVE_SEARCH)
                memo[state] = True  # optimistic: old behavior, not worse
                return True
            for nxt in self.allowed(s).values():
                if nxt in parents or memo.get(nxt) is False:
                    continue
                if memo.get(nxt) or self.is_accepting(nxt):
                    memo[nxt] = True
                    cur = s  # the discovery path reaches acceptance too
                    while cur is not None:
                        memo[cur] = True
                        cur = parents[cur]
                    return True
                parents[nxt] = s
                stack.append(nxt)
        for s in parents:  # exhaustive: the whole closure never accepts
            memo[s] = False
        return False

    def has_live_continuation(self, state) -> bool:
        """Some token from ``state`` lands on a token-live state (memo
        lookups after first touch — no second O(vocab) filter pass like an
        allowed_ids_below call with a different max_id would pay)."""
        return any(self.token_live(n) for n in self.allowed(state).values())

    def is_accepting(self, state) -> bool:
        return self.dfa.is_accepting(state)


DEAD = "<dead>"


class GuidedState:
    """Per-sequence constraint cursor (attached to SeqState by the engine).

    ``advance`` runs in the engine's sampling worker thread (never on the
    event loop: it may trigger an O(vocab) walk for a newly-visited DFA
    state). ``done``/``exhausted`` are plain reads for the scheduler's
    finish check — a completed or stranded constraint must STOP the
    sequence even when the request has no EOS ids or set ignore_eos.
    """

    def __init__(self, machine: TokenMachine, eos_ids: list[int]):
        self.machine = machine
        self.state = machine.start
        self.eos_ids = list(eos_ids)
        self.done = False
        #: no token can extend the constraint from the current state — the
        #: sequence must finish (reason "stop") instead of free-running
        self.exhausted = False

    def allowed_token_ids(self, max_id: Optional[int] = None) -> list[int]:
        """Tokens permitted at the current position; EOS joins the set when
        the constraint can terminate here. A finished (or dead) constraint
        allows only EOS so the sequence ends instead of free-running.

        Liveness is TOKEN-level: a token is allowed only when its landing
        state still has some token path to acceptance
        (TokenMachine.token_live), so the walk cannot strand — vocabularies
        missing the pattern's characters refuse at compile time instead
        (compile_guided checks the start state)."""
        hi = max_id if max_id is not None else len(self.machine.vocab)
        # clamp EOS only against an EXPLICIT logits width — eos ids may
        # legitimately exceed the constraint vocabulary's length
        eos = (list(self.eos_ids) if max_id is None
               else [e for e in self.eos_ids if 0 <= e < max_id])
        if self.done:
            return eos
        allowed = self.machine.allowed_ids_below(self.state, hi)
        if self.machine.is_accepting(self.state) or not allowed:
            return allowed + eos  # new list: never mutate the cached one
        return allowed

    def advance(self, token_id: int) -> None:
        if self.done:
            return
        if token_id in self.eos_ids:
            self.done = True
            return
        nxt = self.machine.allowed(self.state).get(token_id)
        if nxt is None:
            self.done = True  # off-constraint (shouldn't happen when masked)
            return
        self.state = nxt
        if not self.machine.has_live_continuation(nxt):
            # complete (accepting) or stranded (possible only past the
            # liveness-search cap): no further token is legal — finish
            # before sampling another
            self.exhausted = True


# --------------------------------------------------------- schema → pattern

_STR_RE = r'"([^"\\]|\\["\\nrt])*"'
_INT_RE = r"-?(0|[1-9]\d*)"
_NUM_RE = _INT_RE + r"(\.\d+)?([eE][-+]?\d+)?"


_SCHEMA_KEYS = {"type", "properties", "items", "minItems", "maxItems",
                "enum", "const", "required", "title", "description",
                "$schema", "additionalProperties"}


def json_value_regex(depth: int = 3) -> str:
    """Generic JSON value, nesting bounded at ``depth`` (regular languages
    cannot express unbounded nesting; outlines bounds it the same way).
    Depth 0 is primitives only; each level adds arrays/objects of the
    level below."""
    v = _NUM_RE + "|" + _STR_RE + "|true|false|null"
    for _ in range(depth):
        item = f"({v})"
        arr = rf"\[({item}(,{item})*)?\]"
        obj = rf"\{{({_STR_RE}:{item}(,{_STR_RE}:{item})*)?\}}"
        v = v + "|" + arr + "|" + obj
    return v


def json_object_regex(depth: int = 3) -> str:
    """Generic JSON OBJECT (response_format: json_object), values nested
    up to ``depth``."""
    item = f"({json_value_regex(depth - 1)})"
    return rf"\{{({_STR_RE}:{item}(,{_STR_RE}:{item})*)?\}}"


def schema_to_regex(schema) -> str:
    """JSON-schema subset → regex producing canonical (whitespace-free)
    JSON. Covered: object (properties all required, in declared order;
    no properties = any object), array (items, minItems/maxItems), string,
    integer, number, boolean, null, enum, const. Unsupported keywords
    fail loudly."""
    if schema is True or schema == {}:
        return json_value_regex()
    unknown = set(schema) - _SCHEMA_KEYS
    if unknown:
        raise ValueError(f"unsupported JSON-schema keywords for "
                         f"guided_json: {sorted(unknown)}")
    if "enum" in schema:
        return "|".join(_pyre.escape(json.dumps(v, separators=(",", ":")))
                        for v in schema["enum"])
    if "const" in schema:
        return _pyre.escape(json.dumps(schema["const"], separators=(",", ":")))
    t = schema.get("type")
    if t == "string":
        return _STR_RE
    if t == "integer":
        return _INT_RE
    if t == "number":
        return _NUM_RE
    if t == "boolean":
        return "true|false"
    if t == "null":
        return "null"
    if t == "array":
        item = schema_to_regex(schema.get("items", True))
        lo = schema.get("minItems", 0)
        hi = schema.get("maxItems")
        item_g = f"({item})"
        if hi is None:
            body = (f"{item_g}(,{item_g})*" if lo == 0
                    else f"{item_g}(,{item_g}){{{max(0, lo - 1)},}}")
            if lo == 0:
                body = f"({body})?"
        elif hi == 0:
            body = ""
        else:
            body = f"{item_g}(,{item_g}){{{max(0, lo - 1)},{hi - 1}}}"
            if lo == 0:
                body = f"({body})?"
        return rf"\[{body}\]"
    if t == "object":
        props = schema.get("properties", {})
        if not props:
            return json_object_regex()
        parts = []
        for name, sub in props.items():
            key = _pyre.escape(json.dumps(name))
            parts.append(f"{key}:({schema_to_regex(sub)})")
        return r"\{" + ",".join(parts) + r"\}"
    raise ValueError(f"unsupported JSON-schema construct for guided_json: "
                     f"{schema!r}")


# ------------------------------------------------------------------- factory

def guided_pattern(guided: dict) -> str:
    """Resolve a request's guided-decoding options dict ({"regex": ...} |
    {"json": ...} | {"choice": [...]} — already validated mutually
    exclusive) to the constraint regex. Raises ValueError on unsupported
    or malformed options — the frontend calls this at parse time so bad
    requests 400 instead of erroring deep in a worker."""
    if guided.get("grammar") is not None:
        raise ValueError("guided_grammar (EBNF) is not supported; use "
                         "guided_json or guided_regex")
    if guided.get("choice") is not None:
        return "|".join(_pyre.escape(str(c)) for c in guided["choice"])
    if guided.get("regex") is not None:
        return guided["regex"]
    if guided.get("json") is not None:
        schema = guided["json"]
        if isinstance(schema, str):
            schema = json.loads(schema)
        return schema_to_regex(schema)
    raise ValueError(f"empty guided-decoding options: {guided!r}")


_VALIDATED: dict = {}
_VALIDATED_CAP = 256


def validate_guided(guided: dict) -> None:
    """Parse-time validation: resolves the pattern AND compiles the char
    NFA, so regex syntax errors and unsupported schema keywords are caught
    at the API boundary. Compiles are cached by pattern — this runs on the
    frontend serving path, and the json_object pattern alone is a ~2300-
    state NFA (~10ms)."""
    pattern = guided_pattern(guided)
    if pattern in _VALIDATED:
        return
    CharDfa(pattern)
    if len(_VALIDATED) >= _VALIDATED_CAP:
        _VALIDATED.pop(next(iter(_VALIDATED)))
    _VALIDATED[pattern] = True


#: (pattern, vocab identity) → TokenMachine. The machine's per-state token
#: walks are the expensive part (O(vocab) per newly-visited state) — with
#: one schema served by many requests, the cache makes every request after
#: the first reuse the warm walks. Bounded FIFO eviction.
_MACHINE_CACHE: dict = {}
_MACHINE_CACHE_CAP = 64


def get_machine(pattern: str, vocab: list[str]) -> tuple[TokenMachine, bool]:
    """(machine, cache_hit) for a pattern over a vocab. The hit flag feeds
    the structured subsystem's dynamo_structured_compile_total counter —
    a miss means the full char-NFA compile ran for this admission."""
    key = (pattern, id(vocab))
    machine = _MACHINE_CACHE.get(key)
    if machine is not None and machine.vocab is vocab:
        return machine, True
    machine = TokenMachine(CharDfa(pattern), vocab)
    if len(_MACHINE_CACHE) >= _MACHINE_CACHE_CAP:
        _MACHINE_CACHE.pop(next(iter(_MACHINE_CACHE)))
    _MACHINE_CACHE[key] = machine
    return machine, False


def compile_guided(guided: dict, vocab: list[str],
                   eos_ids: list[int]) -> GuidedState:
    """Build a GuidedState for one request (machines are cached across
    requests; the state cursor is per-sequence)."""
    pattern = guided_pattern(guided)
    machine, _ = get_machine(pattern, vocab)
    if not machine.token_live(machine.start):
        # refuse at COMPILE time: no token sequence over this vocabulary
        # can satisfy the pattern, so generation would stall immediately
        raise ValueError(
            "guided constraint cannot be satisfied by any token sequence "
            "over this model's vocabulary")
    return GuidedState(machine, eos_ids)

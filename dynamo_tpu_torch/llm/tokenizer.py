"""The guided-decoding alphabet of a tokenizer, read from ``tokenizer.json``
with ``json`` alone.

The JAX worker builds it with ``TokenizerWrapper.guided_vocab()``
(``dynamo_tpu/llm/tokenizer.py``), which needs the ``tokenizers``
package; the card's machine need not have it. This module gives the same
list: id → the EXACT text the token contributes mid-sequence, the
alphabet of the token-level DFA (``llm/guided.TokenMachine``). The token
strings carry the truth, transformed directly:

- byte-level BPE (pieces spell bytes, a leading space as "Ġ"): the bytes
  by the inverse of the byte-level alphabet, decoded as strict UTF-8 (a
  piece holding part of a multi-byte character has no text alone: "");
- Metaspace / SentencePiece (a leading space as "▁"): "▁" becomes a
  space, a byte-fallback piece ``<0xHH>`` its character when ASCII, else
  ""; the lone "▁" decodes to "" (the decoder strips a first token's
  leading space);
- WordLevel with no decoder: the word;
- special added tokens: "" (never constraint-eligible).

Any other decoder gives None, with the reason logged: guided requests are
then refused, as the JAX worker refuses them without a vocabulary.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Optional

logger = logging.getLogger("dynamo_torch.tokenizer")

_SP_BYTE = re.compile(r"<0x[0-9A-Fa-f]{2}>")
#: the parts a SentencePiece-style decoder may be built from
_METASPACE_PARTS = {"Metaspace", "Replace", "ByteFallback", "Fuse", "Strip"}

#: the words of the JAX package's test tokenizer (``make_test_tokenizer``:
#: a WordLevel model, no decoder, no special tokens), in id order
TEST_TOKENIZER_WORDS = [
    "<unk>", "<s>", "</s>", "<|user|>", "<|assistant|>", "<|system|>",
    "hello", "world", "the", "quick", "brown", "fox", "jumps", "over",
    "lazy", "dog", "a", "b", "c", "d", "e", "f", "g", "h", "i", "j",
    "what", "is", "capital", "of", "france", "paris", "tell", "me",
    "about", "tokens", "stream", "stop", "sequence", "test", ".", ",", "?",
]


def wordlevel_test_vocab() -> list[str]:
    """The guided alphabet of the test tokenizer (test fleets)."""
    return list(TEST_TOKENIZER_WORDS)


def bytelevel_inverse() -> dict:
    """char → byte inverse of the byte-level BPE alphabet (the printable
    remap of GPT-2-lineage tokenizers): printable bytes map to themselves,
    the rest to U+0100+offset code points."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAC + 1)) + list(range(0xAE, 0xFF + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}


def _decoder_types(dec) -> list[str]:
    if dec is None:
        return []
    if dec.get("type") == "Sequence":
        return [d.get("type") for d in dec.get("decoders", [])]
    return [dec.get("type")]


def guided_vocab_from_dir(path: str) -> Optional[list[str]]:
    """The guided alphabet of ``path``/tokenizer.json, or None (logged)
    when its decoder is not one of those above."""
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        tj = json.load(f)
    model = tj.get("model") or {}
    vocab = model.get("vocab")
    pieces: dict[int, str] = {}
    if isinstance(vocab, dict):
        pieces = {int(i): t for t, i in vocab.items()}
    elif isinstance(vocab, list):  # Unigram: [[piece, score], ...]
        pieces = {i: p[0] for i, p in enumerate(vocab)}
    special = set()
    for tok in tj.get("added_tokens") or []:
        pieces[int(tok["id"])] = tok["content"]
        if tok.get("special"):
            special.add(int(tok["id"]))
    if not pieces:
        logger.warning("%s: tokenizer.json has no vocabulary; guided "
                       "decoding disabled", path)
        return None
    n = max(pieces) + 1
    toks = [pieces.get(i, "") for i in range(n)]
    types = _decoder_types(tj.get("decoder"))
    byte_level = any("Ġ" in t for t in toks)
    metaspace = not byte_level and any(t.startswith("▁") for t in toks)
    out = []
    if types == ["ByteLevel"]:
        inv = bytelevel_inverse()
        for i, t in enumerate(toks):
            if i in special or not t:
                out.append("")
            elif not all(c in inv for c in t):
                out.append(t)  # the decoder passes such a piece unchanged
            else:
                raw = bytes(inv[c] for c in t)
                # without "Ġ" anywhere the JAX worker takes the lossy
                # single-token decode, with it the strict one
                try:
                    out.append(raw.decode("utf-8") if byte_level
                               else raw.decode("utf-8", errors="replace"))
                except UnicodeDecodeError:
                    out.append("")
        return out
    if types and set(types) <= _METASPACE_PARTS and metaspace:
        for i, t in enumerate(toks):
            if i in special or not t or t == "▁":
                out.append("")
            elif _SP_BYTE.fullmatch(t):
                b = int(t[3:5], 16)
                out.append(chr(b) if b < 0x80 else "")
            else:
                out.append(t.replace("▁", " "))
        return out
    if not types and model.get("type") == "WordLevel":
        return ["" if i in special else t for i, t in enumerate(toks)]
    logger.warning("%s: no guided alphabet for decoder %s over a %s model; "
                   "guided decoding disabled", path, types or None,
                   model.get("type"))
    return None


def load_guided_vocab(tokenizer_ref: str) -> Optional[list[str]]:
    """Best-effort guided alphabet for the worker: None (guided requests
    are refused with a clear error) when the tokenizer cannot be read,
    rather than failing startup."""
    if not os.path.isfile(os.path.join(tokenizer_ref, "tokenizer.json")):
        logger.warning("no tokenizer.json in %s; guided decoding disabled",
                       tokenizer_ref)
        return None
    try:
        return guided_vocab_from_dir(tokenizer_ref)
    except Exception:
        logger.warning("could not read the vocabulary of %s; guided "
                       "decoding disabled", tokenizer_ref, exc_info=True)
        return None

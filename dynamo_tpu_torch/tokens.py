"""Token block hashing: salted XXH3-64 block hashes and chained sequence hashes.

The port's own copy of ``dynamo_tpu/tokens.py``. The hashes are the identity
of a KV block across a fleet (radix index, KV events, prefix cache), so they
must be bit-identical to the JAX package's:

- a token is a u32, hashed as little-endian bytes;
- ``block_hash = xxh3_64(le_bytes(tokens), seed=salt_hash)``;
- the first block's ``sequence_hash`` is its ``block_hash``; later blocks
  chain ``xxh3_64(le_bytes([parent_sequence_hash, block_hash]), seed=salt)``;
- the KV router's fixed seed is ``KV_HASH_SEED = 1337``.

The machines the port runs on need not carry the ``xxhash`` package, so
XXH3-64 is computed here in Python for inputs of at most 240 bytes: a block
of up to 60 tokens, and the 16-byte chain input. Longer inputs take XXH3's
long-input path (a derived secret and stripe accumulation), which this
module does not implement; it raises instead.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

Token = int  # u32
BlockHash = int  # u64
SequenceHash = int  # u64
SaltHash = int  # u64

#: Fixed seed used by the KV-router hash domain.
KV_HASH_SEED: SaltHash = 1337

_M64 = (1 << 64) - 1

# ---------------------------------------------------------------- XXH3-64

_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_PMX1 = 0x165667919E3779F9
_PMX2 = 0x9FB21C651E98DF25

#: XXH3's default 192-byte secret (kSecret)
_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e")
_MAX_SHORT = 240


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 4], "little")


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i:i + 8], "little")


def _swap32(x: int) -> int:
    return int.from_bytes(x.to_bytes(4, "little"), "big")


def _swap64(x: int) -> int:
    return int.from_bytes(x.to_bytes(8, "little"), "big")


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fold64(a: int, b: int) -> int:
    p = a * b
    return (p ^ (p >> 64)) & _M64


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _rrmxmx(h: int, n: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * _PMX2) & _M64
    h ^= (h >> 35) + n
    h = (h * _PMX2) & _M64
    return h ^ (h >> 28)


def _mix16(b: bytes, i: int, s: int, seed: int) -> int:
    lo = _r64(b, i) ^ ((_r64(_SECRET, s) + seed) & _M64)
    hi = _r64(b, i + 8) ^ ((_r64(_SECRET, s + 8) - seed) & _M64)
    return _fold64(lo, hi)


def xxh3_64(data: bytes, seed: int = 0) -> int:
    """XXH3-64 of ``data`` (at most 240 bytes) with a 64-bit ``seed``."""
    n = len(data)
    seed &= _M64
    if n > _MAX_SHORT:
        raise ValueError(
            f"xxh3_64: {n}-byte input exceeds the {_MAX_SHORT}-byte "
            "short-input path this module implements")
    if n == 0:
        return _xxh64_avalanche(seed ^ _r64(_SECRET, 56) ^ _r64(_SECRET, 64))
    if n <= 3:
        combined = ((data[0] << 16) | (data[n >> 1] << 24) | data[n - 1]
                    | (n << 8))
        bitflip = ((_r32(_SECRET, 0) ^ _r32(_SECRET, 4)) + seed) & _M64
        return _xxh64_avalanche(combined ^ bitflip)
    if n <= 8:
        seed ^= _swap32(seed & 0xFFFFFFFF) << 32
        in64 = (_r32(data, n - 4) + (_r32(data, 0) << 32)) & _M64
        bitflip = ((_r64(_SECRET, 8) ^ _r64(_SECRET, 16)) - seed) & _M64
        return _rrmxmx(in64 ^ bitflip, n)
    if n <= 16:
        bf1 = ((_r64(_SECRET, 24) ^ _r64(_SECRET, 32)) + seed) & _M64
        bf2 = ((_r64(_SECRET, 40) ^ _r64(_SECRET, 48)) - seed) & _M64
        lo = _r64(data, 0) ^ bf1
        hi = _r64(data, n - 8) ^ bf2
        acc = (n + _swap64(lo) + hi + _fold64(lo, hi)) & _M64
        return _avalanche(acc)
    acc = (n * _P64_1) & _M64
    if n <= 128:
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, 96, seed)
                    acc += _mix16(data, n - 64, 112, seed)
                acc += _mix16(data, 32, 64, seed)
                acc += _mix16(data, n - 48, 80, seed)
            acc += _mix16(data, 16, 32, seed)
            acc += _mix16(data, n - 32, 48, seed)
        acc += _mix16(data, 0, 0, seed)
        acc += _mix16(data, n - 16, 16, seed)
        return _avalanche(acc & _M64)
    for i in range(8):
        acc += _mix16(data, 16 * i, 16 * i, seed)
    acc = _avalanche(acc & _M64)
    for i in range(8, n // 16):
        acc += _mix16(data, 16 * i, 16 * (i - 8) + 3, seed)
    acc += _mix16(data, n - 16, 136 - 17, seed)
    return _avalanche(acc & _M64)


# ---------------------------------------------------------------- hashes


def compute_hash(data: bytes, seed: int = KV_HASH_SEED) -> int:
    return xxh3_64(data, seed)


def _tokens_le_bytes(tokens: Sequence[int]) -> bytes:
    return struct.pack(f"<{len(tokens)}I", *tokens)


def compute_block_hash(tokens: Sequence[int],
                       salt_hash: SaltHash = KV_HASH_SEED) -> BlockHash:
    """Hash of the tokens local to one block."""
    return compute_hash(_tokens_le_bytes(tokens), seed=salt_hash)


def chain_sequence_hash(parent: Optional[SequenceHash], block_hash: BlockHash,
                        salt_hash: SaltHash = KV_HASH_SEED) -> SequenceHash:
    """Combine a parent sequence hash with a block hash."""
    if parent is None:
        return block_hash
    return compute_hash(struct.pack("<2Q", parent & _M64, block_hash & _M64),
                        seed=salt_hash)


@dataclass(frozen=True)
class TokenBlock:
    """A complete, immutable block of tokens with its hashes."""

    tokens: tuple[int, ...]
    block_hash: BlockHash
    sequence_hash: SequenceHash
    parent_sequence_hash: Optional[SequenceHash]

    @staticmethod
    def from_tokens(tokens: Sequence[int],
                    parent_sequence_hash: Optional[SequenceHash],
                    salt_hash: SaltHash) -> "TokenBlock":
        bh = compute_block_hash(tokens, salt_hash)
        sh = chain_sequence_hash(parent_sequence_hash, bh, salt_hash)
        return TokenBlock(tuple(tokens), bh, sh, parent_sequence_hash)


@dataclass
class TokenBlockSequence:
    """Splits a growing token stream into hash-chained fixed-size blocks;
    the tail lives in ``current_tokens`` until it fills."""

    block_size: int
    salt_hash: SaltHash = KV_HASH_SEED
    blocks: list[TokenBlock] = field(default_factory=list)
    current_tokens: list[int] = field(default_factory=list)

    @staticmethod
    def from_tokens(tokens: Iterable[int], block_size: int,
                    salt_hash: SaltHash = KV_HASH_SEED
                    ) -> "TokenBlockSequence":
        seq = TokenBlockSequence(block_size=block_size, salt_hash=salt_hash)
        seq.extend(tokens)
        return seq

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self.current_tokens)

    def push_token(self, token: int) -> Optional[TokenBlock]:
        """Append one token; returns the newly-completed block, if any."""
        self.current_tokens.append(token)
        if len(self.current_tokens) == self.block_size:
            parent = self.blocks[-1].sequence_hash if self.blocks else None
            block = TokenBlock.from_tokens(self.current_tokens, parent,
                                           self.salt_hash)
            self.blocks.append(block)
            self.current_tokens = []
            return block
        return None

    def extend(self, tokens: Iterable[int]) -> list[TokenBlock]:
        """Append many tokens; returns all newly-completed blocks."""
        new_blocks: list[TokenBlock] = []
        for t in tokens:
            b = self.push_token(t)
            if b is not None:
                new_blocks.append(b)
        return new_blocks

    def sequence_hashes(self) -> list[SequenceHash]:
        return [b.sequence_hash for b in self.blocks]

    def block_hashes(self) -> list[BlockHash]:
        return [b.block_hash for b in self.blocks]

"""MurmurHash3 x86/32 — the port's own copy of ``flink_ml_tpu/ops/hashing.py``,
bit-exact with the reference's guava hashing.

Reference: HashingTF.java:61-63 / FeatureHasher.java:72 use guava
``murmur3_32(0)``; strings are hashed with ``hashUnencodedChars`` (UTF-16 code
units, little-endian), ints with ``hashInt``, longs with ``hashLong``; HashingTF
maps hashes with ``nonNegativeMod`` (HashingTF.java:195-198) while FeatureHasher
uses ``Math.abs`` (FeatureHasher.java:187). Bit-exactness means feature indices
match the reference for identical inputs.

Host-side code: hashing happens at the ingestion boundary (strings → indices);
the resulting sparse/dense arrays are what reach the device.
"""
from __future__ import annotations

__all__ = [
    "murmur3_32",
    "hash_unencoded_chars",
    "hash_int",
    "hash_long",
    "non_negative_mod",
    "java_abs",
]

_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_MASK = 0xFFFFFFFF


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _MASK


def _fmix(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h


def _mix_k1(k1: int) -> int:
    k1 = (k1 * _C1) & _MASK
    k1 = _rotl32(k1, 15)
    return (k1 * _C2) & _MASK


def _mix_h1(h1: int, k1: int) -> int:
    h1 ^= k1
    h1 = _rotl32(h1, 13)
    return (h1 * 5 + 0xE6546B64) & _MASK


def _to_signed(h: int) -> int:
    return h - (1 << 32) if h >= (1 << 31) else h


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86/32 over bytes; returns a signed 32-bit int (Java int)."""
    h1 = seed & _MASK
    n = len(data)
    rounded = n & ~3
    for i in range(0, rounded, 4):
        k1 = int.from_bytes(data[i : i + 4], "little")
        h1 = _mix_h1(h1, _mix_k1(k1))
    k1 = 0
    tail = n - rounded
    if tail >= 3:
        k1 ^= data[rounded + 2] << 16
    if tail >= 2:
        k1 ^= data[rounded + 1] << 8
    if tail >= 1:
        k1 ^= data[rounded]
        h1 ^= _mix_k1(k1)
    h1 ^= n
    return _to_signed(_fmix(h1))


def hash_unencoded_chars(s: str, seed: int = 0) -> int:
    """guava Hashing.murmur3_32(seed).hashUnencodedChars(s) — UTF-16LE code units."""
    return murmur3_32(s.encode("utf-16-le"), seed)


def hash_int(value: int, seed: int = 0) -> int:
    """guava hashInt — 4 little-endian bytes of the 32-bit value."""
    return murmur3_32((value & _MASK).to_bytes(4, "little"), seed)


def hash_long(value: int, seed: int = 0) -> int:
    """guava hashLong — 8 little-endian bytes of the 64-bit value."""
    return murmur3_32((value & 0xFFFFFFFFFFFFFFFF).to_bytes(8, "little"), seed)


def non_negative_mod(x: int, mod: int) -> int:
    """Ref HashingTF.nonNegativeMod:195."""
    raw = ((x % mod) + mod) % mod if mod else 0
    return raw


def java_abs(x: int) -> int:
    """Java Math.abs on int — including the Integer.MIN_VALUE quirk
    (abs(MIN_VALUE) == MIN_VALUE), which FeatureHasher inherits."""
    if x == -(1 << 31):
        return x
    return abs(x)

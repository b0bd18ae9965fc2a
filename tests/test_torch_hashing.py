"""The port's murmur3 (``flink_ml_tpu_torch/ops/hashing.py``) and the term
hashing of HashingTF and FeatureHasher against the JAX package on the CPU.

Every feature index of the text stages comes from these functions, so each
is held bit for bit (integer equality) on seeded inputs: ASCII, non-BMP
(UTF-16 surrogate pairs) and empty strings, ints at the int32 edges, longs,
floats with -0.0 and NaN, bools and None, under both index rules
(HashingTF's nonNegativeMod, FeatureHasher's Math.abs then %).
"""
import math

import numpy as np
import pytest
import torch

import flink_ml_tpu.models.feature.feature_hasher as jfh
import flink_ml_tpu.models.feature.hashing_tf as jhtf
from flink_ml_tpu.ops import hashing as jhashing

import flink_ml_tpu_torch.models.feature.feature_hasher as fh
import flink_ml_tpu_torch.models.feature.hashing_tf as htf
from flink_ml_tpu_torch.ops import hashing

torch.set_num_threads(1)

INT32_EDGES = [0, 1, -1, 2**31 - 1, -(2**31), 2**31 - 2, -(2**31) + 1, 12345, -98765]
LONG_EDGES = [2**31, -(2**31) - 1, 2**63 - 1, -(2**63), 2**40 + 7, -(2**52) - 3]


def _strings(seed, n=200):
    rng = np.random.default_rng(seed)
    alphabet = ("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 -_=.,"
                "éßøñü中文字😀𝄞𐍈")
    out = ["", "a", "ab", "abc", "abcd", "abcde", "😀", "a😀", "𝄞𝄞𝄞", "\x00", "￿"]
    for _ in range(n):
        k = int(rng.integers(0, 24))
        out.append("".join(alphabet[i] for i in rng.integers(0, len(alphabet), k)))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_murmur3_of_strings_bytes_and_seeds(seed):
    for s in _strings(seed):
        assert hashing.hash_unencoded_chars(s) == jhashing.hash_unencoded_chars(s), repr(s)
        for hseed in (0, 42, 2**32 - 1):
            assert hashing.hash_unencoded_chars(s, hseed) == jhashing.hash_unencoded_chars(s, hseed)
        raw = s.encode("utf-8")
        assert hashing.murmur3_32(raw) == jhashing.murmur3_32(raw)


def test_murmur3_of_ints_and_longs():
    rng = np.random.default_rng(3)
    ints = INT32_EDGES + [int(v) for v in rng.integers(-(2**31), 2**31, 200)]
    longs = LONG_EDGES + [int(v) for v in rng.integers(-(2**63), 2**63 - 1, 200, dtype=np.int64)]
    for v in ints:
        assert hashing.hash_int(v) == jhashing.hash_int(v), v
        assert hashing.hash_long(v) == jhashing.hash_long(v), v
    for v in longs:
        assert hashing.hash_long(v) == jhashing.hash_long(v), v
    # a known guava value: murmur3_32(0).hashInt(0)
    assert hashing.hash_int(0) == 593689054


@pytest.mark.parametrize("mod", [1, 2, 7, 32, 1000, 1 << 18, 2**31 - 1])
def test_both_index_rules(mod):
    rng = np.random.default_rng(mod % 97)
    xs = INT32_EDGES + [int(v) for v in rng.integers(-(2**31), 2**31, 300)]
    for x in xs:
        assert hashing.non_negative_mod(x, mod) == jhashing.non_negative_mod(x, mod)
        assert hashing.java_abs(x) % mod == jhashing.java_abs(x) % mod
    assert hashing.java_abs(-(2**31)) == -(2**31)  # Math.abs(Integer.MIN_VALUE)
    assert hashing.non_negative_mod(5, 0) == jhashing.non_negative_mod(5, 0) == 0


def test_hashingtf_term_hash_by_type():
    rng = np.random.default_rng(4)
    terms = (
        [None, True, False, np.bool_(True), np.bool_(False), 0.0, -0.0, math.nan, math.inf, -math.inf,
         1.5, np.float32(0.1), np.float64(-2.25), np.int64(7), np.int32(-3), np.uint8(200)]
        + INT32_EDGES + LONG_EDGES + _strings(4, 50)
        + [float(v) for v in rng.normal(size=50)]
    )
    for t in terms:
        assert htf._hash(t) == jhtf._hash(t), repr(t)
    assert htf._hash(0.0) != htf._hash(-0.0)
    assert htf._hash(1) == htf._hash(True) != htf._hash(1.0)
    with pytest.raises(TypeError):
        htf._hash(object())
    with pytest.raises(TypeError):
        jhtf._hash(object())


def test_featurehasher_index_rule():
    for n in (1, 16, 1000, 1 << 18):
        for s in _strings(5, 100) + ["f0=0.5", "cat=red", "x=true"]:
            assert fh._index(s, n) == jfh._index(s, n), (s, n)

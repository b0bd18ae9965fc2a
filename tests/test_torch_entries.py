"""The ``entries`` convention in the port against the JAX package on the CPU:
the segment-reduce bodies ``sparse_combine_fn``, ``sparse_compact_fn`` and
``sparse_threshold_fn`` (``flink_ml_tpu_torch/ops/kernels.py``),
``pack_entry_rows`` and the names of an ``entries`` KernelSpec.

The bodies are held bit for bit (float32 bits, int32 ids and nnz), never
within a tolerance: the JAX package folds each equal-id run strictly in
slot order, and so must the port, so runs whose float sum depends on the
order (1e8, 1, -1e8) are among the cases, as are empty rows, all-padding
rows, cap 1 and a row of one id.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flink_ml_tpu.ops.kernels import (
    sparse_combine_fn as jax_combine,
    sparse_compact_fn as jax_compact,
    sparse_threshold_fn as jax_threshold,
)
from flink_ml_tpu.servable import sparse as jsparse
from flink_ml_tpu.servable.kernel_spec import KernelSpec as JKernelSpec

from flink_ml_tpu_torch.ops.kernels import (
    sparse_combine_fn,
    sparse_compact_fn,
    sparse_threshold_fn,
)
from flink_ml_tpu_torch.servable import sparse
from flink_ml_tpu_torch.servable.kernel_spec import SPARSE_KINDS, KernelSpec

torch.set_num_threads(1)


def _bits_equal(got, want, where):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (where, got.shape, want.shape,
                                                                 got.dtype, want.dtype)
    if got.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want, err_msg=where)


def _entries(seed, n, cap, dim, kind):
    """Raw entries [n, cap] with each row's nnz in [0, cap]; padding slots
    carry garbage ids and values, which every body must ignore."""
    rng = np.random.default_rng(seed)
    nnz = rng.integers(0, cap + 1, n).astype(np.int32)
    nnz[: min(n, 2)] = [0, cap][: min(n, 2)]  # an empty row and a full one
    ids = rng.integers(0, dim, (n, cap)).astype(np.int32)
    if kind == "counts":
        values = np.ones((n, cap), np.float32)
    elif kind == "floats":
        values = rng.normal(scale=10.0, size=(n, cap)).astype(np.float32)
    else:  # order-sensitive: huge terms cancel around small ones
        values = rng.choice(np.float32([1e8, 1.0, -1e8, 3.0, -0.0, 0.5]), (n, cap))
    garbage = np.arange(cap)[None, :] >= nnz[:, None]
    ids[garbage] = rng.integers(0, dim, int(garbage.sum()))
    values[garbage] = np.float32(7.0)
    return values, ids, nnz


def _both(fn, jfn, *arrays):
    port = fn(*(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays))
    ref = jfn(*(jnp.asarray(a) for a in arrays))
    return [t.numpy() for t in port], [np.asarray(r) for r in ref]


CASES = [(n, cap, dim, kind) for n, cap in ((1, 1), (7, 1), (33, 4), (64, 16), (50, 64), (9, 128))
         for dim, kind in ((3, "counts"), (50, "floats"), (4, "order"), (1 << 18, "counts"))]


@pytest.mark.parametrize("n,cap,dim,kind", CASES)
def test_combine_is_bit_equal_to_jax(n, cap, dim, kind):
    values, ids, nnz = _entries(n * 1000 + cap + dim, n, cap, dim, kind)
    got, want = _both(sparse_combine_fn, jax_combine, values, ids, nnz)
    for g, w, name in zip(got, want, ("values", "ids", "nnz")):
        _bits_equal(g, w, f"combine {name} n={n} cap={cap} dim={dim} {kind}")
    # the convention's invariant: each row's ids sorted-unique, zero padding
    vals, sids, k = got
    for r in range(n):
        assert np.all(np.diff(sids[r, : k[r]]) > 0)
        assert not sids[r, k[r]:].any() and not vals[r, k[r]:].view(np.uint32).any()


def test_combine_edge_rows():
    cap = 6
    values = np.float32([
        [1e8, 1.0, -1e8, 0, 0, 0],      # one id, order-sensitive: (1e8 + 1) - 1e8 = 0 in f32
        [1.0, 1e8, -1e8, 2.0, 0, 0],    # the same terms in another slot order
        [5, 5, 5, 5, 5, 5],             # all padding (nnz 0)
        [-0.0, -0.0, 2, 2, 2, 2],       # a run of -0.0
        [3, 3, 3, 3, 3, 3],             # a whole row of one id
        [1, 2, 3, 4, 5, 6],
    ])
    ids = np.int32([
        [9, 9, 9, 0, 0, 0],
        [9, 9, 9, 9, 0, 0],
        [1, 2, 3, 4, 5, 6],
        [4, 4, 1, 1, 1, 1],
        [2, 2, 2, 2, 2, 2],
        [5, 3, 5, 2**31 - 2, 0, 3],
    ])
    nnz = np.int32([3, 4, 0, 2, 6, 6])
    got, want = _both(sparse_combine_fn, jax_combine, values, ids, nnz)
    for g, w in zip(got, want):
        _bits_equal(g, w, "edge rows")
    assert got[0][0, 0] == 0.0 and got[2][0] == 1  # the order-sensitive run
    assert got[0][1, 0] == 2.0  # 1 + 1e8 - 1e8 + 2 in slot order
    assert got[2][2] == 0 and got[2][4] == 1 and got[0][4, 0] == 18.0
    assert got[0][3, 0].view(np.uint32) == np.float32(0.0).view(np.uint32)  # -0 + 0 = +0, as JAX


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_and_threshold_are_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    for n, cap in ((1, 1), (17, 8), (40, 64)):
        values = rng.integers(0, 5, (n, cap)).astype(np.float32)
        ids = rng.integers(0, 1000, (n, cap)).astype(np.int32)
        keep = rng.random((n, cap)) < 0.5
        got, want = _both(sparse_compact_fn, jax_compact, values, ids, keep)
        for g, w in zip(got, want):
            _bits_equal(g, w, f"compact {n}x{cap}")
        nnz = rng.integers(0, cap + 1, n).astype(np.int32)
        for thr in (np.full(n, 1.0, np.float32), rng.integers(0, 4, n).astype(np.float32),
                    (np.float32(0.3) * rng.integers(1, 20, n).astype(np.float32))):
            got, want = _both(sparse_threshold_fn, jax_threshold, values, ids, nnz, thr)
            for g, w in zip(got, want):
                _bits_equal(g, w, f"threshold {n}x{cap}")


def _rows(seed, n, max_len, dim):
    rng = np.random.default_rng(seed)
    rows = [[(int(i), float(v)) for i, v in zip(rng.integers(0, dim, k), rng.normal(size=k))]
            for k in rng.integers(0, max_len + 1, n)]
    return rows, [len(r) + int(e) for r, e in zip(rows, rng.integers(0, 3, n))]


@pytest.mark.parametrize("n,max_len", [(0, 0), (1, 0), (5, 1), (40, 9), (30, 64), (12, 100)])
def test_pack_entry_rows_matches_jax(n, max_len):
    rows, lengths = _rows(n + max_len, n, max_len, 1 << 18)
    got = sparse.pack_entry_rows("c", rows, lengths)
    want = jsparse.pack_entry_rows("c", rows, lengths)
    assert got[1:] == want[1:]
    assert list(got[0]) == list(want[0]) == list(sparse.entries_names("c"))
    for name in want[0]:
        _bits_equal(got[0][name], want[0][name], f"pack {name}")
    # a forced rung: truncation for warmup, OffLadderError without it
    natural = got[1]
    for cap in (1, 2, 4, 64):
        if natural > cap:
            with pytest.raises(sparse.OffLadderError):
                sparse.pack_entry_rows("c", rows, lengths, cap=cap)
            with pytest.raises(jsparse.OffLadderError):
                jsparse.pack_entry_rows("c", rows, lengths, cap=cap)
        got = sparse.pack_entry_rows("c", rows, lengths, cap=cap, truncate=True)
        want = jsparse.pack_entry_rows("c", rows, lengths, cap=cap, truncate=True)
        assert got[1:] == want[1:] and got[1] == cap
        for name in want[0]:
            _bits_equal(got[0][name], want[0][name], f"pack {name} cap {cap}")
    for cap_max in (1, 8, 64, 128):
        if natural > cap_max:
            with pytest.raises(sparse.OffLadderError):
                sparse.pack_entry_rows("c", rows, lengths, cap_max=cap_max)
            with pytest.raises(jsparse.OffLadderError):
                jsparse.pack_entry_rows("c", rows, lengths, cap_max=cap_max)
        else:
            assert sparse.pack_entry_rows("c", rows, lengths, cap_max=cap_max)[1] == natural


def test_entries_names_and_spec():
    assert sparse.entries_names("tok") == jsparse.entries_names("tok") == (
        "tok!values", "tok!ids", "tok!nnz", "tok!len")
    for fn in ("values_name", "ids_name", "nnz_name", "len_name"):
        assert getattr(sparse, fn)("x") == getattr(jsparse, fn)("x")
    assert SPARSE_KINDS == ("sparse", "entries")

    def ingest(df, cap, cap_max, truncate):
        raise AssertionError("not called")

    kwargs = dict(input_cols=("tok", "dense"), outputs=(("out", None),), model_arrays={},
                  kernel_fn=lambda m, c: {}, input_kinds={"tok": "entries"},
                  host_ingests={"tok": ingest}, sparse_outputs={"out": 8})
    spec, jspec = KernelSpec(**kwargs), JKernelSpec(**kwargs)
    assert spec.is_sparse and jspec.is_sparse
    for col in ("tok", "dense"):
        assert spec.program_input_names(col) == jspec.program_input_names(col)
    assert spec.program_outputs == jspec.program_outputs
    assert spec.host_ingests == {"tok": ingest}
    kwargs.pop("host_ingests")
    with pytest.raises(ValueError, match="host_ingests"):
        KernelSpec(**kwargs)
    with pytest.raises(ValueError, match="host_ingests"):
        JKernelSpec(**kwargs)

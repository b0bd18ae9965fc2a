"""The port's host-tier training caches against the JAX package on the CPU:
``HostDataCache`` (append, spill to ``.npy`` files read back memory-mapped,
``rows``, ``iter_rows``, ``iter_minibatches``, snapshot/recover),
``create_capacity_cache`` and the ``datacache.*`` / ``train.stream.window.rows``
/ ``native.datacache.enabled`` options, ``iteration/stream.rebatch``, and the
port's own C++ chunk store (``native/datacache.cpp``, built with g++ into
``_build/`` under a hashed name, written to a temporary name and renamed)
behind ``NativeDataCache``.

It mirrors the contracts of the JAX package's ``tests/test_native.py``,
``tests/test_config.py:38/:55/:75`` and the cache half of
``tests/test_streaming.py``. The JAX side here is only ever the pure-Python
``HostDataCache``: the JAX package builds its own chunk store in place,
which races under parallel test workers. Every comparison is exact: the
caches move bytes, they compute nothing.
"""
import os

import numpy as np
import pytest
import torch

from flink_ml_tpu.config import Options as JOptions, config as jconfig, resolve_cache_config as jresolve
from flink_ml_tpu.iteration import HostDataCache as JHostDataCache
from flink_ml_tpu.iteration.stream import rebatch as jrebatch

from flink_ml_tpu_torch.config import Options, config, resolve_cache_config
from flink_ml_tpu_torch.iteration import HostDataCache, create_capacity_cache
from flink_ml_tpu_torch.iteration.stream import rebatch
from flink_ml_tpu_torch.native import NativeChunkStore, load_datacache_lib, native_available
from flink_ml_tpu_torch.native import chunk_store
from flink_ml_tpu_torch.native.cache import NativeDataCache
from flink_ml_tpu_torch.ops.optimizer import SGD

torch.set_num_threads(1)

_OPTIONS = (Options.DATACACHE_SPILL_DIR, Options.DATACACHE_MEMORY_BUDGET_BYTES,
            Options.TRAIN_STREAM_WINDOW_ROWS, Options.NATIVE_DATACACHE_ENABLED)


@pytest.fixture(autouse=True)
def _reset_config():
    yield
    for opt in _OPTIONS:
        config.unset(opt)
    for opt in (JOptions.DATACACHE_SPILL_DIR, JOptions.DATACACHE_MEMORY_BUDGET_BYTES,
                JOptions.TRAIN_STREAM_WINDOW_ROWS, JOptions.NATIVE_DATACACHE_ENABLED):
        jconfig.unset(opt)


def _columns(n=100, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return {"features": rng.standard_normal((n, d)).astype(np.float32),
            "labels": (rng.random(n) > 0.5).astype(np.float32),
            "indices": rng.integers(0, 1000, size=(n, 4)).astype(np.int32)}


def _fill(cache, cols, chunk=13):
    n = len(next(iter(cols.values())))
    for a in range(0, n, chunk):
        cache.append({k: v[a:a + chunk] for k, v in cols.items()})
    cache.finish()
    return cache


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# --- options ---------------------------------------------------------------


def test_option_keys_defaults_and_env_vars_equal_jax(monkeypatch):
    for opt in _OPTIONS:
        jopt = getattr(JOptions, next(k for k, v in vars(Options).items() if v is opt))
        assert (opt.key, opt.default, opt.env_var) == (jopt.key, jopt.default, jopt.env_var)
    assert Options.DATACACHE_SPILL_DIR.env_var == "FLINK_ML_TPU_DATACACHE_SPILL_DIR"
    monkeypatch.setenv("FLINK_ML_TPU_DATACACHE_MEMORY_BUDGET_BYTES", "2048")
    assert config.get(Options.DATACACHE_MEMORY_BUDGET_BYTES) == 2048
    monkeypatch.setenv("FLINK_ML_TPU_NATIVE_DATACACHE_ENABLED", "false")
    assert config.get(Options.NATIVE_DATACACHE_ENABLED) is False
    assert jconfig.get(JOptions.NATIVE_DATACACHE_ENABLED) is False


@pytest.mark.parametrize("args", [(None, None), (100, None), (None, "x"), (5, "y")])
def test_resolve_cache_config_equals_jax(tmp_path, args):
    config.set(Options.DATACACHE_SPILL_DIR, str(tmp_path))
    config.set(Options.DATACACHE_MEMORY_BUDGET_BYTES, 777)
    jconfig.set(JOptions.DATACACHE_SPILL_DIR, str(tmp_path))
    jconfig.set(JOptions.DATACACHE_MEMORY_BUDGET_BYTES, 777)
    assert resolve_cache_config(*args) == jresolve(*args)


def test_host_cache_consumes_config(tmp_path):
    config.set(Options.DATACACHE_SPILL_DIR, str(tmp_path / "spill"))
    config.set(Options.DATACACHE_MEMORY_BUDGET_BYTES, 100)
    cache = HostDataCache()  # no constructor arguments: the config decides
    assert cache.spill_dir == str(tmp_path / "spill") and cache.memory_budget == 100
    cache.append({"x": np.arange(100.0)})
    cache.append({"x": np.arange(100.0)})
    cache.finish()
    assert any("files" in e for e in cache._log), "the configured budget should spill"
    explicit = HostDataCache(memory_budget_bytes=1 << 20, spill_dir=str(tmp_path / "o"))
    assert explicit.memory_budget == 1 << 20  # arguments still win


def test_streamed_sgd_consumes_window_config():
    assert SGD().stream_window_rows == 65_536
    config.set(Options.TRAIN_STREAM_WINDOW_ROWS, 4)
    assert SGD().stream_window_rows == 4
    assert SGD(stream_window_rows=16).stream_window_rows == 16


def test_capacity_cache_factory_respects_toggle(tmp_path):
    config.set(Options.NATIVE_DATACACHE_ENABLED, False)
    assert isinstance(create_capacity_cache(), HostDataCache)
    config.set(Options.NATIVE_DATACACHE_ENABLED, True)
    assert native_available()  # g++ builds it here
    cache = create_capacity_cache(64, str(tmp_path))
    assert isinstance(cache, NativeDataCache)
    _fill(cache, _columns(40))
    assert cache.spilled_chunks > 0


# --- HostDataCache against JAX's ----------------------------------------------


def test_rows_random_access_across_spill_equal_jax(tmp_path):
    cols = _columns()
    cache = _fill(HostDataCache(memory_budget_bytes=600, spill_dir=str(tmp_path / "t")), cols)
    jcache = _fill(JHostDataCache(memory_budget_bytes=600, spill_dir=str(tmp_path / "j")), cols)
    assert any("files" in e for e in cache._log), "the budget should force a spill"
    assert [sorted(e) for e in cache._log] == [sorted(e) for e in jcache._log]
    # the same file names, in a directory of the cache's own
    assert os.listdir(tmp_path / "t") == [os.path.basename(cache._spill_path)]
    assert sorted(os.listdir(cache._spill_path)) == sorted(os.listdir(tmp_path / "j"))
    for start, stop in [(0, 100), (0, 0), (5, 5), (12, 14), (0, 13), (13, 26), (37, 91), (99, 100)]:
        got = cache.rows(start, stop)
        _same(got, jcache.rows(start, stop))
        _same(got, {k: v[start:stop] for k, v in cols.items()})
    for bad in ((90, 101), (-1, 3), (5, 4)):
        with pytest.raises(IndexError):
            cache.rows(*bad)
    assert cache.num_rows == jcache.num_rows == 100


def test_rows_are_copies_never_views_of_a_spill_file(tmp_path):
    cols = _columns(30)
    cache = _fill(HostDataCache(memory_budget_bytes=1, spill_dir=str(tmp_path)), cols, chunk=30)
    got = cache.rows(3, 9)
    assert all(isinstance(v, np.ndarray) and not isinstance(v, np.memmap) and v.flags.writeable
               and v.base is None for v in got.values())
    got["features"][:] = 0.0
    np.testing.assert_array_equal(cache.rows(3, 9)["features"], cols["features"][3:9])
    empty = HostDataCache()
    empty.finish()
    assert empty.rows(0, 0) == {}


def test_iter_rows_and_minibatches_equal_jax(tmp_path):
    cols = _columns(61)
    cache = _fill(HostDataCache(memory_budget_bytes=500, spill_dir=str(tmp_path / "t")), cols, chunk=17)
    jcache = _fill(JHostDataCache(memory_budget_bytes=500, spill_dir=str(tmp_path / "j")), cols, chunk=17)
    for got, want in zip(cache.iter_rows(), jcache.iter_rows(), strict=True):
        _same({k: np.asarray(v) for k, v in got.items()}, {k: np.asarray(v) for k, v in want.items()})
    for batch, drop in ((8, False), (8, True), (17, False), (61, True), (100, False)):
        got = list(cache.iter_minibatches(batch, drop_last=drop))
        want = list(jcache.iter_minibatches(batch, drop_last=drop))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)


@pytest.mark.parametrize("sizes", [[5, 5, 5], [1, 30, 2, 7], [40], []])
@pytest.mark.parametrize("batch", [1, 4, 16])
@pytest.mark.parametrize("drop_last", [False, True])
def test_rebatch_equals_jax(sizes, batch, drop_last):
    rng = np.random.default_rng(sum(sizes) + batch)
    stream = [{"a": rng.standard_normal((n, 2)), "b": rng.integers(0, 9, n)} for n in sizes]
    got = list(rebatch(iter(stream), batch, drop_last=drop_last))
    want = list(jrebatch(iter(stream), batch, drop_last=drop_last))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def test_append_rules():
    cache = HostDataCache()
    with pytest.raises(ValueError, match="inconsistent"):
        cache.append({"a": np.zeros(3), "b": np.zeros(4)})
    cache.append({"a": np.zeros(3)})
    cache.finish()
    with pytest.raises(RuntimeError, match="finished"):
        cache.append({"a": np.zeros(3)})


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port"), ("native", "jax"),
                                            ("jax", "native"), ("port", "native"), ("native", "port")])
def test_snapshots_recover_across_packages_and_tiers(tmp_path, writer, reader):
    kinds = {"port": HostDataCache, "native": NativeDataCache, "jax": JHostDataCache}
    cols = _columns(50)
    src = _fill(kinds[writer](memory_budget_bytes=300, spill_dir=str(tmp_path / "spill")), cols, chunk=11)
    src.snapshot(str(tmp_path / "snap"))
    got = kinds[reader].recover(str(tmp_path / "snap"))
    assert got.num_rows == 50
    _same(got.rows(0, 50), cols)
    _same(got.rows(7, 30), src.rows(7, 30))


@pytest.mark.parametrize("kind", ["port", "native"])
def test_caches_sharing_a_spill_dir_keep_their_own_files(tmp_path, kind):
    """Two caches on one configured spill directory (the ranks of one host,
    or a cache and its recovered copy) each read back their own rows, and
    closing one leaves the other's files."""
    cls = {"port": HostDataCache, "native": NativeDataCache}[kind]
    config.set(Options.DATACACHE_SPILL_DIR, str(tmp_path / "spill"))
    config.set(Options.DATACACHE_MEMORY_BUDGET_BYTES, 1)
    a_cols, b_cols = _columns(40, seed=1), _columns(40, seed=2)
    a, b = _fill(cls(), a_cols), _fill(cls(), b_cols)
    a.snapshot(str(tmp_path / "snap"))
    c = cls.recover(str(tmp_path / "snap"))  # while ``a`` is alive
    assert len(os.listdir(tmp_path / "spill")) == 3
    _same(a.rows(0, 40), a_cols)
    _same(b.rows(0, 40), b_cols)
    _same(c.rows(0, 40), a_cols)
    a.close()
    assert len(os.listdir(tmp_path / "spill")) == 2
    _same(b.rows(3, 37), {k: v[3:37] for k, v in b_cols.items()})
    _same(c.rows(0, 40), a_cols)
    b.close()
    c.close()
    assert os.listdir(tmp_path / "spill") == []


# --- the native chunk store ---------------------------------------------------


def test_chunk_store_round_trip(tmp_path):
    store = NativeChunkStore(1 << 20, str(tmp_path))
    payloads = [os.urandom(n) for n in (1, 100, 5000)]
    for i, p in enumerate(payloads):
        assert store.append(p) == i
    assert len(store) == 3
    for i, p in enumerate(payloads):
        assert store.read(i) == p
    assert store.spilled_chunks == 0 and store.memory_bytes == 5101
    store.close()


def test_chunk_store_spills_over_budget(tmp_path):
    store = NativeChunkStore(1000, str(tmp_path))
    payloads = [os.urandom(600) for _ in range(4)]
    for p in payloads:
        store.append(p)
    assert store.spilled_chunks == 3 and store.memory_bytes == 600
    assert os.listdir(tmp_path) == [os.path.basename(store._spill_path)]  # the store's own directory
    assert len(os.listdir(store._spill_path)) == 3
    for i, p in enumerate(payloads):
        assert store.read(i) == p
    store.close()
    assert os.listdir(tmp_path) == []  # destroy removes its spill files


def test_chunk_store_out_of_range(tmp_path):
    store = NativeChunkStore(1000, str(tmp_path))
    store.append(b"abc")
    for idx in (-1, 1, 5):
        with pytest.raises(IndexError):
            store.read(idx)


def test_native_cache_matches_python_cache(tmp_path):
    cols = _columns(80)
    native = _fill(NativeDataCache(memory_budget_bytes=700, spill_dir=str(tmp_path / "n")), cols, chunk=9)
    python = _fill(HostDataCache(memory_budget_bytes=700, spill_dir=str(tmp_path / "p")), cols, chunk=9)
    assert native.spilled_chunks > 0 and native.num_rows == python.num_rows == 80
    for start, stop in [(0, 80), (0, 0), (3, 4), (8, 10), (17, 71)]:
        _same(native.rows(start, stop), python.rows(start, stop))
    for g, w in zip(native.iter_minibatches(16), python.iter_minibatches(16), strict=True):
        _same(g, w)
    for g, w in zip(native.iter_rows(), python.iter_rows(), strict=True):
        _same(dict(g), {k: np.asarray(v) for k, v in w.items()})


def test_the_library_builds_under_a_hashed_name_through_a_temporary_one(tmp_path, monkeypatch):
    load_datacache_lib()
    lib = chunk_store.library_path()
    assert lib.is_file() and lib.parent.name == "_build" and lib.name.startswith("datacache-")
    # a build writes a temporary name of its own and renames it into place
    replaced = []
    real_replace = os.replace
    monkeypatch.setattr(chunk_store.os, "replace", lambda a, b: (replaced.append((a, b)), real_replace(a, b)))
    target = tmp_path / "lib.so"
    chunk_store._build(target)
    assert target.is_file() and len(replaced) == 1
    assert replaced[0][1] == target and str(replaced[0][0]) != str(target)
    assert os.listdir(tmp_path) == ["lib.so"]
    # a source that does not compile leaves nothing behind
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(chunk_store, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        chunk_store._build(tmp_path / "bad.so")
    assert sorted(os.listdir(tmp_path)) == ["bad.cpp", "lib.so"]

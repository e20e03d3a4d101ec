"""The port's native host library against the JAX package's, on the CPU.

The seven cases of ``tests/test_native.py``. Each runs the port's
``ydb_tpu_torch.native`` on both of its paths (the C++ library it builds
with ``g++`` and the numpy twins) and holds the bits against the
reference's ``ydb_tpu.native`` on the same seeded inputs: ``hash_rows``,
``kway_merge`` and ``BloomFilter`` must be equal on every path.
"""

import os
import shutil

import numpy as np
import pytest

from ydb_tpu import native as rnative
from ydb_tpu_torch import native
from ydb_tpu_torch.native import BloomFilter, build, hash_rows, kway_merge


@pytest.fixture
def both_paths(monkeypatch):
    """Run a fn under (native, numpy twin) and return both results."""
    def run(fn):
        a = fn()
        monkeypatch.setattr(native, "_lib", False)
        b = fn()
        monkeypatch.setattr(native, "_lib", None)
        return a, b
    return run


def test_native_library_builds():
    if os.environ.get("YDB_TPU_TORCH_NO_NATIVE"):
        pytest.skip("native explicitly disabled")
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain; the numpy twins cover behavior")
    assert native.available()
    path = build.ensure_built(strict=True)
    # built beside the checkout, named by its source's hash
    assert os.path.dirname(path) == str(build.BUILD_DIR)
    assert not str(build.BUILD_DIR).startswith(
        os.path.dirname(native.__file__))


def test_hash_rows_native_matches_numpy(both_paths):
    rng = np.random.default_rng(7)
    keys = [rng.integers(-2**40, 2**40, 1000),
            rng.integers(0, 100, 1000)]
    valids = [rng.random(1000) < 0.9, np.ones(1000, dtype=bool)]
    a, b = both_paths(lambda: hash_rows(keys, valids))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, rnative.hash_rows(keys, valids))
    # validity flips change the hash
    v2 = [~valids[0], valids[1]]
    assert (hash_rows(keys, valids) != hash_rows(keys, v2)).any()


def test_kway_merge_native_matches_numpy(both_paths):
    rng = np.random.default_rng(3)
    runs = [np.sort(rng.integers(0, 500, n))
            for n in (100, 0, 57, 333)]
    for dedup in (False, True):
        (ar, ai), (br, bi) = both_paths(
            lambda: kway_merge(runs, dedup=dedup))
        rr, ri = rnative.kway_merge(runs, dedup=dedup)
        for got in ((ar, ai), (br, bi)):
            np.testing.assert_array_equal(got[0], rr)
            np.testing.assert_array_equal(got[1], ri)


def test_kway_merge_order_and_dedup(both_paths):
    runs = [np.array([1, 3, 5]), np.array([1, 2, 5, 9])]
    for run_i, row_i in both_paths(lambda: kway_merge(runs)):
        merged = [int(runs[r][i]) for r, i in zip(run_i, row_i)]
        assert merged == [1, 1, 2, 3, 5, 5, 9]
    for run_i, row_i in both_paths(lambda: kway_merge(runs, dedup=True)):
        merged = [(int(runs[r][i]), int(r)) for r, i in zip(run_i, row_i)]
        # newest-wins: duplicates resolve to the higher run index
        assert merged == [(1, 1), (2, 1), (3, 0), (5, 1), (9, 1)]


def test_kway_merge_empty(both_paths):
    for run_i, row_i in both_paths(lambda: kway_merge([])):
        assert len(run_i) == 0 and len(row_i) == 0
    for run_i, _ in both_paths(lambda: kway_merge(
            [np.empty(0, dtype=np.int64)], dedup=True)):
        assert len(run_i) == 0


def test_bloom_filter_native_matches_numpy(both_paths):
    rng = np.random.default_rng(11)
    present = rng.integers(0, 2**63, 500).astype(np.uint64)
    probes = rng.integers(0, 2**63, 2000).astype(np.uint64)

    def run(mod):
        bf = mod.BloomFilter.for_items(500)
        bf.add(present)
        return bf.bits.copy(), bf.query(np.concatenate([present, probes]))

    (abits, a), (bbits, b) = both_paths(lambda: run(native))
    rbits, r = run(rnative)
    np.testing.assert_array_equal(abits, rbits)
    np.testing.assert_array_equal(bbits, rbits)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, r)
    # no false negatives; false-positive rate sane at 10 bits/item
    assert a[:500].all()
    assert a[500:].mean() < 0.05
    assert isinstance(BloomFilter.for_items(1), BloomFilter)


def test_hash_rows_used_by_shuffle_routing():
    from ydb_tpu_torch.dq.compute import _hash_rows

    payload = {
        "k": np.arange(100, dtype=np.int64),
        "__v_k": np.ones(100, dtype=bool),
    }

    class S:
        names = ("k",)

    h = _hash_rows(payload, S, ("k",))
    assert h.dtype == np.uint64 and len(h) == 100
    np.testing.assert_array_equal(
        h, hash_rows([payload["k"]], [payload["__v_k"]]))
    np.testing.assert_array_equal(
        h, rnative.hash_rows([payload["k"]], [payload["__v_k"]]))


def test_mix64_is_the_reference_mix():
    x = np.random.default_rng(1).integers(0, 2**63, 64).astype(np.uint64)
    np.testing.assert_array_equal(native._mix64(x), rnative._mix64(x))


def test_strict_build_raises_when_disabled(monkeypatch):
    monkeypatch.setenv("YDB_TPU_TORCH_NO_NATIVE", "1")
    assert build.ensure_built() is None
    with pytest.raises(RuntimeError, match="NO_NATIVE"):
        build.ensure_built(strict=True)

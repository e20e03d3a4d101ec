"""The port's equi-join kernels (``ydb_tpu_torch/ssa/join.py``) against the
JAX package's (``ydb_tpu/ssa/join.py``).

Each case builds the same seeded numpy tables in both packages (the port
on the CPU) and joins them with ``lookup_join``, ``expand_join`` and
``run_equi_join``. Inputs include NULL keys, duplicate build keys, an
empty build side, two-column keys with negative values and an expand
join that overflows its first capacity and retries, and a chain of expand
joins whose first capacities the reference compounds. Every output —
data, validity, length, found mask and expand total — must match bit
for bit.
"""

import numpy as np
import pytest
import torch

from ydb_tpu import dtypes as rdt
from ydb_tpu.blocks.block import TableBlock as RBlock
from ydb_tpu.ssa import join as rjoin

from ydb_tpu_torch import dtypes as tdt
from ydb_tpu_torch.blocks.block import TableBlock as TBlock
from ydb_tpu_torch.ssa import join as tjoin

PROBE_FIELDS = (("pk", "INT64"), ("pk2", "INT32"), ("pv", "INT64"),
                ("ps", "STRING"))
BUILD_FIELDS = (("bk", "INT64"), ("bk2", "INT32"), ("bv", "DECIMAL"),
                ("bf", "DOUBLE"))


def _schema(mod, fields, nullable):
    def typ(kind):
        return (mod.decimal(2) if kind == "DECIMAL"
                else getattr(mod, kind))
    return mod.schema(*((n, typ(k), nullable) for n, k in fields))


def _tables(seed, n_probe, n_build, key_hi, null_frac, negative=False):
    rng = np.random.default_rng(seed)
    lo = -key_hi if negative else 0

    def side(n, fields):
        data, valid = {}, {}
        for name, kind in fields:
            if kind == "DOUBLE":
                a = rng.standard_normal(n)
            elif kind in ("INT32", "STRING"):
                a = rng.integers(lo, key_hi, n).astype(np.int32)
            else:
                a = rng.integers(lo, key_hi, n).astype(np.int64)
            data[name] = a
            valid[name] = rng.random(n) >= null_frac
        return data, valid

    return side(n_probe, PROBE_FIELDS), side(n_build, BUILD_FIELDS)


def _blocks(data, valid, fields, nullable=True):
    r = RBlock.from_numpy(data, _schema(rdt, fields, nullable), valid)
    t = TBlock.from_numpy(data, _schema(tdt, fields, nullable), valid,
                          device="cpu")
    return r, t


def assert_blocks_equal(t: TBlock, r, what=""):
    assert int(t.length) == int(r.length), what
    assert t.capacity == r.capacity, what
    assert list(t.schema.names) == list(r.schema.names), what
    for f, rf in zip(t.schema.fields, r.schema.fields):
        assert f.nullable == rf.nullable, (what, f.name)
    td, tv = t.host_columns()
    rd, rv = r.host_columns()
    for name in rd:
        np.testing.assert_array_equal(tv[name], rv[name],
                                      err_msg=f"{what} validity {name}")
        assert td[name].dtype == rd[name].dtype, (what, name)
        # values under NULL are unspecified: compare the valid ones
        np.testing.assert_array_equal(td[name][rv[name]],
                                      rd[name][rv[name]],
                                      err_msg=f"{what} {name}")


CASES = {
    # name: (seed, probe rows, build rows, key range, NULL share, negative)
    "unique_build": (1, 3000, 500, 700, 0.0, False),
    "null_keys": (2, 3000, 500, 700, 0.1, False),
    "duplicate_build_keys": (3, 2000, 900, 150, 0.05, False),
    "negative_keys": (4, 2500, 800, 300, 0.05, True),
    "empty_build": (5, 1500, 0, 100, 0.0, False),
}


@pytest.mark.parametrize("two_keys", [False, True], ids=["1key", "2keys"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lookup_join_matches_reference(case, two_keys):
    (pd, pv), (bd, bv) = _tables(*CASES[case])
    rp, tp = _blocks(pd, pv, PROBE_FIELDS)
    rb, tb = _blocks(bd, bv, BUILD_FIELDS)
    pkeys = ["pk", "pk2"] if two_keys else ["pk"]
    bkeys = ["bk", "bk2"] if two_keys else ["bk"]
    payload = ["bv", "bf", "bk2"]
    rj, rfound = rjoin.lookup_join(rp, rb, pkeys, bkeys, payload, "_b")
    tj, tfound = tjoin.lookup_join(tp, tb, pkeys, bkeys, payload, "_b")
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(rfound))
    assert_blocks_equal(tj, rj, case)
    if case == "empty_build":
        assert not tfound.any()


@pytest.mark.parametrize("kind", ["inner", "left", "semi", "anti"])
@pytest.mark.parametrize("case", ["null_keys", "negative_keys",
                                  "empty_build"])
def test_run_equi_join_lookup_kinds_match_reference(case, kind):
    (pd, pv), (bd, bv) = _tables(*CASES[case])
    rp, tp = _blocks(pd, pv, PROBE_FIELDS)
    rb, tb = _blocks(bd, bv, BUILD_FIELDS)
    payload = ("bv",) if kind in ("inner", "left") else ()
    args = (("pk", "pk2"), ("bk", "bk2"))
    r = rjoin.run_equi_join(rp, rb, *args, kind=kind, payload=payload)
    t = tjoin.run_equi_join(tp, tb, *args, kind=kind, payload=payload)
    assert_blocks_equal(t, r, f"{case}/{kind}")


@pytest.mark.parametrize("kind", ["inner", "left"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_join_matches_reference(case, kind):
    (pd, pv), (bd, bv) = _tables(*CASES[case])
    rp, tp = _blocks(pd, pv, PROBE_FIELDS)
    rb, tb = _blocks(bd, bv, BUILD_FIELDS)
    kw = dict(probe_payload=["pk", "pv", "ps"], build_payload=["bv", "bf"],
              out_capacity=4096, build_suffix="_b", kind=kind)
    r, rtotal = rjoin.expand_join(rp, rb, ["pk"], ["bk"], **kw)
    t, ttotal = tjoin.expand_join(tp, tb, ["pk"], ["bk"], **kw)
    assert ttotal.dtype == torch.int64
    assert int(ttotal) == int(rtotal), case
    assert_blocks_equal(t, r, f"{case}/{kind}")


@pytest.mark.parametrize("kind", ["inner", "left"])
def test_expand_overflow_retries_to_exact_capacity(kind):
    """Duplicate build keys make the reference's first capacity (probe
    capacity x fanout_hint) too small, so it retries at the exact,
    1024-rounded total; the port sizes its one emission at that same
    capacity from the match count (no retry, no compounding guess along
    a chain of expand joins). Both agree on every row."""
    (pd, pv), (bd, bv) = _tables(6, 2000, 3000, 40, 0.02)
    rp, tp = _blocks(pd, pv, PROBE_FIELDS)
    rb, tb = _blocks(bd, bv, BUILD_FIELDS)
    kw = dict(kind=kind, suffix="_b", expand=True,
              probe_payload=("pk", "pv"), build_payload=("bv", "bk2"))
    calls, rcalls = [], []
    real, rreal = tjoin._expand_emit, rjoin.expand_join

    def spy(probe, build, counted, *a):
        out = real(probe, build, counted, *a)
        calls.append((out.capacity, int(counted[-1])))
        return out

    def rspy(*a, **k):
        out = rreal(*a, **k)
        rcalls.append((k["out_capacity"], int(out[1])))
        return out

    tjoin._expand_emit = spy
    rjoin.expand_join = rspy
    try:
        t = tjoin.run_equi_join(tp, tb, ("pk", "pk2"), ("bk", "bk2"), **kw)
        r = rjoin.run_equi_join(rp, rb, ("pk", "pk2"), ("bk", "bk2"),
                                fanout_hint=1.0, **kw)
    finally:
        tjoin._expand_emit = real
        rjoin.expand_join = rreal
    assert len(rcalls) == 2 and rcalls[0][1] > rcalls[0][0], rcalls
    assert calls == [(rcalls[1][0], rcalls[0][1])], (calls, rcalls)
    assert calls[0][0] == -(-calls[0][1] // 1024) * 1024
    assert_blocks_equal(t, r, kind)


def test_expand_join_rejects_other_kinds():
    (pd, pv), (bd, bv) = _tables(*CASES["unique_build"])
    _, tp = _blocks(pd, pv, PROBE_FIELDS)
    _, tb = _blocks(bd, bv, BUILD_FIELDS)
    with pytest.raises(ValueError, match="semi"):
        tjoin.run_equi_join(tp, tb, ("pk",), ("bk",), kind="semi",
                            expand=True)


def test_key_packing_matches_reference():
    """The two-column int64 packing (a << 32) | (b & 0xFFFFFFFF), with
    negative and INT32-extreme parts."""
    from ydb_tpu.blocks.block import Column as RCol

    from ydb_tpu_torch.blocks.block import Column as TCol

    a = np.array([0, -1, 5, -(1 << 31), (1 << 31) - 1, 7], dtype=np.int64)
    b = np.array([0, -1, -5, (1 << 31) - 1, -(1 << 31), 3], dtype=np.int32)
    ok = np.ones(len(a), bool)
    import jax.numpy as jnp

    r = rjoin._key_i64([RCol(jnp.asarray(a), jnp.asarray(ok)),
                        RCol(jnp.asarray(b), jnp.asarray(ok))])
    t = tjoin._key_i64([TCol(torch.from_numpy(a), torch.from_numpy(ok)),
                        TCol(torch.from_numpy(b), torch.from_numpy(ok))])
    np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def test_chained_expand_joins_size_exactly():
    """A chain of three expand joins with few matches: the reference's
    first guess at each join is its probe's capacity x fanout_hint (4),
    and each probe is the last join's output at that guessed capacity,
    so the guesses compound 4x per join; the port sizes every output
    from its match count (1024-rounded). Every joined row agrees."""
    rng = np.random.default_rng(12)
    n = 4000

    def table(**cols):
        data = {k: v.astype(np.int64) for k, v in cols.items()}
        fields = tuple((k, "INT64") for k in data)
        valid = {k: np.ones(len(v), bool) for k, v in data.items()}
        return _blocks(data, valid, fields, nullable=False)

    probe = table(a=rng.permutation(n), pv=rng.integers(0, 99, n))
    b1 = table(a1=rng.integers(0, n, 40), b=rng.integers(0, 30, 40))
    b2 = table(b2=np.arange(30) % 20, c=rng.integers(0, 25, 30))
    b3 = table(c3=np.arange(25), v=rng.integers(0, 9, 25))
    steps = ((b1, ("a",), ("a1",), ("b",)),
             (b2, ("b",), ("b2",), ("c",)),
             (b3, ("c",), ("c3",), ("v",)))

    caps, rcaps = [], []
    real, rreal = tjoin._expand_emit, rjoin.expand_join

    def spy(probe, build, counted, *a):
        out = real(probe, build, counted, *a)
        caps.append((out.capacity, int(counted[-1])))
        return out

    def rspy(*a, **k):
        out = rreal(*a, **k)
        rcaps.append((k["out_capacity"], int(out[1])))
        return out

    tjoin._expand_emit = spy
    rjoin.expand_join = rspy
    try:
        (r, t), payload = probe, ("a", "pv")
        for (rb, tb), pkeys, bkeys, bpay in steps:
            kw = dict(kind="inner", expand=True, probe_payload=payload,
                      build_payload=bpay)
            r = rjoin.run_equi_join(r, rb, pkeys, bkeys, **kw)
            t = tjoin.run_equi_join(t, tb, pkeys, bkeys, **kw)
            payload += bpay
            assert int(t.length) == int(r.length)
            td, _ = t.host_columns()
            rd, _ = r.host_columns()
            for name in rd:
                np.testing.assert_array_equal(td[name], rd[name],
                                              err_msg=name)
    finally:
        tjoin._expand_emit = real
        rjoin.expand_join = rreal
    assert 0 < caps[-1][1] <= 1024, caps
    # no reference retry: each first guess held its matches
    assert len(rcaps) == 3 and all(m <= c for c, m in rcaps), rcaps
    assert [c for c, _ in rcaps[1:]] == [4 * c for c, _ in rcaps[:-1]]
    assert [m for _, m in caps] == [m for _, m in rcaps]
    assert [c for c, _ in caps] == [
        max(-(-m // 1024) * 1024, 1024) for _, m in rcaps]
    assert rcaps[-1][0] >= 64 * caps[-1][0], (caps, rcaps)

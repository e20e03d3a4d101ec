"""The port's TPC-H generator against the JAX package's, on the CPU.

The port formats, sorts and registers its string columns in bulk (fixed-
width byte arrays, each distinct combination joined once, a fresh
dictionary filled in one update); the tables and dictionaries must stay
the reference's bit for bit, for every table, seed and scale.
"""

import numpy as np
import pytest

from ydb_tpu.workload import tpch as rtpch

from ydb_tpu_torch.blocks.dictionary import Dictionary
from ydb_tpu_torch.workload import tpch


@pytest.mark.parametrize("sf,seed", [(0.01, 11), (0.05, 42), (0.002, 7)])
def test_tables_and_dictionaries_equal_the_reference(sf, seed):
    port, ref = tpch.TpchData(sf=sf, seed=seed), rtpch.TpchData(sf=sf,
                                                               seed=seed)
    assert set(port.tables) == set(ref.tables)
    for table, cols in ref.tables.items():
        assert list(port.tables[table]) == list(cols), table
        for name, want in cols.items():
            got = port.tables[table][name]
            assert got.dtype == want.dtype, (table, name)
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert set(port.dicts._dicts) == set(ref.dicts._dicts)
    for name in ref.dicts._dicts:
        assert port.dicts[name].values == ref.dicts[name].values, name
        assert port.dicts[name]._index == ref.dicts[name]._index, name


def test_phones_and_numbered_names_are_the_formatted_strings():
    rng = np.random.default_rng(3)
    nk = rng.integers(0, 25, 200, dtype=np.int32)
    got = tpch.TpchData._phones(np.random.default_rng(9), nk).tolist()
    digits = np.random.default_rng(9).integers(0, 10, (200, 10))
    assert got == [b"%d-%d%d%d-%d%d%d-%d%d%d%d" % ((10 + int(k),) + tuple(d))
                   for k, d in zip(nk, digits)]
    assert tpch._zero_padded(b"Customer#", 12).tolist() == [
        b"Customer#%09d" % k for k in range(1, 13)]


def test_dictionary_extend_is_add_in_turn_or_nothing():
    d, e = Dictionary(), Dictionary()
    vals = [b"b", b"a", b"c"]
    np.testing.assert_array_equal(d.extend(vals),
                                  [e.add(v) for v in vals])
    assert d.values == e.values and d._index == e._index
    with pytest.raises(ValueError):
        d.extend([b"x", b"a"])  # b"a" is present
    with pytest.raises(ValueError):
        d.extend([b"y", b"y"])  # repeated
    assert d.values == [b"b", b"a", b"c"] and len(d._index) == 3

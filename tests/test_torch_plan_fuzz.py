"""The differential plan fuzzer on the port against the JAX package on
the CPU: Seeds 0-49 at maxRows 40 (`tests/torch_fuzz_parity.py`), each
through both packages, and each through the port's own
`run_seed(ablate="one")`."""

import pytest

from torch_fuzz_parity import FuzzPair, check_port_seed


@pytest.fixture(scope="module")
def pair():
    return FuzzPair()


@pytest.mark.parametrize("seed", range(0, 50))
def test_seed_matches_reference(pair, seed):
    pair.check(seed)


@pytest.mark.parametrize("seed", range(0, 50))
def test_seed_port_differential(pair, seed):
    check_port_seed(pair, seed)


#: (seed, maxRows, the group's keys, the aggregate column): a float
#: aggregate over a group whose only value is -0.0, which the JAX
#: package's sort aggregate returns as +0.0 (its `associative_scan` adds
#: zero padding); the port's sort aggregate must do the same.
NEGATIVE_ZERO_GROUPS = [
    (25, 40, {"k": 2}, "ag1_0"),              # min(d)
    (179, 40, {"a": -44, "k": 4}, "ag0_1"),   # min(e)
    (116, 20, {"ag1_1": None}, "ag1_0"),      # sum(c), the NULL-key group
]


@pytest.mark.parametrize("seed,max_rows,keys,column", NEGATIVE_ZERO_GROUPS)
def test_negative_zero_group_matches_reference(pair, seed, max_rows, keys,
                                               column):
    import struct
    got, want = pair.check(seed, max_rows)

    def cell(table):
        rows = [r for r in table.to_pylist()
                if all(r[k] == v for k, v in keys.items())]
        assert len(rows) == 1, rows
        return struct.pack("<d", rows[0][column])

    assert cell(got) == cell(want) == struct.pack("<d", 0.0)


def test_same_result_agrees_with_canonical_bytes():
    """`same_result` (Arrow sorts over bit patterns) says equal exactly
    where `canonical_bytes` does: -0.0 differs from 0.0, NaN payloads
    and row order do not count, NULLs, decimals, strings, dates and
    booleans compare by value."""
    import datetime
    import decimal
    import struct

    import pyarrow as pa
    from spark_tpu_torch.testing.plan_fuzz import canonical_bytes, same_result

    other_nan = struct.unpack("<d", struct.pack("<Q", 0x7FF8000000000001))[0]
    base = {"x": [0.0, 1.0, float("nan"), None],
            "d": [decimal.Decimal("1.50"), None, decimal.Decimal("-2.25"),
                  decimal.Decimal("0.00")],
            "s": ["a", None, "", "b"],
            "t": [datetime.date(1970, 1, 2), None, datetime.date(1969, 5, 1),
                  datetime.date(2000, 1, 1)],
            "b": [True, False, None, True],
            "i": [1, None, -3, 2 ** 40]}
    types = {"x": pa.float64(), "d": pa.decimal128(12, 2), "s": pa.string(),
             "t": pa.date32(), "b": pa.bool_(), "i": pa.int64()}

    def table(cols):
        return pa.table({k: pa.array(v, types[k]) for k, v in cols.items()})

    def variant(**changes):
        cols = {k: list(v) for k, v in base.items()}
        for k, (row, value) in changes.items():
            cols[k][row] = value
        return table(cols)

    reordered = table({k: v[::-1] for k, v in base.items()})
    cases = [reordered, variant(x=(0, -0.0)), variant(x=(2, other_nan)),
             variant(x=(3, float("nan"))), variant(d=(3, None)),
             variant(d=(0, decimal.Decimal("1.51"))), variant(s=(2, None)),
             variant(t=(1, datetime.date(1970, 1, 1))), variant(b=(2, False)),
             variant(i=(1, 0))]
    for case in cases:
        assert same_result(table(base), case) == \
            (canonical_bytes(table(base)) == canonical_bytes(case))
    assert same_result(table(base), reordered)
    assert not same_result(table(base), variant(x=(0, -0.0)))


def test_campaign_seed_count_from_conf():
    """`run_campaign` without seeds runs 0 up to the session's
    `spark_tpu.sql.fuzz.seeds`, as the JAX package's fuzz script does."""
    from spark_tpu_torch import SparkTpuSession
    from spark_tpu_torch.testing import plan_fuzz as PF

    session = SparkTpuSession.builder().device("cpu").config(
        PF.SEEDS_KEY, 3).get_or_create()
    res = PF.run_campaign(session, ablate="none")
    assert res["failures"] == []
    assert res["ok"] == [0, 1, 2]

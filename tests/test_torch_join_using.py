"""The port's `DataFrame.join(other, on=...)` (USING semantics), its `how`
aliases and `cross_join` against the JAX package on the CPU.

Both sides share the key column names and a payload name (`v`), with
NULL keys on both, so a USING join keeps one key column (the left one,
coalesced with the right for right and full joins), drops the right
copies and suffixes the payload collision `_r`. Results must be equal
(`pa.Table.equals`: the rows come out in the same order in both
packages) and the executed plans must print the same after the run.
"""

import itertools

import numpy as np
import pyarrow as pa
import pytest

from spark_tpu import functions as RF
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF

HOWS = ["inner", "left", "right", "full", "left_semi", "left_anti", "cross"]
#: every alias of `_JOIN_ALIASES`, with the join type it stands for
ALIASES = ["outer", "full_outer", "fullouter", "left_outer", "leftouter",
           "right_outer", "rightouter", "semi", "leftsemi", "anti",
           "leftanti"]

_NAMES = itertools.count()


@pytest.fixture(scope="module")
def engines(session):
    """(port session, reference session, table names): a left and a right
    table over the keys k and k2, registered under fresh names."""
    rs = np.random.RandomState(5)
    port = SparkTpuSession.builder().device("cpu").get_or_create()

    def table(n, seed_shift):
        k = rs.randint(0, 6, n)
        return pa.table({
            "k": pa.array(k, pa.int64(), mask=rs.rand(n) < 0.15),
            "k2": pa.array(k % 2, pa.int32()),
            "v": pa.array(np.arange(n, dtype=np.int64) + seed_shift),
            "s": pa.array([f"s{i % 4}" for i in range(n)])})

    names = {}
    for side, n, shift in (("l", 23, 0), ("r", 17, 100)):
        names[side] = f"using_{side}_{next(_NAMES)}"
        t = table(n, shift)
        port.register_table(names[side], t)
        session.register_table(names[side], t)
    return port, session, names


def _check(engines, query):
    port, ref, names = engines
    pqe = query(port, PF, names)._qe()
    rqe = query(ref, RF, names)._qe()
    got, want = pqe.collect(), rqe.collect()
    assert got.equals(want), (got.to_pydict(), want.to_pydict())
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()
    return got


@pytest.mark.parametrize("how", HOWS)
def test_join_on_one_column(engines, how):
    got = _check(engines, lambda s, F, n: s.table(n["l"]).join(
        s.table(n["r"]), on="k", how=how))
    if how not in ("left_semi", "left_anti", "cross"):
        # one key column, the right's payload suffixed
        assert got.column_names == ["k", "k2", "v", "s", "k2_r", "v_r",
                                    "s_r"]


@pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                 "left_semi", "left_anti"])
def test_join_on_two_columns(engines, how):
    _check(engines, lambda s, F, n: s.table(n["l"]).join(
        s.table(n["r"]), on=["k", "k2"], how=how))


@pytest.mark.parametrize("alias", ALIASES)
def test_join_alias(engines, alias):
    _check(engines, lambda s, F, n: s.table(n["l"]).join(
        s.table(n["r"]), on="k", how=alias))


@pytest.mark.parametrize("alias", ALIASES)
def test_join_alias_with_key_expressions(engines, alias):
    _check(engines, lambda s, F, n: s.table(n["l"]).join(
        s.table(n["r"]), left_on=F.col("k2"), right_on=F.col("k2"),
        how=alias))


def test_cross_join(engines):
    got = _check(engines, lambda s, F, n: s.table(n["l"]).cross_join(
        s.table(n["r"])))
    assert got.num_rows == 23 * 17


def test_cross_join_with_condition(engines):
    _check(engines, lambda s, F, n: s.table(n["l"]).crossJoin(
        s.table(n["r"]), F.col("v") * 4 > F.col("v_r")))

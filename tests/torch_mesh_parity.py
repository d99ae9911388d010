"""Shared harness of the `tests/test_torch_mesh*.py` parity tests.

Each case builds the same DataFrame (or SQL text) through a port session
on the CPU and a JAX-package session, both at `spark_tpu.sql.mesh.size`
8: the port runs 8 shard threads all on the CPU device, the JAX package
its 8 virtual CPU devices (`tests/conftest.py`). Then:

- the Arrow results must be equal in order, NULLs included, floats
  within a relative 1e-12 (`torch_sql_parity.assert_tables_match`);
- the executed plans must print the same after the run
  (`tree_string()` and `describe()`), exchanges and their blocks
  included;
- the port at mesh 8 must give the port's mesh-0 rows (compared sorted,
  floats within a relative 1e-9: a sum's order differs across shards).

Each case registers its tables under fresh names: the JAX package keeps
per-session state keyed by printed plans.
"""

from types import SimpleNamespace

import numpy as np
import pyarrow as pa

from spark_tpu import functions as RF
from spark_tpu.session import SparkTpuSession as RefSession
from spark_tpu.window import Window as RefWindow
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.window import Window as PortWindow

from torch_sql_parity import assert_tables_match

MESH = "spark_tpu.sql.mesh.size"

#: the two packages' DataFrame namespaces, so one builder serves both
PORT = SimpleNamespace(F=PF, col=PF.col, lit=PF.lit, Window=PortWindow,
                       name="port")
REF = SimpleNamespace(F=RF, col=RF.col, lit=RF.lit, Window=RefWindow,
                      name="ref")


def sessions(confs=()):
    """(port, reference): fresh sessions, the port's on the CPU."""
    port = SparkTpuSession.builder().device("cpu").get_or_create()
    ref = RefSession(register_active=False)
    for key, value in confs:
        port.conf.set(key, value)
        ref.conf.set(key, value)
    return port, ref


def sorted_table(t: pa.Table) -> pa.Table:
    if t.num_rows == 0 or not t.num_columns:
        return t
    return t.sort_by([(n, "ascending") for n in t.column_names])


def assert_rows_match(got: pa.Table, want: pa.Table) -> None:
    """The same rows in any order; floats within a relative 1e-9."""
    got, want = sorted_table(got), sorted_table(want)
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        if pa.types.is_floating(w.type):
            np.testing.assert_allclose(
                g.to_numpy(zero_copy_only=False),
                w.to_numpy(zero_copy_only=False), rtol=1e-9, err_msg=name)
        else:
            assert g.equals(w), name


def check(port, ref, build, n=8, order=True, plans=True):
    """Run `build(session, ns)` at mesh `n` through both packages and at
    mesh 0 through the port; returns (port qe, reference qe). `order`
    holds the mesh results to the reference's row order too."""
    port.conf.set(MESH, n)
    ref.conf.set(MESH, n)
    try:
        pqe = build(port, PORT)._qe()
        rqe = build(ref, REF)._qe()
        got, want = pqe.collect(), rqe.collect()
        if order:
            assert_tables_match(got, want)
        else:
            assert_rows_match(got, want)
        if plans:
            assert pqe.executed_plan.tree_string() == \
                rqe.executed_plan.tree_string()
            assert pqe.executed_plan.describe() == \
                rqe.executed_plan.describe()
        port.conf.set(MESH, 0)
        one = build(port, PORT)._qe().collect()
        assert_rows_match(got, one)
    finally:
        port.conf.set(MESH, 0)
        ref.conf.set(MESH, 0)
    return pqe, rqe

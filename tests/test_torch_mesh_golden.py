"""The golden-file SQL harness (`tests/test_sql_golden.py`) on the mesh:
every `tests/sql/*.sql` statement at mesh 8 through the port (8 shard
threads on the CPU device), under the aggregate kernel modes `auto` and
`scatter` — the mesh-8 half of the JAX package's conf matrix. The
formatted output must equal the committed `*.sql.out` golden (read,
never written), and the executed plan must print as the JAX package's
at mesh 8 on its 8 virtual devices."""

import glob
import os

import numpy as np
import pandas as pd
import pytest

from test_sql_golden import _fmt
from torch_mesh_parity import MESH, sessions

SQL_DIR = os.path.join(os.path.dirname(__file__), "sql")
KERN = "spark_tpu.sql.aggregate.kernelMode"


@pytest.fixture(scope="module")
def golden_pair():
    pair = sessions(confs=((MESH, 8),))
    rs = np.random.RandomState(21)
    n = 64
    t = pd.DataFrame({
        "k": (np.arange(n) % 4).astype(np.int64),
        "v": rs.randint(0, 40, n).astype(np.int64),
        "s": rs.choice(["ab", "cd", "ef"], n)})
    dim = pd.DataFrame({"k": np.arange(4, dtype=np.int64),
                        "name": ["zero", "one", "two", "three"]})
    for s in pair:
        s.register_table("golden_t", t)
        s.register_table("golden_dim", dim)
    return pair


@pytest.mark.parametrize("mode", ["auto", "scatter"])
@pytest.mark.parametrize("sql_path", sorted(
    glob.glob(os.path.join(SQL_DIR, "*.sql"))),
    ids=lambda p: os.path.basename(p)[:-4])
def test_sql_golden_on_mesh(golden_pair, sql_path, mode):
    port, ref = golden_pair
    with open(sql_path) as f:
        query = f.read()
    with open(sql_path + ".out") as f:
        want = f.read()
    for s in golden_pair:
        s.conf.set(KERN, mode)
    try:
        pqe = port.sql(query)._qe()
        got = _fmt(pqe.collect().to_pandas())
        rqe = ref.sql(query)._qe()
        rqe.collect()
        assert pqe.executed_plan.tree_string() == \
            rqe.executed_plan.tree_string()
    finally:
        for s in golden_pair:
            s.conf.set(KERN, "auto")
    assert "ExchangeExec" in pqe.executed_plan.tree_string()
    assert got == want, f"golden mismatch for {sql_path} ({mode})"

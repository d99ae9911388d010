"""The golden-file SQL harness (`tests/test_sql_golden.py`) through the
port, on the CPU: every `tests/sql/*.sql` statement runs against the
same fixed tables and its formatted output must equal the committed
`*.sql.out` golden (read, never written), under the aggregate kernel
modes `auto` and `scatter` at mesh size 0, with `_fmt` of the JAX
package's harness."""

import glob
import os

import numpy as np
import pandas as pd
import pytest

from spark_tpu_torch import SparkTpuSession
from test_sql_golden import _fmt

SQL_DIR = os.path.join(os.path.dirname(__file__), "sql")
KERN = "spark_tpu.sql.aggregate.kernelMode"


@pytest.fixture(scope="module")
def golden_session():
    session = SparkTpuSession.builder().device("cpu").get_or_create()
    rs = np.random.RandomState(21)
    n = 64
    session.register_table("golden_t", pd.DataFrame({
        "k": (np.arange(n) % 4).astype(np.int64),
        "v": rs.randint(0, 40, n).astype(np.int64),
        "s": rs.choice(["ab", "cd", "ef"], n)}))
    session.register_table("golden_dim", pd.DataFrame({
        "k": np.arange(4, dtype=np.int64),
        "name": ["zero", "one", "two", "three"]}))
    return session


@pytest.mark.parametrize("mode", ["auto", "scatter"])
@pytest.mark.parametrize("sql_path", sorted(
    glob.glob(os.path.join(SQL_DIR, "*.sql"))),
    ids=lambda p: os.path.basename(p)[:-4])
def test_sql_golden(golden_session, sql_path, mode):
    with open(sql_path) as f:
        query = f.read()
    with open(sql_path + ".out") as f:
        want = f.read()
    golden_session.conf.set(KERN, mode)
    try:
        got = _fmt(golden_session.sql(query).to_pandas())
    finally:
        golden_session.conf.set(KERN, "auto")
    assert got == want, f"golden mismatch for {sql_path} ({mode})"

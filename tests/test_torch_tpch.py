"""The port's main path against the JAX package's, end to end on the CPU.

TPC-H Q1, Q3, Q5 and Q6 at SF 0.002 run through both engines on the same
Parquet files: the Arrow results must be equal, both must pass the pandas
golden answer's tolerance, and the executed plans must print the same
tree (with the pushed Parquet filters and the runtime join filters),
before the run and after it. Q3 and Q5 give the same bytes under both
join kernels. The dense `range(n).group_by(id % m)` path is held against
the reference the same way, in each group-by kernel mode. The last tests
guard the package boundary: importing the port loads neither JAX nor the
JAX package, and a session never falls back to the CPU on its own.
"""

import subprocess
import sys

import pytest
import torch

from spark_tpu import functions as RF
from spark_tpu.tpch import queries as RQ
from spark_tpu_torch import SparkTpuSession
from spark_tpu_torch import functions as PF
from spark_tpu_torch.execution import dense_groupby as D
from spark_tpu_torch.execution.executor import plan_nodes
from spark_tpu_torch.plan import physical as P
from spark_tpu_torch.tpch import golden as G
from spark_tpu_torch.tpch import queries as PQ
from spark_tpu_torch.tpch.datagen import write_parquet

SF = 0.002
KERNEL_MODE = "spark_tpu.sql.aggregate.kernelMode"
JOIN_MODE = "spark_tpu.sql.join.kernelMode"


@pytest.fixture(scope="module")
def tpch_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tpch_torch") / "sf_small")
    write_parquet(path, SF)
    return path


@pytest.fixture(scope="module")
def port_session(tpch_path):
    s = SparkTpuSession.builder().device("cpu").get_or_create()
    PQ.register_tables(s, tpch_path)
    return s


@pytest.fixture
def ref_session(session, tpch_path):
    RQ.register_tables(session, tpch_path)
    return session


@pytest.mark.parametrize("qname", ["q1", "q3", "q5", "q6"])
def test_query_arrow_matches_reference(port_session, ref_session, tpch_path,
                                       qname):
    pqe = PQ.QUERIES[qname](port_session)._qe()
    rqe = RQ.QUERIES[qname](ref_session)._qe()
    got, want = pqe.collect(), rqe.collect()
    assert got.schema == want.schema
    assert got.equals(want)
    G.compare(G.normalize_decimals(got.to_pandas()),
              G.GOLDEN[qname](tpch_path))
    # the re-plan loop and the runtime filters' capacity shrink leave
    # the same node state behind
    assert pqe.executed_plan.tree_string() == \
        rqe.executed_plan.tree_string()


@pytest.mark.parametrize("qname,pushed", [
    ("q1", "pushed=['(l_shipdate"), ("q3", "pushed=['(l_shipdate"),
    ("q5", "RuntimeFilterExec(c_nationkey IN bloom(n_nationkey)"),
    ("q6", "pushed=['(l_shipdate")])
def test_executed_plan_matches_reference(port_session, ref_session, qname,
                                         pushed):
    got = PQ.QUERIES[qname](port_session)._qe().executed_plan.tree_string()
    want = RQ.QUERIES[qname](ref_session)._qe().executed_plan.tree_string()
    assert got == want
    assert pushed in got


@pytest.mark.parametrize("qname", ["q3", "q5"])
def test_join_kernels_give_the_same_bytes(tpch_path, qname):
    """The reference's hash-versus-sort invariant: both kernels emit
    matches in sorted-build order, so the results are byte-identical."""
    results = {}
    for mode in ("sort", "hash", "auto"):
        s = SparkTpuSession.builder().device("cpu").config(
            JOIN_MODE, mode).get_or_create()
        PQ.register_tables(s, tpch_path)
        qe = PQ.QUERIES[qname](s)._qe()
        results[mode] = qe.collect()
        kernels = {j.last_kernel[0] for j in
                   plan_nodes(qe.executed_plan, P.JoinExec)}
        assert kernels == ({"sort"} if mode == "auto" else {mode})
    assert results["hash"].equals(results["sort"])
    assert results["auto"].equals(results["sort"])


@pytest.mark.parametrize("mode", ["auto", "matmul", "scatter"])
@pytest.mark.parametrize("m", [1, 12, 700, 3000])
def test_range_group_by_matches_reference(session, mode, m):
    port = SparkTpuSession.builder().device("cpu") \
        .config(KERNEL_MODE, mode).get_or_create()
    session.conf.set(KERNEL_MODE, mode)

    def query(s, F):
        return (s.range(20_000).group_by(F.col("id") % m)
                .agg(F.count(), F.sum(F.col("id")), F.avg(F.col("id"))))

    got = query(port, PF).collect()
    want = query(session, RF).collect()
    assert got.equals(want)
    assert got.num_rows == m


@pytest.mark.parametrize("qname", ["q1", "q5"])
def test_cpu_runs_never_launch_a_kernel(port_session, qname):
    before = dict(D.LAUNCHES)
    PQ.QUERIES[qname](port_session).collect()
    assert D.LAUNCHES == before


def test_group_keys_without_a_domain_take_the_sort_aggregate(
        port_session, ref_session):
    def query(s, F):
        return s.table("lineitem").group_by(F.col("l_orderkey")).agg(
            F.count(), F.sum(F.col("l_quantity")))

    got = query(port_session, PF).collect()
    assert got.equals(query(ref_session, RF).collect())
    assert got.num_rows > 500


def test_import_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import spark_tpu_torch\n"
        "from spark_tpu_torch.tpch import datagen, golden, queries\n"
        "from spark_tpu_torch.execution import dense_groupby\n"
        "import spark_tpu_torch.service.fleet, spark_tpu_torch.ml\n"
        "import spark_tpu_torch.graph\n"
        "import spark_tpu_torch.parallel.cluster\n"
        "import spark_tpu_torch.parallel.launch\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'spark_tpu' or "
        "m.startswith('spark_tpu.'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    """Every import statement in `spark_tpu_torch/` and `chip_smoke.py`,
    including the ones inside functions that the CPU never reaches."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent
    files = sorted((root / "spark_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.name}: {m}" for m in names
                    if m.split(".")[0] in ("jax", "jaxlib", "spark_tpu")]
    assert len(files) > 20 and bad == []
    names = {p.relative_to(root).as_posix() for p in files}
    assert {"spark_tpu_torch/service/fleet.py", "spark_tpu_torch/ml/util.py",
            "spark_tpu_torch/graph/graph.py", "chip_smoke.py",
            "spark_tpu_torch/parallel/cluster.py",
            "spark_tpu_torch/parallel/launch.py"} <= names


def test_session_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SparkTpuSession.builder().get_or_create()
    assert SparkTpuSession.builder().device("cpu").get_or_create().device \
        == torch.device("cpu")

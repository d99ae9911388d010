"""Shared harness of `tests/test_torch_cluster*.py`: a program run on a
two-process CPU cluster, and the comparison of its results with the JAX
package's."""

import os

import numpy as np
import pyarrow as pa

from spark_tpu_torch.parallel.launch import run_cluster

TESTS = os.path.dirname(os.path.abspath(__file__))


def assert_close(got: pa.Table, want: pa.Table) -> None:
    """Equal in order: ints, decimals, strings and validity exactly,
    floats within a relative 1e-9."""
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        if pa.types.is_floating(w.type):
            gv = g.is_valid().to_numpy(zero_copy_only=False)
            wv = w.is_valid().to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(gv, wv, err_msg=name)
            np.testing.assert_allclose(
                g.to_numpy(zero_copy_only=False)[gv],
                w.to_numpy(zero_copy_only=False)[wv], rtol=1e-9,
                err_msg=name)
        else:
            assert g.equals(w), name


def run_cpu_cluster(program: str, out: str, args=None, **kw):
    """`program` (a function of `torch_cluster_programs`) on two engine
    processes, two shards each pinned to the CPU."""
    return run_cluster(f"torch_cluster_programs:{program}", 2, out,
                       device="cpu", args=args, pythonpath=[TESTS],
                       timeout_s=150, **kw)


def run_ok(program: str, out: str, args=None, **kw):
    """`run_cpu_cluster`; every process must exit 0 having loaded no JAX
    module and moved its tensors over gloo."""
    res = run_cpu_cluster(program, out, args, **kw)
    for r in res:
        assert r.returncode == 0, r.log
        assert r.report["bad_modules"] == []
        assert r.report["backends"] == ["gloo"]
    return res

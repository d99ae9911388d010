"""Shared harness of `tests/test_torch_elastic.py` and
`tests/test_torch_mesh_stream.py`: one execution through the port and
then the JAX package (`torch_ooc_parity.Pair`), under the same conf and
fault spec, held to the same rows in the same order (floats within a
relative 1e-9, as `tests/torch_mesh_parity.py` holds mesh results), the
same fault summary and fired rules, and the same deltas of the replay,
restart and rebalance counters.
"""

import warnings

import numpy as np
import pyarrow as pa

COUNTERS = ("rec_chunks_replayed", "mesh_restart_attempts",
            "rebalance_rows", "rec_ckpt_bytes")


def assert_rows_equal(got: pa.Table, want: pa.Table) -> None:
    """The same rows in the same order: floats within a relative 1e-9,
    everything else exactly."""
    assert isinstance(got, pa.Table), got
    assert isinstance(want, pa.Table), want
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name, g, w in zip(want.column_names, got.columns, want.columns):
        if pa.types.is_floating(w.type):
            np.testing.assert_allclose(
                g.to_numpy(zero_copy_only=False),
                w.to_numpy(zero_copy_only=False), rtol=1e-9, err_msg=name)
        else:
            assert g.equals(w), name


def counters(session) -> dict:
    return {k: session.metrics.counter(k).value for k in COUNTERS}


class Run:
    """One execution's outcome in one package."""

    def __init__(self, session, qe, got, plan, before):
        self.session, self.qe, self.got, self.plan = session, qe, got, plan
        after = counters(session)
        self.delta = {k: after[k] - before[k] for k in COUNTERS}


def both(pair, make, spec="", confs=(), collect=True):
    """`make(session)` -> QueryExecution through the port, then the
    reference, each under `confs` and the fault spec; returns their
    Runs. The results, fault summaries, fired rules and the replay,
    restart and rebalance counter deltas must agree."""
    from spark_tpu.testing import faults as ref_faults
    from spark_tpu_torch.testing import faults
    pair.set(*confs)
    runs = []
    for session, fmod in ((pair.port, faults), (pair.ref, ref_faults)):
        before = counters(session)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if spec:
                with fmod.inject(session.conf, spec) as plan:
                    qe = make(session)
                    got = qe.collect() if collect else None
            else:
                plan = None
                qe = make(session)
                got = qe.collect() if collect else None
        runs.append(Run(session, qe, got, plan, before))
        fmod.reset()
    port, ref = runs
    if collect:
        assert_rows_equal(port.got, ref.got)
    assert port.qe.fault_summary == ref.qe.fault_summary
    if spec:
        assert port.plan.fired_log == ref.plan.fired_log
    for k in ("rec_chunks_replayed", "mesh_restart_attempts",
              "rebalance_rows"):
        assert port.delta[k] == ref.delta[k], k
    return port, ref

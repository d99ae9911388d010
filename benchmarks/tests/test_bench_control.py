"""The control of the check: the plain reference in a lower precision,
held to the exact answer, comes out wrong. At the test's sizes float64
already fails Q1 (the scan-aggregate cell); the join queries' sums are
too small for float64 to show, so their cell is held by float32 (see
PERF.md)."""

import control


def test_float64_control_fails_the_scan_aggregate_cell():
    for seed in (11, 22):
        r = control.control_readings("tpch-sf10.q1", seed, scale=0.1,
                                     workers=1)
        assert r["float64"]["q1"] > 0, r


def test_float32_control_fails_the_join_cell():
    r = control.control_readings("tpch-sf1.join", 5, scale=0.01, workers=1,
                                 dtypes=("float32",))
    assert sum(r["float32"].values()) > 0, r

"""The differential plan fuzzer on the port against the JAX package on
the CPU: Seeds 100-149 at maxRows 40 (`tests/torch_fuzz_parity.py`), each
through both packages, and each through the port's own
`run_seed(ablate="one")`."""

import pytest

from torch_fuzz_parity import FuzzPair, check_port_seed


@pytest.fixture(scope="module")
def pair():
    return FuzzPair()


@pytest.mark.parametrize("seed", range(100, 150))
def test_seed_matches_reference(pair, seed):
    pair.check(seed)


@pytest.mark.parametrize("seed", range(100, 150))
def test_seed_port_differential(pair, seed):
    check_port_seed(pair, seed)

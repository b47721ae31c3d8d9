"""The six tests of test_torch_prove.py that take a `case`, at T = 2^14,
b = 512, tau = 8: the port's STARK v1 prove -> verify on the CPU vs the JAX
package. A file of its own, so that a run that gives each file to one worker
builds this case's JAX reference prove beside the other's.

Tolerance: none -- proofs are compared byte for byte."""

import sys

import pytest

sys.path.append("tests")

from test_torch_prove import (  # noqa: F401 -- collected here, on this file's `case`
    _two_torch_threads,
    make_case,
    test_device_route_bytes_equal_reference_and_host_route,
    test_device_route_zero_budgets_give_the_same_bytes,
    test_each_verifier_accepts_the_others_proof,
    test_flipped_byte_is_rejected,
    test_inputs_equal_field_for_field,
    test_proof_bytes_equal_reference,
)


@pytest.fixture(scope="module", params=[(1 << 14, 512, 8)], ids=["T14_b512_tau8"])
def case(request):
    return make_case(*request.param)

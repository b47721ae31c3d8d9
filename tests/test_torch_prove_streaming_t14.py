"""The three proof tests of test_torch_prove_streaming.py at T = 2^14,
b = 512, tau = 8: the port's streaming STARK prove on the CPU vs the JAX
package's streaming and resident proves and the port's resident prove. A
file of its own, so that a run that gives each file to one worker builds
this case's proves beside the other's.

Tolerance: none -- proofs are compared byte for byte."""

import sys

import pytest

sys.path.append("tests")

from test_torch_prove_streaming import (  # noqa: F401 -- collected here, on this file's `case`
    _two_torch_threads,
    make_streaming_case,
    test_each_verifier_accepts_the_others_streaming_proof,
    test_flipped_byte_in_a_streaming_proof_is_rejected,
    test_streaming_proof_bytes_equal_reference_and_resident,
)


@pytest.fixture(scope="module", params=[(1 << 14, 512, 8)], ids=["T14_b512_tau8"])
def case(request):
    return make_streaming_case(*request.param)

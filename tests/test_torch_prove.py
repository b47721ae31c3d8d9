"""The whole path: the port's STARK v1 prove -> verify on the CPU, on
its device-resident route and on its host-columns route (with the device
parts forced by the size thresholds), vs the JAX package.

Tolerance: none -- proofs are compared byte for byte."""

import sys

import numpy as np
import pytest

sys.path.append("tests")

from sezkp_tpu.commit.merkle import commit_blocks as ref_commit_blocks
from sezkp_tpu.crypto import blake3 as ref_blake3
from sezkp_tpu.stark.v1 import proof as ref_proof
from sezkp_tpu.stark.v1.prover import prove_v1 as ref_prove_v1
from sezkp_tpu.stark.v1.verify import verify_v1 as ref_verify_v1
from sezkp_tpu.trace.generator import generate_trace as ref_generate_trace
from sezkp_tpu.trace.partition import partition_trace as ref_partition_trace
from sezkp_tpu_torch import convert
from sezkp_tpu_torch.commit.merkle import commit_blocks
from sezkp_tpu_torch.core.artifact import ProofArtifact
from sezkp_tpu_torch.stark.backends import StarkV1
from sezkp_tpu_torch.stark.v1 import proof as proof_mod
from sezkp_tpu_torch.stark.v1.prover import prove_v1
from sezkp_tpu_torch.stark.v1.verify import verify_v1
from sezkp_tpu_torch.trace.generator import generate_trace
from sezkp_tpu_torch.trace.partition import partition_trace

from test_self_golden import V1_DIGEST
from test_stark_v1 import MANIFEST, demo_blocks

# host-columns route: every other part of the prove takes the device route,
# whatever the size
FORCE_DEVICE = dict(device_cols_min=1 << 62, device_hash_min=0, lde_min_log2=0, fri_min_log2=0)
# and none does (host numpy route of the same prover)
FORCE_HOST = dict(device_cols_min=1 << 62, device_hash_min=1 << 62, lde_min_log2=99, fri_min_log2=99)
# device-resident route (columns derived on the device), whatever the size
DEVICE_ROUTE = dict(device_cols_min=0)
# the same with no memory to spare: roots-scan commit, openings from derived
# ranges, composition slab by slab
ZERO_BUDGETS = dict(device_cols_min=0, cv_budget_bytes=0, release_planes_bytes=0,
                    compose_scan_min_log2=0)
DEVICE_STAGES = {
    "device_columns", "commit", "device_compose", "lde", "fri_commit",
    "air_openings", "fri_openings",
}

FIELDS = (
    "version", "block_id", "step_lo", "step_hi", "ctrl_in", "ctrl_out",
    "in_head_in", "in_head_out",
)


def _blocks_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in FIELDS:
            assert getattr(x, f) == getattr(y, f), f
        for f in ("windows", "head_in_offsets", "head_out_offsets"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f
        for f in ("input_mv", "tape_mv", "write_flag", "write_sym"):
            assert np.array_equal(getattr(x.movement_log, f), getattr(y.movement_log, f)), f
        assert x.pre_tags == y.pre_tags and x.post_tags == y.post_tags


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test workers share the machine: with a full set of OpenMP
    threads in each, the port's proves on the CPU slow down by multiples.
    Two threads keep them quick in any company."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def make_case(t, b, tau):
    """Blocks, manifest and proofs of one case: the port's on its host-columns
    route with the device parts forced, and the JAX package's."""
    ref_blocks = ref_partition_trace(ref_generate_trace(t, tau), b)
    blocks = partition_trace(generate_trace(t, tau), b)
    man = commit_blocks(blocks)
    proof = prove_v1(blocks, man.root, device="cpu", **FORCE_DEVICE)
    ref = ref_prove_v1(ref_blocks, man.root)
    return dict(ref_blocks=ref_blocks, blocks=blocks, man=man, proof=proof, ref=ref)


# T = 2^14, b = 512, tau = 8 runs the same six tests in test_torch_prove_t14.py:
# a file of its own, so that a run that gives each file to one worker builds
# the two JAX reference proves side by side
@pytest.fixture(scope="module", params=[(1 << 13, 256, 2)], ids=["T13_b256_tau2"])
def case(request):
    return make_case(*request.param)


def test_inputs_equal_field_for_field(case):
    _blocks_equal(case["blocks"], case["ref_blocks"])
    _blocks_equal(convert.blocks_from_reference(case["ref_blocks"]), case["blocks"])
    assert case["man"].root == ref_commit_blocks(case["ref_blocks"]).root


def test_proof_bytes_equal_reference(case):
    assert proof_mod.encode_proof(case["proof"]) == ref_proof.encode_proof(case["ref"])


def test_device_route_bytes_equal_reference_and_host_route(case):
    blocks, man = case["blocks"], case["man"]
    want = ref_proof.encode_proof(case["ref"])
    timings = {}
    dev = prove_v1(blocks, man.root, device="cpu", timings=timings)  # n >= 2^13: the default route
    assert set(timings) == DEVICE_STAGES
    assert proof_mod.encode_proof(dev) == want == proof_mod.encode_proof(case["proof"])
    verify_v1(dev, blocks)
    ref_verify_v1(ref_proof.decode_proof(proof_mod.encode_proof(dev)), case["ref_blocks"])


def test_device_route_zero_budgets_give_the_same_bytes(case):
    blocks, man = case["blocks"], case["man"]
    want = proof_mod.encode_proof(case["proof"])
    lean = prove_v1(blocks, man.root, device="cpu", **ZERO_BUDGETS)
    assert proof_mod.encode_proof(lean) == want
    # roots only, but the matrix stays: openings recomputed from it
    mid = prove_v1(blocks, man.root, device="cpu", device_cols_min=0, cv_budget_bytes=0)
    assert proof_mod.encode_proof(mid) == want


def test_each_verifier_accepts_the_others_proof(case):
    port_bytes = proof_mod.encode_proof(case["proof"])
    ref_verify_v1(ref_proof.decode_proof(port_bytes), case["ref_blocks"])
    ref_bytes = ref_proof.encode_proof(case["ref"])
    verify_v1(proof_mod.decode_proof(ref_bytes), case["blocks"])


def test_flipped_byte_is_rejected(case):
    blocks, man = case["blocks"], case["man"]
    art = ProofArtifact(
        backend="stark", manifest_root=man.root,
        proof_bytes=proof_mod.encode_proof(case["proof"]), meta=None,
    )
    StarkV1.verify(art, blocks, man.root)
    pb = bytearray(art.proof_bytes)
    pb[len(pb) // 2] ^= 0x01
    bad = ProofArtifact(backend="stark", manifest_root=man.root, proof_bytes=bytes(pb), meta=None)
    with pytest.raises(Exception):
        StarkV1.verify(bad, blocks, man.root)


def test_host_route_gives_the_same_bytes():
    blocks = partition_trace(generate_trace(1 << 12, 2), 256)
    man = commit_blocks(blocks)
    a = StarkV1.prove(blocks, man.root, device="cpu", **FORCE_DEVICE)
    b = StarkV1.prove(blocks, man.root, device="cpu", **FORCE_HOST)
    c = StarkV1.prove(blocks, man.root, device="cpu")  # default thresholds: host route here
    d = StarkV1.prove(blocks, man.root, device="cpu", **DEVICE_ROUTE)
    e = StarkV1.prove(blocks, man.root, device="cpu", **ZERO_BUDGETS)
    assert a.proof_bytes == b.proof_bytes == c.proof_bytes == d.proof_bytes == e.proof_bytes
    assert a.meta == {"proto": "stark-v1", "domain_n": 1 << 15, "tau": 2}
    StarkV1.verify(a, blocks, man.root)
    with pytest.raises(ValueError):
        StarkV1.verify(a, blocks, bytes(32))


def test_v1_digest_reproduced_on_device_route():
    blocks = convert.blocks_from_reference(demo_blocks(4, 256, tau=2))
    timings = {}
    art = StarkV1.prove(blocks, MANIFEST, device="cpu", timings=timings, **FORCE_DEVICE)
    assert ref_blake3.hash_bytes(art.proof_bytes).hex() == V1_DIGEST
    # StarkV1.prove times the encoding too, after prove_v1's stages
    assert list(timings) == [
        "host_columns", "commit", "host_compose", "lde", "fri_commit",
        "air_openings", "fri_openings", "encode",
    ]
    timings = {}
    art = StarkV1.prove(blocks, MANIFEST, device="cpu", timings=timings, **DEVICE_ROUTE)
    assert ref_blake3.hash_bytes(art.proof_bytes).hex() == V1_DIGEST
    assert set(timings) == DEVICE_STAGES | {"encode"}


def test_no_card_no_cpu_argument_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    blocks = partition_trace(generate_trace(64, 1), 16)
    with pytest.raises(RuntimeError):
        StarkV1.prove(blocks, bytes(32))

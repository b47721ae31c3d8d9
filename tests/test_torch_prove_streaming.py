"""The port's streaming STARK v1 prove (StarkV1.prove_streaming,
StreamingColumnEngine, columns_stream) on the CPU vs the JAX package: the
chunked columns, the streamed roots and openings, and the proof bytes, which
equal the resident proves' of both packages.

Tolerance: none -- column values, digests and proofs are compared exactly."""

import sys

import numpy as np
import pytest

sys.path.append("tests")

from sezkp_tpu.stark.backends import StarkV1 as RefStarkV1
from sezkp_tpu.stark.v1 import columns_stream as ref_cs
from sezkp_tpu.stark.v1 import proof as ref_proof
from sezkp_tpu.stark.v1.openings import StreamingColumnEngine as RefStreamingColumnEngine
from sezkp_tpu.stark.v1.verify import verify_v1 as ref_verify_v1
from sezkp_tpu_torch import convert
from sezkp_tpu_torch.core.artifact import ProofArtifact
from sezkp_tpu_torch.stark.backends import StarkV1
from sezkp_tpu_torch.stark.v1 import columns_stream as cs
from sezkp_tpu_torch.stark.v1 import proof as proof_mod
from sezkp_tpu_torch.stark.v1.columns import TraceColumns, all_labels
from sezkp_tpu_torch.stark.v1.merkle import verify_chunked_open
from sezkp_tpu_torch.stark.v1.openings import ColumnEngine, StreamingColumnEngine
from sezkp_tpu_torch.stark.v1.verify import verify_v1

from test_stark_v1 import demo_blocks
from test_torch_prove import _two_torch_threads, make_case  # noqa: F401 -- the autouse fixture

HOST_STAGES = {"host_columns", "commit", "host_compose", "lde", "fri_commit", "air_openings", "fri_openings"}
# the device parts of the host-columns route at every size (on the CPU: their plain versions)
FORCE_DEVICE_PARTS = dict(lde_min_log2=0, fri_min_log2=0)


@pytest.fixture(scope="module")
def small():
    """Four demo blocks of 16 rows (tau = 2) in both packages' types."""
    ref_blocks = demo_blocks(4, 16, tau=2)
    return ref_blocks, convert.blocks_from_reference(ref_blocks)


def test_block_column_matrix_equals_reference(small):
    ref_blocks, blocks = small
    for rb, b in zip(ref_blocks, blocks):
        m = cs.block_column_matrix(b)
        assert m.dtype == np.uint64
        assert np.array_equal(m, ref_cs.block_column_matrix(rb))


@pytest.mark.parametrize("chunk", [16, 24])
def test_stream_column_chunks_equal_reference_and_columns(small, chunk):
    ref_blocks, blocks = small
    got = list(cs.stream_column_chunks(blocks, chunk))
    want = list(ref_cs.stream_column_chunks(ref_blocks, chunk))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert all(g.shape[1] == chunk for g in got[:-1])
    tc = TraceColumns.build(blocks)
    streamed = np.concatenate(got, axis=1)
    for li, lb in enumerate(all_labels(tc.tau)):
        assert np.array_equal(streamed[li], tc.column_by_label(lb)), lb


@pytest.mark.parametrize("start, end", [(5, 37), (0, 64), (16, 32), (63, 64)])
def test_rows_of_range_equals_reference_and_columns(small, start, end):
    ref_blocks, blocks = small
    m = cs.rows_of_range(blocks, start, end)
    assert np.array_equal(m, ref_cs.rows_of_range(ref_blocks, start, end))
    tc = TraceColumns.build(blocks)
    for li, lb in enumerate(all_labels(tc.tau)):
        assert np.array_equal(m[li], tc.column_by_label(lb)[start:end]), lb


def test_streaming_engine_equals_column_engine_and_reference(small):
    ref_blocks, blocks = small
    tc = TraceColumns.build(blocks)
    mem = ColumnEngine(tc, chunk_log2=4, device="cpu")
    stream = StreamingColumnEngine(blocks, chunk_log2=4)
    ref = RefStreamingColumnEngine(ref_blocks, chunk_log2=4)
    roots = [(c.label, c.root) for c in stream.build_roots()]
    assert roots == [(c.label, c.root) for c in mem.build_roots()]
    assert roots == [(c.label, c.root) for c in ref.build_roots()]
    by_label = dict(roots)
    labels = all_labels(tc.tau)
    rng = np.random.default_rng(0)
    requests = [(labels[int(rng.integers(0, len(labels)))], int(rng.integers(0, tc.n))) for _ in range(12)]
    requests += [(labels[0], 0), (labels[-1], tc.n - 1)]
    fields = ("value_le", "index", "chunk_index", "index_in_chunk", "chunk_root", "path_in_chunk", "path_to_chunk")
    got = stream.open_batch(requests)
    for (label, row), b, a, r in zip(requests, got, mem.open_batch(requests), ref.open_batch(requests)):
        assert [getattr(b, f) for f in fields] == [getattr(a, f) for f in fields] == [getattr(r, f) for f in fields]
        assert verify_chunked_open(by_label[label], label, b.value_le, b.chunk_root, b.index_in_chunk,
                                   b.path_in_chunk, b.chunk_index, b.path_to_chunk)


def make_streaming_case(t, b, tau):
    """make_case's blocks and proofs (the port's prove on its host-columns
    route, the JAX prove), and both packages' streaming proves."""
    c = make_case(t, b, tau)
    c["timings"] = {}
    c["stream"] = StarkV1.prove_streaming(c["blocks"], c["man"].root, device="cpu", timings=c["timings"])
    c["ref_stream"] = RefStarkV1.prove_streaming(c["ref_blocks"], c["man"].root)
    return c


# T = 2^14, b = 512, tau = 8 runs the same three tests in
# test_torch_prove_streaming_t14.py, a file of its own (one worker a file)
@pytest.fixture(scope="module", params=[(1 << 13, 256, 2)], ids=["T13_b256_tau2"])
def case(request):
    return make_streaming_case(*request.param)


def test_streaming_proof_bytes_equal_reference_and_resident(case):
    got = case["stream"]
    assert got.proof_bytes == case["ref_stream"].proof_bytes
    assert got.proof_bytes == ref_proof.encode_proof(case["ref"])
    assert got.proof_bytes == proof_mod.encode_proof(case["proof"])
    assert got.meta == case["ref_stream"].meta
    assert got.meta["mode"] == "streaming"
    # the host-columns route at every size, whatever the other thresholds say
    assert set(case["timings"]) == HOST_STAGES | {"encode"}
    forced = StarkV1.prove_streaming(case["blocks"], case["man"].root, device="cpu", **FORCE_DEVICE_PARTS)
    assert forced.proof_bytes == got.proof_bytes


def test_each_verifier_accepts_the_others_streaming_proof(case):
    ref_verify_v1(ref_proof.decode_proof(case["stream"].proof_bytes), case["ref_blocks"])
    verify_v1(proof_mod.decode_proof(case["ref_stream"].proof_bytes), case["blocks"])
    StarkV1.verify(case["stream"], case["blocks"], case["man"].root)


def test_flipped_byte_in_a_streaming_proof_is_rejected(case):
    art = case["stream"]
    pb = bytearray(art.proof_bytes)
    pb[len(pb) // 2] ^= 0x01
    bad = ProofArtifact(backend=art.backend, manifest_root=art.manifest_root, proof_bytes=bytes(pb), meta=art.meta)
    with pytest.raises(Exception):
        StarkV1.verify(bad, case["blocks"], case["man"].root)


def test_streaming_prove_without_device_needs_the_card(small):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    _, blocks = small
    with pytest.raises(RuntimeError, match="CUDA device"):
        StarkV1.prove_streaming(blocks, bytes(32))

"""The chunked tops-only FRI of the port's DeviceFri (on the CPU) against the
JAX package's DeviceFri in its chunked mode, the host FRI and the port's
resident mode; and the port's prove_v1 with the chunked FRI against the JAX
package's host prove.

Tolerance: none -- roots, final values, queries and proofs are compared byte
for byte."""

import sys

import numpy as np
import pytest

sys.path.append("tests")

from sezkp_tpu.crypto.transcript import Blake3Transcript
from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.stark.v1 import params
from sezkp_tpu.stark.v1 import proof as ref_proof
from sezkp_tpu.stark.v1.fri import fri_commit, fri_open_query, fri_verify, layer_tree
from sezkp_tpu.stark.v1.prover import prove_v1 as ref_prove_v1
from sezkp_tpu.trace.generator import generate_trace as ref_generate_trace
from sezkp_tpu.trace.partition import partition_trace as ref_partition_trace
from sezkp_tpu_torch.commit.merkle import commit_blocks
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.stark.backends import StarkV1
from sezkp_tpu_torch.stark.v1 import proof as proof_mod
from sezkp_tpu_torch.stark.v1.fri_device import CHUNK_LOG2, FRI_CHUNKED_MIN_LOG2, SEG_LOG2, DeviceFri
from sezkp_tpu_torch.stark.v1.prover import prove_v1
from sezkp_tpu_torch.stark.v1.verify import verify_v1
from sezkp_tpu_torch.trace.generator import generate_trace
from sezkp_tpu_torch.trace.partition import partition_trace

from test_torch_prove import _two_torch_threads  # noqa: F401 -- the autouse fixture

LABEL = "fri-chunked"


def _vals(n_log2: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, int(G.P), 1 << n_log2, dtype=np.uint64)


def _rows(n_log2: int, seed: int) -> list:
    """Random query rows, three of them in one chunk and one the pair
    (idx ^ half) of another, so that chunks are shared within and across
    layers."""
    n = 1 << n_log2
    rows = [int(r) for r in np.random.default_rng(seed).integers(0, n, 6)]
    base = rows[0] & ~((1 << CHUNK_LOG2) - 1)
    return rows + [base, base + 1, base + (1 << CHUNK_LOG2) - 1, rows[1] ^ (n >> 1)]


def _commit(eng, n_log2: int):
    """Drive an engine through the transcript schedule of fri_commit:
    (roots, final value bytes, betas)."""
    tr = Blake3Transcript(LABEL)
    root0 = eng.commit_layer0()
    tr.absorb(params.DS_FRI_LAYER_ROOT, root0)
    betas = params.derive_betas_for_fri(tr, n_log2)
    rest = eng.commit_rest(betas)
    return [root0] + rest, eng.final_value_le(), betas


def _host(vals: np.ndarray, rows: list):
    roots, layers, betas = fri_commit(Blake3Transcript(LABEL), vals)
    trees = [layer_tree(layer) for layer in layers]
    queries = [fri_open_query(layers, trees, r) for r in rows]
    return roots, G.to_le_bytes(layers[-1][0]).tobytes(), betas, queries


def _same_queries(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.positions == b.positions
        assert a.pairs == b.pairs


@pytest.mark.parametrize("n_log2", [13, 14])
def test_chunked_equals_jax_chunked_and_host(n_log2, monkeypatch):
    """Several segments a layer (seg_log2 = 12): layer 0 of 2^14 is four
    segments, and the segment order of the chunk roots shows in the root."""
    from sezkp_tpu.stark.v1 import fri_device as FD

    vals = _vals(n_log2, n_log2)
    rows = _rows(n_log2, 7 + n_log2)
    roots_h, final_h, betas_h, want = _host(vals, rows)

    monkeypatch.setenv("SEZKP_FRI_CHUNKED_MIN_LOG2", "12")
    monkeypatch.setattr(FD, "SEG_LOG2", 12)
    ref = FD.DeviceFri(vals)
    assert ref._big
    roots_r, final_r, betas_r = _commit(ref, n_log2)
    ref_q = ref.open_queries(rows)

    eng = DeviceFri(FT.pack(vals), chunked_min_log2=12, seg_log2=12)
    assert eng.chunked
    roots, final, betas = _commit(eng, n_log2)
    got = eng.open_queries(rows)

    assert betas == betas_r == betas_h
    assert roots == roots_r == roots_h
    assert final == final_r == final_h
    _same_queries(got, ref_q)
    _same_queries(got, want)
    fri_verify(Blake3Transcript(LABEL), roots_h, got, final)


@pytest.mark.parametrize("min_layer", [5, 11, 12])
@pytest.mark.parametrize("n_log2", [12, 13, 14, 15])
def test_chunked_equals_resident_and_host(n_log2, min_layer):
    """Both modes at several domain sizes and device-layer floors. The
    chunked mode keeps device layers of one chunk (2^11) and more; at
    n = 2^12 its only folded device layer is exactly one chunk."""
    vals = _vals(n_log2, 100 + n_log2)
    rows = _rows(n_log2, min_layer)
    roots_h, final_h, _, want = _host(vals, rows)
    seg_log2 = max(CHUNK_LOG2, n_log2 - 2)  # four segments in layer 0
    chunked = DeviceFri(FT.pack(vals), min_device_layer_log2=min_layer, chunked_min_log2=0,
                        seg_log2=seg_log2)
    resident = DeviceFri(FT.pack(vals), min_device_layer_log2=min_layer, chunked_min_log2=64)
    assert chunked.chunked and not resident.chunked
    for eng in (chunked, resident):
        roots, final, _ = _commit(eng, n_log2)
        assert roots == roots_h
        assert final == final_h
        _same_queries(eng.open_queries(rows), want)
    assert chunked._dev_layers == max(1, n_log2 - max(min_layer, CHUNK_LOG2))
    assert resident._dev_layers == max(1, n_log2 - min_layer)


def test_mode_switch_and_its_guard():
    assert (CHUNK_LOG2, SEG_LOG2, FRI_CHUNKED_MIN_LOG2) == (11, 21, 26)
    # below one chunk and a pair, the chunked mode is never taken
    assert not DeviceFri(FT.pack(_vals(11, 1)), chunked_min_log2=0).chunked
    assert not DeviceFri(FT.pack(_vals(12, 1))).chunked  # the default threshold
    assert DeviceFri(FT.pack(_vals(12, 1)), chunked_min_log2=12).chunked
    with pytest.raises(ValueError):
        DeviceFri(FT.pack(_vals(12, 1)), chunked_min_log2=0, seg_log2=CHUNK_LOG2 - 1)


@pytest.fixture(scope="module")
def case():
    """T = 2^13, b = 256, tau = 2 in both packages, and the JAX package's
    (host) proof of it."""
    ref_blocks = ref_partition_trace(ref_generate_trace(1 << 13, 2), 256)
    blocks = partition_trace(generate_trace(1 << 13, 2), 256)
    man = commit_blocks(blocks)
    return dict(blocks=blocks, man=man, ref=ref_prove_v1(ref_blocks, man.root))


def test_prove_with_chunked_fri_equals_reference(case):
    """T = 2^13 (LDE 2^16) on the device-resident route with the chunked FRI
    from LDE 2^14 up, against the JAX package's host prove; the streaming
    prove takes the host-columns route's DeviceFri, chunked too."""
    blocks, man = case["blocks"], case["man"]
    want = ref_proof.encode_proof(case["ref"])
    timings = {}
    proof = prove_v1(blocks, man.root, device="cpu", fri_chunked_min_log2=14, timings=timings)
    assert {"device_compose", "fri_commit_chunked"} <= set(timings)
    assert proof_mod.encode_proof(proof) == want
    verify_v1(proof, blocks)

    timings = {}
    art = StarkV1.prove_streaming(blocks, man.root, device="cpu", fri_chunked_min_log2=14,
                                  timings=timings)
    assert {"host_compose", "fri_commit_chunked"} <= set(timings)
    assert art.proof_bytes == want

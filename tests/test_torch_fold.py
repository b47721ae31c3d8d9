"""The port's fold line (sezkp_tpu_torch.fold) on the CPU: the cases of
tests/test_fold.py run on the port, and the port held against the JAX package
on the same blocks -- proof bytes, streamed .cborseq bytes, roots, and each
side verifying the other's proof.

Tolerance: none -- every comparison is of bytes or of exact values.

The balanced prove is also run with its MAC batches sent through the device
dispatch (device_hash_min=1, device="cpu": the plain version of kernel K7),
which must change no byte; the verifier must never reach that dispatch.
Everywhere else the proves name device="cpu": the default device is the CUDA
card, and a prove without one raises."""

import numpy as np
import pytest
import torch

from sezkp_tpu.commit.merkle import commit_blocks
from sezkp_tpu.core.prover import StreamingProver as RefStreamingProver
from sezkp_tpu.fold.backend import FoldBackend as RefFoldBackend
from sezkp_tpu.fold.gadgets import CryptoLeaf as RefCryptoLeaf
from sezkp_tpu.trace.generator import generate_trace
from sezkp_tpu.trace.partition import partition_trace
from sezkp_tpu_torch.convert import blocks_from_reference
from sezkp_tpu_torch.core.prover import StreamingProver
from sezkp_tpu_torch.crypto import blake3
from sezkp_tpu_torch.fold import batch as fold_batch
from sezkp_tpu_torch.fold import devhash
from sezkp_tpu_torch.fold.api import Commitment, DriverOptions, FoldMode, commit_pi
from sezkp_tpu_torch.fold.are import CombineAux, InterfaceWitness, Pi, combine
from sezkp_tpu_torch.fold.backend import (
    FoldBackend,
    bundle_top,
    decode_envelope,
    encode_envelope_v2,
)
from sezkp_tpu_torch.fold.driver import (
    BundleCollectorSink,
    FoldProofBundle,
    StreamDriverSink,
    run_pipeline,
)
from sezkp_tpu_torch.fold.gadgets import CryptoFold, CryptoLeaf, CryptoWrap
from sezkp_tpu_torch.fold.verify import verify_bundle, verify_stream
from sezkp_tpu_torch.ops import blake3_torch as BT
from sezkp_tpu_torch.stark import backends
from sezkp_tpu_torch.utils import cbor

ENV_MODE = "SEZKP_FOLD_MODE"
ENV_WRAP = "SEZKP_WRAP_CADENCE"
ENV_STREAM = "SEZKP_PROOF_STREAM_PATH"


def _inputs(tau, t=128, b=8):
    ref = partition_trace(generate_trace(t, tau), b)
    return ref, blocks_from_reference(ref), commit_blocks(ref)


@pytest.fixture(scope="module")
def inputs():
    return _inputs(3)


@pytest.fixture(scope="module")
def blocks(inputs):
    return inputs[1]


@pytest.fixture(scope="module")
def manifest(inputs):
    return inputs[2]


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts the calls of K7's plain version (the CPU stand-in of a launch)."""
    calls = []
    real = BT.hash_many_words_plain

    def counted(m, msg_len):
        calls.append((msg_len, m.shape[1]))
        return real(m, msg_len)

    monkeypatch.setattr(BT, "hash_many_words_plain", counted)
    return calls


# ------------------- the cases of tests/test_fold.py, on the port -----------


def test_leaf_prove_verify_and_tamper(blocks):
    pi, c, pr = CryptoLeaf.prove_leaf(blocks[0])
    assert CryptoLeaf.verify_leaf(c, commit_pi(pi), pr)
    bad_pi = Pi(pi.ctrl_in, pi.ctrl_out, pi.flags, (pi.acc[0] ^ 1,) + pi.acc[1:])
    assert not CryptoLeaf.verify_leaf(c, commit_pi(bad_pi), pr)
    pub = pr.public
    swapped = type(pub)(
        ctrl_in=pub.ctrl_in,
        ctrl_out=pub.ctrl_out,
        flags=pub.flags,
        acc_limbs=pub.acc_limbs[2:] + pub.acc_limbs[:2],
        left_tail_digest=pub.right_head_digest,
        right_head_digest=pub.left_tail_digest,
    )
    assert not CryptoLeaf.verify_leaf(c, commit_pi(pi), type(pr)(swapped, pr.proof_mac, pr.mac))


def test_fold_gadget_roundtrip(blocks):
    pi0, c0, _ = CryptoLeaf.prove_leaf(blocks[0])
    pi1, c1, _ = CryptoLeaf.prove_leaf(blocks[1])
    iface = InterfaceWitness(pi0.ctrl_out, pi1.ctrl_in, b"\x01" * 32)
    c_par, pi_par, pf = CryptoFold.fold((c0, pi0), (c1, pi1), iface)
    assert CryptoFold.verify_fold(
        (c_par, commit_pi(pi_par)), (c0, commit_pi(pi0)), (c1, commit_pi(pi1)), pf
    )
    bad = Commitment(b"\x02" * 32, c_par.len)
    assert not CryptoFold.verify_fold(
        (bad, commit_pi(pi_par)), (c0, commit_pi(pi0)), (c1, commit_pi(pi1)), pf
    )


def test_wrap_gadget(blocks):
    pi, c, _ = CryptoLeaf.prove_leaf(blocks[0])
    w = CryptoWrap.wrap((c, pi))
    assert CryptoWrap.verify_wrap((c, commit_pi(pi)), w)
    assert not CryptoWrap.verify_wrap((Commitment(b"\x09" * 32, 1), commit_pi(pi)), w)


def test_combine_is_associative_on_acc():
    a = Pi(0, 0, 1, (1, 2, 3, 4))
    b = Pi(0, 0, 2, (5, 6, 7, 8))
    c = Pi(0, 0, 4, (9, 1, 1, 1))
    aux = CombineAux()
    lhs = combine(combine(a, b, aux), c, aux)
    rhs = combine(a, combine(b, c, aux), aux)
    assert lhs.acc == rhs.acc and lhs.flags == rhs.flags


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 16])
def test_balanced_equals_minram(n):
    bl = blocks_from_reference(partition_trace(generate_trace(n * 4, 2), 4))
    assert len(bl) == n
    b1 = run_pipeline(bl, DriverOptions(fold_mode=FoldMode.BALANCED))
    b2 = run_pipeline(bl, DriverOptions(fold_mode=FoldMode.MINRAM, endpoint_cache=8))
    assert bundle_top(b1) == bundle_top(b2)
    verify_bundle(b1)
    verify_bundle(b2)


def test_fold_root_equals_manifest_root(blocks, manifest):
    top_c, _ = bundle_top(run_pipeline(blocks, DriverOptions()))
    assert top_c.root == manifest.root


def test_streaming_driver_matches_batch(blocks, manifest):
    sink = BundleCollectorSink()
    drv = StreamDriverSink(sink, DriverOptions())
    for b in blocks:
        drv.push_block(b)
    root_c, root_pi = drv.finish()
    assert root_c.root == manifest.root
    batch = run_pipeline(blocks, DriverOptions())
    assert bundle_top(batch) == (root_c, root_pi)
    assert sum(1 for it in sink.items if it[0] == "fold") == len(batch.folds)


def test_backend_batch_roundtrip(blocks, manifest):
    art = FoldBackend.prove(blocks, manifest.root, device="cpu")
    assert art.manifest_root == manifest.root
    FoldBackend.verify(art, [], manifest.root)
    bundle_bytes, root_c, root_pi, is_cbor = decode_envelope(art.proof_bytes)
    assert is_cbor and root_c.root == manifest.root
    assert encode_envelope_v2(bundle_bytes, root_c, root_pi) == art.proof_bytes


def test_backend_streaming_roundtrip(tmp_path, monkeypatch, blocks, manifest):
    monkeypatch.setenv(ENV_STREAM, str(tmp_path / "proof.cborseq"))
    sp = StreamingProver(FoldBackend)
    art = sp.prove_stream_iter(iter(blocks), manifest.root)
    assert art.manifest_root == manifest.root
    sp.verify_stream_iter(art, iter(blocks), manifest.root)


def test_stream_tamper_detected(tmp_path, monkeypatch, blocks, manifest):
    path = tmp_path / "proof.cborseq"
    monkeypatch.setenv(ENV_STREAM, str(path))
    StreamingProver(FoldBackend).prove_stream_iter(iter(blocks), manifest.root)
    data = bytearray(path.read_bytes())
    data[200] ^= 0xFF
    with pytest.raises(Exception):
        verify_stream(bytes(data))


def test_bundle_cbor_roundtrip(blocks):
    bundle = run_pipeline(blocks[:4], DriverOptions(wrap_cadence=1))
    data = cbor.dumps(bundle.to_obj())
    b2 = FoldProofBundle.from_obj(cbor.loads(data))
    assert cbor.dumps(b2.to_obj()) == data
    verify_bundle(b2)


def test_pi_serde_roundtrip():
    pi = Pi(3, 4, 5, (11, 22, 33, 44))
    assert Pi.from_obj(pi.to_obj()) == pi


@pytest.mark.parametrize("wrap_cadence", [0, 3])
def test_batched_pipeline_matches_sequential(blocks, wrap_cadence):
    a = run_pipeline(blocks, DriverOptions(wrap_cadence=wrap_cadence))
    b = fold_batch.run_pipeline_batched(
        blocks, DriverOptions(wrap_cadence=wrap_cadence, device="cpu"))
    assert cbor.dumps(a.to_obj()) == cbor.dumps(b.to_obj())
    verify_bundle(b)


def test_batched_leaf_proofs_match(blocks):
    want = [CryptoLeaf.prove_leaf(b) for b in blocks]
    got = fold_batch.batch_leaf_proofs(blocks)
    assert len(got) == len(want)
    for (p1, c1, leaf1), (p2, c2, leaf2) in zip(got, want):
        assert p1 == p2 and c1 == c2
        assert (leaf1.public, leaf1.proof_mac, leaf1.mac) == (leaf2.public, leaf2.proof_mac, leaf2.mac)


# ----------------------- the port against the JAX package -------------------


@pytest.mark.parametrize("tau", [2, 3, 8])
@pytest.mark.parametrize("wrap_cadence", [0, 2])
@pytest.mark.parametrize("mode", ["balanced", "minram"])
def test_prove_bytes_equal_the_reference(monkeypatch, mode, wrap_cadence, tau):
    ref_blocks, port_blocks, man = _inputs(tau)
    monkeypatch.setenv(ENV_MODE, mode)
    monkeypatch.setenv(ENV_WRAP, str(wrap_cadence))
    ref = RefFoldBackend.prove(ref_blocks, man.root)
    port = FoldBackend.prove(port_blocks, man.root, device="cpu")
    assert port.proof_bytes == ref.proof_bytes
    assert port.manifest_root == ref.manifest_root == man.root
    assert port.meta == ref.meta
    # each side verifies the other's proof
    FoldBackend.verify(ref, [], man.root)
    RefFoldBackend.verify(port, [], man.root)
    if wrap_cadence:
        assert port.meta["wraps"] > 0


@pytest.mark.parametrize("tau", [2, 8])
@pytest.mark.parametrize("wrap_cadence", [0, 2])
def test_streamed_bytes_equal_the_reference(tmp_path, monkeypatch, wrap_cadence, tau):
    ref_blocks, port_blocks, man = _inputs(tau)
    monkeypatch.setenv(ENV_WRAP, str(wrap_cadence))
    ref_path, port_path = tmp_path / "ref.cborseq", tmp_path / "port.cborseq"
    monkeypatch.setenv(ENV_STREAM, str(ref_path))
    ref = RefStreamingProver(RefFoldBackend).prove_stream_iter(iter(ref_blocks), man.root)
    monkeypatch.setenv(ENV_STREAM, str(port_path))
    sp = StreamingProver(FoldBackend)
    port = sp.prove_stream_iter(iter(port_blocks), man.root)
    assert port_path.read_bytes() == ref_path.read_bytes()
    assert port.manifest_root == ref.manifest_root == man.root
    # each side verifies the other's stream; the streamed root is the batched one
    sp.verify_stream_iter(ref, iter(port_blocks), man.root)
    RefStreamingProver(RefFoldBackend).verify_stream_iter(port, iter(ref_blocks), man.root)
    batched = FoldBackend.prove(port_blocks, man.root, device="cpu")
    assert batched.manifest_root == port.manifest_root


def test_leaf_gadget_equals_the_reference(inputs):
    ref_blocks, port_blocks, _ = inputs
    for rb, pb in zip(ref_blocks[:4], port_blocks[:4]):
        rpi, rc, rpr = RefCryptoLeaf.prove_leaf(rb)
        pi, c, pr = CryptoLeaf.prove_leaf(pb)
        assert (pi.acc, c.root, pr.proof_mac, pr.mac) == (rpi.acc, rc.root, rpr.proof_mac, rpr.mac)


@pytest.mark.parametrize("at", ["middle", "root", "bundle-length"])
def test_tampered_proof_rejected(blocks, manifest, at):
    art = FoldBackend.prove(blocks, manifest.root, device="cpu")
    pb = bytearray(art.proof_bytes)
    pos = {"middle": len(pb) // 2, "root": len(pb) - 60, "bundle-length": 8}[at]
    pb[pos] ^= 0x01
    bad = type(art)(backend=art.backend, manifest_root=art.manifest_root,
                    proof_bytes=bytes(pb), meta=art.meta)
    with pytest.raises(Exception):
        FoldBackend.verify(bad, [], manifest.root)
    with pytest.raises(ValueError):
        FoldBackend.verify(art, [], b"\x00" * 32)


# ------------------------------ the device dispatch -------------------------


@pytest.mark.parametrize("tau", [2, 8])
def test_device_hashed_prove_equals_host_hashed(monkeypatch, plain_calls, tau):
    # blocks of 32 steps, so that the boundary windows are full (32 steps) and
    # the message lengths are those of a real prove
    _, port_blocks, man = _inputs(tau, t=256, b=32)
    monkeypatch.setenv(ENV_WRAP, "2")
    before = BT.hash_many_words.launches
    host = FoldBackend.prove(port_blocks, man.root, device_hash_min=0)
    assert plain_calls == []  # device_hash_min = 0: host hashing only, no device asked for
    small = FoldBackend.prove(port_blocks, man.root, device="cpu")
    assert small.proof_bytes == host.proof_bytes
    assert plain_calls == []  # 8 blocks: every batch is below the default threshold
    timings = {}
    dev = FoldBackend.prove(port_blocks, man.root, device="cpu", device_hash_min=1,
                            timings=timings)
    assert dev.proof_bytes == host.proof_bytes
    assert len(plain_calls) > 0 and len(plain_calls) == timings["hash_batches"] - _host_batches(tau)
    assert timings["hash_messages"] > 0 and 0 < timings["hash"] <= timings["pipeline"]
    # tau = 2: the 812- and 813-byte boundary messages go through the
    # dispatch too; tau = 8: only the MACs and commitments do (its boundary
    # messages, 3164 and 3165 bytes, are longer than a chunk)
    longest = max(length for length, _ in plain_calls)
    assert longest == (813 if tau == 2 else 677)  # 677: the fold/merge transcript
    n_calls = len(plain_calls)
    FoldBackend.verify(dev, [], man.root)
    assert len(plain_calls) == n_calls  # the verifier hashes on the host
    assert BT.hash_many_words.launches == before  # no kernel launch on the CPU


def _host_batches(tau):
    """Batches of a balanced prove that stay on the host whatever the
    threshold, because their messages exceed one chunk: the interface digests,
    and at tau = 8 the two boundary digests."""
    return 1 if tau == 2 else 3


def test_threshold_splits_batches_by_size(plain_calls, blocks, manifest):
    art = FoldBackend.prove(blocks, manifest.root, device="cpu", device_hash_min=8)
    assert plain_calls and min(n for _, n in plain_calls) >= 8
    assert art.proof_bytes == FoldBackend.prove(blocks, manifest.root, device_hash_min=0).proof_bytes


def test_minram_and_streamed_never_reach_the_dispatch(tmp_path, monkeypatch, plain_calls,
                                                      blocks, manifest):
    monkeypatch.setenv(ENV_MODE, "minram")
    FoldBackend.prove(blocks, manifest.root, device="cpu", device_hash_min=1)
    monkeypatch.delenv(ENV_MODE)
    monkeypatch.setenv(ENV_STREAM, str(tmp_path / "p.cborseq"))
    sp = StreamingProver(FoldBackend)
    sp.verify_stream_iter(sp.prove_stream_iter(iter(blocks), manifest.root), iter(blocks),
                          manifest.root)
    assert plain_calls == []


def test_hash_many_auto_dispatch_rule(plain_calls):
    rng = np.random.default_rng(11)
    short = rng.integers(0, 256, (6, 124), dtype=np.uint8)
    long_ = rng.integers(0, 256, (6, 1025), dtype=np.uint8)
    want = blake3.hash_many(short)
    # threshold 0: host, whatever the device argument
    assert np.array_equal(devhash.hash_many_auto(short, device_hash_min=0), want)
    assert np.array_equal(devhash.hash_many_auto(short, "cpu", 0), want)
    assert plain_calls == []
    # the default threshold is positive: a batch of that size takes the device path
    assert DriverOptions().device_hash_min == devhash.DEVICE_HASH_MIN > 0
    many = rng.integers(0, 256, (devhash.DEVICE_HASH_MIN, 71), dtype=np.uint8)
    assert np.array_equal(devhash.hash_many_auto(many, "cpu"), blake3.hash_many(many))
    assert plain_calls == [(71, devhash.DEVICE_HASH_MIN)]
    plain_calls.clear()
    # below the threshold, or longer than a chunk: host
    assert np.array_equal(devhash.hash_many_auto(short, "cpu", 7), want)
    assert np.array_equal(devhash.hash_many_auto(long_, "cpu", 1), blake3.hash_many(long_))
    assert plain_calls == []
    # at the threshold: the device path
    assert np.array_equal(devhash.hash_many_auto(short, "cpu", 6), want)
    assert plain_calls == [(124, 6)]
    # the card is the default device, and its absence is an error, not a detour
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            devhash.hash_many_auto(short, None, 1)


def test_default_prove_raises_without_a_card(blocks, manifest):
    """The balanced prove runs on the card unless the caller names the CPU or
    asks for the host hasher: without a card it raises, at any size."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError):
        FoldBackend.prove(blocks, manifest.root)
    with pytest.raises(RuntimeError):
        FoldBackend.prove(blocks, manifest.root, device_hash_min=1)
    with pytest.raises(RuntimeError):
        fold_batch.run_pipeline_batched(blocks, DriverOptions())
    host = FoldBackend.prove(blocks, manifest.root, device_hash_min=0)
    assert host.proof_bytes == FoldBackend.prove(blocks, manifest.root, device="cpu").proof_bytes


def test_backends_module_exports_the_fold_backend():
    assert backends.FoldBackend is FoldBackend and backends.FoldAgg is FoldBackend

"""The port's file layer (core/io.py, trace/io.py, trace/stream.py and the
file half of commit/merkle.py) on the cases of tests/test_trace.py that cover
it, and against the JAX package: the same arguments give the same bytes.

Tolerance: none -- bytes and integers."""

import numpy as np
import pytest

from sezkp_tpu.commit import merkle as ref_merkle
from sezkp_tpu.core import io as ref_io
from sezkp_tpu.trace import stream as ref_stream
from sezkp_tpu_torch.commit import merkle
from sezkp_tpu_torch.core import io as core_io
from sezkp_tpu_torch.trace import io as trace_io
from sezkp_tpu_torch.trace import stream
from sezkp_tpu_torch.trace.format import TraceFile
from sezkp_tpu_torch.trace.generator import generate_trace
from sezkp_tpu_torch.trace.partition import partition_trace
from sezkp_tpu_torch.utils import cbor


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("ext", ["cbor", "jsonl"])
def test_simulate_stream_bytes_identical(tmp_path, ext):
    """Chunked generate + partition + append write == the materialized path
    == the JAX package's file, with chunk boundaries that split the ChaCha12
    buffer mid-draw."""
    t, b, tau = 1000, 16, 3  # non-pow2, partial final block
    blocks = partition_trace(generate_trace(t, tau), b)
    ref_path = str(tmp_path / f"ref.{ext}")
    core_io.write_block_summaries_auto(ref_path, blocks)
    got_path = str(tmp_path / f"got.{ext}")
    assert stream.simulate_stream(t, b, tau, got_path, chunk_steps=48) == len(blocks)
    assert _read(got_path) == _read(ref_path)
    jax_path = str(tmp_path / f"jax.{ext}")
    ref_stream.simulate_stream(t, b, tau, jax_path, chunk_steps=48)
    assert _read(got_path) == _read(jax_path)


def test_trace_chunk_rng_state_carries():
    t, tau = 513, 2
    ref = generate_trace(t, tau).steps
    for chunk in (1, 7, 64, 513, 1000):
        got = list(stream.iter_trace_chunks(t, tau, chunk))
        assert np.array_equal(np.concatenate([g.input_mv for g in got]), ref.input_mv)
        assert np.array_equal(np.concatenate([g.tape_mv for g in got]), ref.tape_mv)
        assert np.array_equal(np.concatenate([g.write_flag for g in got]), ref.write_flag)
        assert np.array_equal(np.concatenate([g.write_sym for g in got]), ref.write_sym)


@pytest.mark.parametrize("tau,expect_fast", [(8, True), (24, False)])
def test_simulate_stream_fast_and_fallback_encoders(tmp_path, tau, expect_fast):
    t, b = 512, 64
    ml = next(stream.iter_trace_chunks(t, tau, t))
    assert (stream._encode_log_rows(ml) is not None) == expect_fast
    ref_path = str(tmp_path / "ref.cbor")
    core_io.write_block_summaries_auto(ref_path, partition_trace(generate_trace(t, tau), b))
    got_path = str(tmp_path / "got.cbor")
    stream.simulate_stream(t, b, tau, got_path, chunk_steps=128)
    assert _read(got_path) == _read(ref_path)


def test_stream_block_summaries_cbor_windowed(tmp_path):
    p = str(tmp_path / "blocks.cbor")
    stream.simulate_stream(3000, 128, 4, p, chunk_steps=512)
    ref = core_io.read_block_summaries_auto(p)
    got = list(core_io.stream_block_summaries_cbor(p, window_bytes=2048))
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        assert a.to_obj() == b.to_obj()
    # and the JAX package reads the same blocks from the port's file
    assert [x.to_obj() for x in ref_io.read_block_summaries_auto(p)] == [x.to_obj() for x in ref]


def test_stream_cbor_rejects_trailing_bytes(tmp_path):
    p = str(tmp_path / "blocks.cbor")
    stream.simulate_stream(1024, 128, 2, p, chunk_steps=512)
    with open(p, "ab") as f:
        f.write(b"\x00garbage")
    with pytest.raises(ValueError, match="trailing bytes"):
        list(core_io.stream_block_summaries_cbor(p, window_bytes=1024))
    with pytest.raises(ValueError, match="trailing bytes"):
        list(core_io.stream_block_summaries_cbor(p, window_bytes=1 << 23))


def test_stream_cbor_corruption_raises_promptly(tmp_path):
    """A corrupt byte raises without refilling the window to the end of the file."""
    p = str(tmp_path / "blocks.cbor")
    stream.simulate_stream(4096, 128, 2, p, chunk_steps=512)
    data = bytearray(_read(p))
    d = cbor.CBORDecoder(bytes(data))
    ib = d._read(1)[0]
    d._read_uint(ib & 0x1F)  # array count
    d.decode()  # first element
    data[d.pos] = 0x1C  # reserved additional-info 28: invalid anywhere
    with open(p, "wb") as f:
        f.write(bytes(data))

    reads = []
    real_open = open

    class CountingFile:
        def __init__(self, f):
            self._f = f

        def read(self, n=-1):
            b = self._f.read(n)
            reads.append(len(b))
            return b

        def __enter__(self):
            return self

        def __exit__(self, *a):
            self._f.close()

    core_io.open = lambda *a, **k: CountingFile(real_open(*a, **k))
    try:
        with pytest.raises(ValueError):
            list(core_io.stream_block_summaries_cbor(p, window_bytes=16384))
    finally:
        del core_io.open
    assert len(reads) <= 2


@pytest.mark.parametrize("blocks_ext,man_ext", [("cbor", "cbor"), ("jsonl", "json"), ("json", "cbor")])
def test_commit_block_file_equals_batch_and_jax(tmp_path, blocks_ext, man_ext, capsys):
    """The streaming frontier over a blocks file == commit_blocks on the list
    == the JAX package's manifest bytes; verify accepts it and rejects a
    manifest of another file."""
    blocks = partition_trace(generate_trace(777, 3), 16)
    bp = str(tmp_path / f"blocks.{blocks_ext}")
    core_io.write_block_summaries_auto(bp, blocks)
    mp = str(tmp_path / f"manifest.{man_ext}")
    man = merkle.commit_block_file(bp, mp)
    assert man == merkle.commit_blocks(blocks)
    assert merkle.read_manifest_auto(mp) == man
    jp = str(tmp_path / f"jax_manifest.{man_ext}")
    ref_merkle.commit_block_file(bp, jp)
    assert _read(mp) == _read(jp)
    merkle.verify_block_file_against_manifest(bp, mp)
    ref_merkle.verify_block_file_against_manifest(bp, mp)

    other = str(tmp_path / f"other.{blocks_ext}")
    core_io.write_block_summaries_auto(other, blocks[:-1])
    with pytest.raises(ValueError, match="mismatch"):
        merkle.verify_block_file_against_manifest(other, mp)
    bad = str(tmp_path / "manifest.txt")
    with open(bad, "wb"):
        pass
    with pytest.raises(ValueError, match="unsupported manifest extension"):
        merkle.read_manifest_auto(bad)


@pytest.mark.parametrize("n", [0, 1, 2, 255, 256, 257, 700])
def test_frontier_equals_batch_root(n):
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    want = merkle.merkle_root(leaves)
    one = merkle.Frontier()
    for h in leaves:
        one.push_leaf(h.tobytes())
    bulk = merkle.Frontier()
    bulk.push_leaves(leaves[: n // 3])
    bulk.push_leaves(leaves[n // 3 :])
    # the whole batch into an empty frontier: from 256 leaves up this pushes a
    # subtree root at level 8 of a frontier that has no slots yet
    whole = merkle.Frontier()
    whole.push_leaves(leaves)
    ref = ref_merkle.Frontier()
    for h in leaves:
        ref.push_leaf(h.tobytes())
    assert one.finalize_root() == want == bulk.finalize_root() == whole.finalize_root() == ref.finalize_root()
    assert one.n == bulk.n == whole.n == n


@pytest.mark.parametrize("ext", ["cbor", "json"])
def test_proof_and_trace_files_roundtrip(tmp_path, ext):
    from sezkp_tpu_torch.core.artifact import BackendKind, ProofArtifact

    art = ProofArtifact(backend=BackendKind.STARK, manifest_root=bytes(range(32)),
                        proof_bytes=b"\x00\x01\xfe\xff" * 9, meta={"proto": "x", "n": 3})
    p = str(tmp_path / f"proof.{ext}")
    core_io.write_proof_auto(p, art)
    assert core_io.read_proof_auto(p) == art
    assert ref_io.read_proof_auto(p).proof_bytes == art.proof_bytes
    jp = str(tmp_path / f"jax_proof.{ext}")
    ref_io.write_proof_auto(jp, ref_io.read_proof_auto(p))
    assert _read(p) == _read(jp)

    tf = generate_trace(64, 2)
    tp = str(tmp_path / f"trace.{ext}")
    trace_io.write_trace_auto(tp, tf)
    back = trace_io.read_trace_auto(tp)
    assert isinstance(back, TraceFile) and back.steps == tf.steps

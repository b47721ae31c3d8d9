"""The port's command line (sezkp_tpu_torch.cli) on the CPU: the five cases of
tests/test_cli.py with --device cpu, and parity with the JAX package's CLI:
the same arguments write byte-identical files, and each CLI verifies the
other's.

Tolerance: none -- file bytes."""

import os

import pytest

from sezkp_tpu import cli as ref_cli
from sezkp_tpu_torch import cli
from sezkp_tpu_torch.core.io import read_block_summaries_auto, stream_block_summaries_jsonl

CPU = ["--device", "cpu"]


def run(args, main=cli.main):
    rc = main(args)
    assert rc == 0 or rc is None


@pytest.fixture()
def ws(tmp_path):
    return str(tmp_path)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_full_pipeline_fold_streaming(ws):
    blocks = os.path.join(ws, "blocks.jsonl")
    manifest = os.path.join(ws, "manifest.cbor")
    proof = os.path.join(ws, "proof.cbor")
    run(["simulate", "--t", "128", "--b", "16", "--tau", "3", "--out-blocks", blocks])
    run(["commit", "--blocks", blocks, "--out", manifest])
    run(["verify-commit", "--blocks", blocks, "--manifest", manifest])
    run(["prove", "--backend", "fold", "--blocks", blocks, "--manifest", manifest,
         "--out", proof, "--fold-mode", "minram", "--fold-cache", "8", "--stream", *CPU])
    assert os.path.exists(os.path.join(ws, "proof.cborseq"))
    run(["verify", "--backend", "fold", "--blocks", blocks, "--manifest", manifest,
         "--proof", proof])


def test_full_pipeline_stark_v0(ws):
    blocks = os.path.join(ws, "blocks.cbor")
    manifest = os.path.join(ws, "manifest.json")
    proof = os.path.join(ws, "proof.json")
    run(["simulate", "--t", "64", "--b", "8", "--tau", "2", "--out-blocks", blocks])
    run(["commit", "--blocks", blocks, "--out", manifest])
    run(["prove", "--backend", "stark-v0", "--blocks", blocks, "--manifest", manifest,
         "--out", proof, "--assume-committed", *CPU])
    run(["verify", "--backend", "stark-v0", "--blocks", blocks, "--manifest", manifest,
         "--proof", proof, "--assume-committed"])


def test_export_jsonl_roundtrip(ws):
    blocks = os.path.join(ws, "blocks.cbor")
    out = os.path.join(ws, "blocks.jsonl")
    run(["simulate", "--t", "32", "--b", "4", "--tau", "2", "--out-blocks", blocks])
    run(["export-jsonl", "--input", blocks, "--output", out])
    assert read_block_summaries_auto(blocks) == list(stream_block_summaries_jsonl(out))


def test_verify_rejects_corrupted_stream(ws):
    blocks = os.path.join(ws, "blocks.jsonl")
    manifest = os.path.join(ws, "manifest.cbor")
    proof = os.path.join(ws, "proof.cbor")
    run(["simulate", "--t", "64", "--b", "8", "--tau", "2", "--out-blocks", blocks])
    run(["commit", "--blocks", blocks, "--out", manifest])
    run(["prove", "--backend", "fold", "--blocks", blocks, "--manifest", manifest,
         "--out", proof, "--stream", "--assume-committed", *CPU])
    stream = os.path.join(ws, "proof.cborseq")
    data = bytearray(_read(stream))
    data[len(data) // 2] ^= 0xFF
    with open(stream, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(Exception):
        cli.main(["verify", "--backend", "fold", "--blocks", blocks,
                  "--manifest", manifest, "--proof", proof, "--assume-committed"])


def test_full_pipeline_stark_v1(ws):
    blocks = os.path.join(ws, "blocks.cbor")
    manifest = os.path.join(ws, "manifest.cbor")
    proof = os.path.join(ws, "proof.cbor")
    run(["simulate", "--t", "4096", "--b", "64", "--tau", "2", "--out-blocks", blocks])
    run(["commit", "--blocks", blocks, "--out", manifest])
    run(["prove", "--backend", "stark", "--blocks", blocks, "--manifest", manifest,
         "--out", proof, *CPU])
    run(["verify", "--backend", "stark", "--blocks", blocks, "--manifest", manifest,
         "--proof", proof])
    data = bytearray(_read(proof))
    data[len(data) // 2] ^= 0x40
    bad = os.path.join(ws, "proof_bad.cbor")
    with open(bad, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(Exception):
        run(["verify", "--backend", "stark", "--blocks", blocks,
             "--manifest", manifest, "--proof", bad])


# ------------------------------ parity with the JAX package's CLI ------------


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """One input made by both CLIs: (port dir, reference dir), blocks.cbor,
    blocks.jsonl, manifest.cbor and manifest.json in each."""
    dirs = []
    for name, main in (("port", cli.main), ("ref", ref_cli.main)):
        d = str(tmp_path_factory.mktemp(name))
        for ext in ("cbor", "jsonl"):
            run(["simulate", "--t", "4096", "--b", "64", "--tau", "2",
                 "--out-blocks", os.path.join(d, f"blocks.{ext}")], main)
        for ext in ("cbor", "json"):
            run(["commit", "--blocks", os.path.join(d, "blocks.cbor"),
                 "--out", os.path.join(d, f"manifest.{ext}")], main)
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("name", ["blocks.cbor", "blocks.jsonl", "manifest.cbor", "manifest.json"])
def test_simulate_and_commit_files_identical(pair, name):
    port, ref = pair
    assert _read(os.path.join(port, name)) == _read(os.path.join(ref, name))
    run(["verify-commit", "--blocks", os.path.join(ref, "blocks.jsonl"),
         "--manifest", os.path.join(port, "manifest.json")])
    run(["verify-commit", "--blocks", os.path.join(port, "blocks.cbor"),
         "--manifest", os.path.join(ref, "manifest.cbor")], ref_cli.main)


PROVES = {
    "fold": (["--backend", "fold"], "blocks.cbor", ["fold.cbor"]),
    "fold-minram-stream": (["--backend", "fold", "--stream", "--fold-mode", "minram", "--fold-cache", "8"],
                           "blocks.jsonl", ["stream.cborseq"]),
    "stark-v0": (["--backend", "stark-v0"], "blocks.cbor", ["v0.cbor"]),
    "stark": (["--backend", "stark"], "blocks.cbor", ["v1.cbor"]),
    "stark-stream": (["--backend", "stark", "--stream"], "blocks.cbor", ["v1s.cbor"]),
}


@pytest.mark.parametrize("case", sorted(PROVES))
def test_proof_files_identical_and_cross_verified(pair, case, monkeypatch):
    flags, blocks_name, files = PROVES[case]
    port, ref = pair
    out_name = files[0].replace(".cborseq", ".cbor")
    for var in ("SEZKP_FOLD_MODE", "SEZKP_FOLD_CACHE", "SEZKP_WRAP_CADENCE", "SEZKP_PROOF_STREAM_PATH"):
        monkeypatch.delenv(var, raising=False)

    def args(d, verb, key):
        return [verb, *flags[:2], "--blocks", os.path.join(d, blocks_name),
                "--manifest", os.path.join(d, "manifest.cbor"), key, os.path.join(d, out_name)]

    run([*args(port, "prove", "--out"), *flags[2:], *CPU])
    run([*args(ref, "prove", "--out"), *flags[2:]], ref_cli.main)
    for name in files:
        assert _read(os.path.join(port, name)) == _read(os.path.join(ref, name)), name
    if case != "fold-minram-stream":
        # the artifact files too (a streamed artifact names its sidecar's path)
        assert _read(os.path.join(port, out_name)) == _read(os.path.join(ref, out_name))
    # each CLI verifies the other's files
    run(args(ref, "verify", "--proof"))
    run(args(port, "verify", "--proof"), ref_cli.main)


def test_prove_without_device_needs_the_card(pair):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a card")
    port, _ = pair
    common = ["--blocks", os.path.join(port, "blocks.cbor"), "--manifest", os.path.join(port, "manifest.cbor")]
    for backend in ("stark", "fold"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            cli.main(["prove", "--backend", backend, *common, "--out", os.path.join(port, "never.cbor")])
    assert not os.path.exists(os.path.join(port, "never.cbor"))
    # stark-v0 is host code: it takes no device and needs no card
    out = os.path.join(port, "v0_no_device.cbor")
    assert cli.main(["prove", "--backend", "stark-v0", *common, "--out", out]) == 0
    assert cli.main(["verify", "--backend", "stark-v0", *common, "--proof", out]) == 0


def test_device_hash_min_reaches_the_backends(pair, monkeypatch):
    """--device and --device-hash-min travel as keywords through
    StreamingProver to the backend's prove."""
    from sezkp_tpu_torch.stark import backends

    port, _ = pair
    seen = {}

    def fake_prove(blocks, root, **options):
        seen.update(options)
        raise KeyboardInterrupt  # stop before any proving

    monkeypatch.setattr(backends.FoldBackend, "prove", staticmethod(fake_prove))
    with pytest.raises(KeyboardInterrupt):
        cli.main(["prove", "--backend", "fold", "--blocks", os.path.join(port, "blocks.cbor"),
                  "--manifest", os.path.join(port, "manifest.cbor"), "--assume-committed",
                  "--out", os.path.join(port, "never.cbor"), "--device-hash-min", "7", *CPU])
    assert seen["device_hash_min"] == 7 and str(seen["device"]) == "cpu"

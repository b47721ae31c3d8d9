"""sezkp-tpu-torch CLI — the PyTorch/CUDA port's command line, with the
surface and semantics of the reference CLI (counterpart of sezkp_tpu/cli.py).

Subcommands (reference: crates/sezkp-cli/src/main.rs:82-209):
  simulate | commit | verify-commit | export-jsonl | prove | verify

`prove --backend stark | fold` runs on the CUDA card unless `--device cpu` is
given, and raises where there is none; `--backend stark-v0` and every other
subcommand are host code.

Examples:
  python -m sezkp_tpu_torch simulate --t 32768 --b 512 --tau 8 --out-blocks blocks.cbor
  python -m sezkp_tpu_torch commit --blocks blocks.cbor --out manifest.cbor
  python -m sezkp_tpu_torch prove --backend fold --blocks blocks.jsonl \
      --manifest manifest.cbor --out proof.cbor --fold-mode minram \
      --fold-cache 64 --stream
  python -m sezkp_tpu_torch verify --backend fold --blocks blocks.jsonl \
      --manifest manifest.cbor --proof proof.cbor
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

log = logging.getLogger("sezkp_tpu_torch")


def cmd_simulate(args) -> int:
    from .core import io as core_io
    from .trace.generator import generate_trace
    from .trace.partition import partition_trace
    from .utils.tracing import command

    if args.b > args.t:
        log.error("number of blocks b (%d) cannot exceed trace length T (%d)", args.b, args.t)
        return 1
    log.info("generating synthetic trace t=%d tau=%d", args.t, args.tau)
    ext = args.out_blocks.rsplit(".", 1)[-1].lower()
    with command("simulate", t=args.t, b=args.b, tau=args.tau):
        if ext in ("cbor", "jsonl", "ndjson"):
            # streaming: generate + partition + write in bounded chunks
            # (RSS stays ~chunk-size; bytes identical to the resident path)
            from .trace.stream import simulate_stream

            n_blocks = simulate_stream(args.t, args.b, args.tau, args.out_blocks)
        else:
            trace = generate_trace(args.t, args.tau)
            blocks = partition_trace(trace, args.b)
            core_io.write_block_summaries_auto(args.out_blocks, blocks)
            n_blocks = len(blocks)
    print(f"Simulated {args.t} steps -> {n_blocks} blocks -> {args.out_blocks}")
    return 0


def cmd_commit(args) -> int:
    from .commit.merkle import commit_block_file

    commit_block_file(args.blocks, args.out)
    return 0


def cmd_verify_commit(args) -> int:
    from .commit.merkle import verify_block_file_against_manifest

    verify_block_file_against_manifest(args.blocks, args.manifest)
    print("OK: blocks match manifest")
    return 0


def cmd_export_jsonl(args) -> int:
    from .core import io as core_io

    n = 0
    with open(args.output, "w") as f:
        import json

        for blk in core_io.stream_block_summaries_auto(args.input):
            json.dump(blk.to_obj(), f, separators=(",", ":"))
            f.write("\n")
            n += 1
    print(f"Exported {n} blocks -> {args.output}")
    return 0


def _backend_for(name: str):
    if name == "fold":
        from .fold.backend import FoldBackend

        return FoldBackend
    if name == "stark":
        from .stark.backends import StarkV1

        return StarkV1
    if name == "stark-v0":
        from .stark.backends import StarkIOP

        return StarkIOP
    raise ValueError(f"unknown backend {name}")


def cmd_prove(args) -> int:
    from .commit.merkle import read_manifest_auto, verify_block_file_against_manifest
    from .core import io as core_io
    from .core.prover import StreamingProver
    from .ops._kernels import resolve_device
    from .utils.config import ENV_KEYS
    from .utils.tracing import command

    # stark and fold run on the card unless --device says otherwise, and raise
    # where there is none; stark-v0 is host code and takes no device
    options = {}
    if args.backend in ("stark", "fold"):
        options["device"] = resolve_device(args.device)
        if args.device_hash_min is not None:
            options["device_hash_min"] = args.device_hash_min

    if not args.assume_committed:
        verify_block_file_against_manifest(args.blocks, args.manifest)
    man = read_manifest_auto(args.manifest)

    if args.backend == "fold":
        os.environ[ENV_KEYS["FOLD_MODE"]] = args.fold_mode
        os.environ[ENV_KEYS["FOLD_CACHE"]] = str(args.fold_cache)
        os.environ[ENV_KEYS["WRAP_CADENCE"]] = str(args.wrap_cadence)

    backend = _backend_for(args.backend)
    sp = StreamingProver(backend)

    with command("prove", backend=args.backend, stream=args.stream):
        if args.backend == "fold" and args.stream:
            stream_path = os.path.splitext(args.out)[0] + ".cborseq"
            os.environ[ENV_KEYS["PROOF_STREAM_PATH"]] = stream_path
            it = core_io.stream_block_summaries_auto(args.blocks)
            artifact = sp.prove_stream_iter(it, man.root)
            print(f"Proved (streaming/fold) -> artifact={args.out} stream={stream_path}")
        else:
            blocks = core_io.read_block_summaries_auto(args.blocks)
            if args.backend == "stark" and args.stream:
                artifact = backend.prove_streaming(blocks, man.root, **options)
            else:
                artifact = sp.prove(blocks, man.root, **options)

    core_io.write_proof_auto(args.out, artifact)
    print(
        f"Proved with {artifact.backend}, wrote {args.out} "
        f"({len(artifact.proof_bytes)} bytes)"
    )
    return 0


def cmd_verify(args) -> int:
    from .commit.merkle import read_manifest_auto, verify_block_file_against_manifest
    from .core import io as core_io
    from .core.prover import StreamingProver

    if not args.assume_committed:
        verify_block_file_against_manifest(args.blocks, args.manifest)
    man = read_manifest_auto(args.manifest)
    artifact = core_io.read_proof_auto(args.proof)

    backend = _backend_for(args.backend)
    sp = StreamingProver(backend)
    from .utils.tracing import command

    with command("verify", backend=args.backend):
        if args.backend == "fold":
            it = core_io.stream_block_summaries_auto(args.blocks)
            sp.verify_stream_iter(artifact, it, man.root)
        else:
            blocks = core_io.read_block_summaries_auto(args.blocks)
            sp.verify(artifact, blocks, man.root)
    print("OK: proof verified")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sezkp-tpu-torch",
        description="SEZKP PyTorch/CUDA port CLI (streaming sublinear-space ZKPs)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate", help="simulate a synthetic trace and partition it")
    s.add_argument("--t", type=int, default=32)
    s.add_argument("--b", type=int, default=4)
    s.add_argument("--tau", type=int, default=2)
    s.add_argument("--out-blocks", default="blocks.cbor")
    s.set_defaults(fn=cmd_simulate)

    s = sub.add_parser("commit", help="commit blocks to a Merkle manifest")
    s.add_argument("--blocks", required=True)
    s.add_argument("--out", default="manifest.cbor")
    s.set_defaults(fn=cmd_commit)

    s = sub.add_parser("verify-commit", help="check blocks file against a manifest")
    s.add_argument("--blocks", required=True)
    s.add_argument("--manifest", required=True)
    s.set_defaults(fn=cmd_verify_commit)

    s = sub.add_parser("export-jsonl", help="convert blocks to JSONL for streaming")
    s.add_argument("--input", required=True)
    s.add_argument("--output", required=True)
    s.set_defaults(fn=cmd_export_jsonl)

    s = sub.add_parser("prove", help="produce a proof")
    s.add_argument("--backend", choices=["fold", "stark", "stark-v0"], required=True)
    s.add_argument("--blocks", required=True)
    s.add_argument("--manifest", required=True)
    s.add_argument("--out", default="proof.cbor")
    s.add_argument("--fold-mode", choices=["balanced", "minram"], default="balanced")
    s.add_argument("--fold-cache", type=int, default=64)
    s.add_argument("--wrap-cadence", type=int, default=0)
    s.add_argument("--stream", action="store_true")
    s.add_argument("--assume-committed", action="store_true")
    s.add_argument("--device", default=None,
                   help="torch device of the stark and fold proves (default: the "
                        "CUDA card; raises where there is none). 'cpu' runs the "
                        "kernels' plain versions. stark-v0 is host code and "
                        "ignores it")
    s.add_argument("--device-hash-min", type=int, default=None,
                   help="batches of at least this many messages are hashed on "
                        "the device; 0 = host hasher (default: the backend's "
                        "own, fold/devhash.DEVICE_HASH_MIN for fold)")
    s.set_defaults(fn=cmd_prove)

    s = sub.add_parser("verify", help="verify a proof")
    s.add_argument("--backend", choices=["fold", "stark", "stark-v0"], required=True)
    s.add_argument("--blocks", required=True)
    s.add_argument("--manifest", required=True)
    s.add_argument("--proof", required=True)
    s.add_argument("--assume-committed", action="store_true")
    s.set_defaults(fn=cmd_verify)

    return p


def main(argv=None) -> int:
    from .utils.tracing import init_tracing

    init_tracing()
    args = build_parser().parse_args(argv)
    _join_ranks(args)
    return args.fn(args)


def _join_ranks(args) -> None:
    """Multi-process: wire this process into the world of ranks when the
    SEZKP_COORDINATOR / SEZKP_NUM_PROCESSES / SEZKP_PROCESS_ID variables are
    set (parallel/distributed.py), on the device of the command (the card for
    prove --backend stark | fold unless --device says otherwise, else the
    CPU); a no-op without them. Ranks on the card build the CUDA kernels
    once: rank 0 builds, the others wait at a barrier, then load the build."""
    from .parallel import distributed

    on_card = getattr(args, "fn", None) is cmd_prove and args.backend in ("stark", "fold")
    device = args.device if on_card else "cpu"
    if not distributed.ensure_initialized(device=device):
        return
    if distributed.local_device().type == "cuda":
        from .ops import _kernels

        if distributed.is_coordinator():
            _kernels.build()
        distributed.barrier("kernels")


if __name__ == "__main__":
    sys.exit(main())

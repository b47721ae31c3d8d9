"""Demo RISC-V VM adapter (reference: crates/sezkp-vm-riscv).

A placeholder adapter showing where a real VM front-end would live:
`make_trace` delegates to the shared generator (tau=2), `demo_block`
synthesizes a single deterministic sigma_k, and `run_e2e` exercises the full
pipeline (trace -> partition -> commit -> prove -> verify) for any backend.
Counterpart of sezkp_tpu/models/vm_riscv.py; `run_e2e` proves stark-v1 and
fold on `device` (None = the CUDA card; "cpu" when asked), stark-v0 on the
host.
"""

from __future__ import annotations

import os

import numpy as np

from ..core.types import BlockSummary, MovementLog
from ..trace.format import TraceFile
from ..trace.generator import generate_trace

__all__ = ["make_trace", "demo_block", "run_e2e"]


def make_trace(steps: int) -> TraceFile:
    """Toy trace with tau=2 (vm-riscv/lib.rs:33-36)."""
    return generate_trace(steps, 2)


def demo_block(block_id: int, length: int) -> BlockSummary:
    """Deterministic single sigma_k demo block (vm-riscv/lib.rs:47-79)."""
    tau = 2
    return BlockSummary(
        version=1,
        block_id=block_id,
        step_lo=1 + (block_id - 1) * length,
        step_hi=block_id * length,
        ctrl_in=0,
        ctrl_out=0,
        in_head_in=0,
        in_head_out=length,
        windows=np.array([[0, length - 1], [-1, length - 2]], dtype=np.int64),
        head_in_offsets=np.array([0, 0], dtype=np.uint32),
        head_out_offsets=np.array([length - 1, length - 2], dtype=np.uint32),
        movement_log=MovementLog(
            input_mv=np.zeros(length, dtype=np.int8),
            tape_mv=np.zeros((length, tau), dtype=np.int8),
            write_flag=np.zeros((length, tau), dtype=bool),
            write_sym=np.zeros((length, tau), dtype=np.uint16),
        ),
        pre_tags=[b"\x00" * 16] * tau,
        post_tags=[b"\x00" * 16] * tau,
    )


def run_e2e(
    steps: int = 32,
    b: int = 4,
    out_dir: str = "examples/minimal-riscv",
    proto: str = "v0",
    fold_mode: str = "balanced",
    wrap_cadence: int = 0,
    device=None,
) -> None:
    """Full pipeline demo (vm-riscv/main.rs:66-159)."""
    from ..commit.merkle import commit_block_file, verify_block_file_against_manifest
    from ..core import io as core_io
    from ..models import get_backend
    from ..trace.io import write_trace_auto
    from ..trace.partition import partition_trace

    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "trace.cbor")
    blocks_path = os.path.join(out_dir, "blocks.cbor")
    manifest_path = os.path.join(out_dir, "manifest.cbor")
    proof_path = os.path.join(out_dir, "proof.cbor")

    tf = make_trace(steps)
    write_trace_auto(trace_path, tf)
    print(f"VM -> trace.cbor (t={steps}, tau=2) at {trace_path}")

    blocks = partition_trace(tf, b)
    core_io.write_block_summaries_auto(blocks_path, blocks)
    print(f"Partitioned -> {len(blocks)} blocks -> {blocks_path}")

    manifest = commit_block_file(blocks_path, manifest_path)

    if proto in ("fold", "v2"):
        os.environ["SEZKP_FOLD_MODE"] = fold_mode
        os.environ["SEZKP_WRAP_CADENCE"] = str(wrap_cadence)

    name = {"v0": "stark-v0", "v1": "stark-v1", "fold": "fold", "v2": "fold"}[proto]
    backend = get_backend(name)
    options = {} if name == "stark-v0" else {"device": device}
    artifact = backend.prove(blocks, manifest.root, **options)
    core_io.write_proof_auto(proof_path, artifact)
    print(f"Proved ({name}); wrote proof -> {proof_path}")

    verify_block_file_against_manifest(blocks_path, manifest_path)
    backend.verify(artifact, blocks, manifest.root)
    print("Verified OK.")

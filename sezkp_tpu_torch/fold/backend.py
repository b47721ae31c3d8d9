"""FoldBackend: ProvingBackend + streaming implementation.

Counterpart of sezkp_tpu/fold/backend.py; the device and the device-hash
threshold are keyword arguments of `prove`, not environment variables.
Reference: crates/sezkp-fold/src/lib.rs. Artifact envelope is bincode of
(WireVersion::V2, WireEnvelope::V2(PayloadV2{bundle_cbor, root_c, root_pi}))
with the bundle CBOR-encoded; the streaming path writes a CBOR-seq sidecar at
SEZKP_PROOF_STREAM_PATH and references it from artifact meta.

NOTE (parity): the reference tags fold artifacts with BackendKind::Stark
("reuse enum; payload carries version", lib.rs:152-153). We reproduce that.
"""

from __future__ import annotations

import os
import struct
import time
from typing import Sequence

from ..core.artifact import BackendKind, ProofArtifact
from ..core.types import BlockSummary
from ..utils import cbor
from .api import Commitment, DriverOptions, FoldMode
from .are import Pi
from .devhash import DEVICE_HASH_MIN
from .driver import CborSeqSink, FoldProofBundle, StreamDriverSink, run_pipeline
from .verify import verify_bundle, verify_stream

ENV_FOLD_MODE = "SEZKP_FOLD_MODE"
ENV_FOLD_CACHE = "SEZKP_FOLD_CACHE"
ENV_WRAP_CADENCE = "SEZKP_WRAP_CADENCE"
ENV_PROOF_STREAM_PATH = "SEZKP_PROOF_STREAM_PATH"


def opts_from_env(opts: DriverOptions | None = None) -> DriverOptions:
    opts = opts or DriverOptions()
    mode = os.environ.get(ENV_FOLD_MODE, "").lower()
    if mode == "balanced":
        opts.fold_mode = FoldMode.BALANCED
    elif mode == "minram":
        opts.fold_mode = FoldMode.MINRAM
    wc = os.environ.get(ENV_WRAP_CADENCE)
    if wc is not None and wc.isdigit():
        opts.wrap_cadence = int(wc)
    fc = os.environ.get(ENV_FOLD_CACHE)
    if fc is not None and fc.isdigit():
        opts.endpoint_cache = int(fc)
    return opts


def bundle_top(b: FoldProofBundle):
    if b.folds:
        return b.folds[-1][0]
    if b.leaves:
        c, p, _ = b.leaves[-1]
        return c, p
    return Commitment(b"\x00" * 32, 0), Pi()


# ------------------------- bincode envelope codec ---------------------------


def _enc_pi(pi: Pi) -> bytes:
    out = struct.pack("<III", pi.ctrl_in, pi.ctrl_out, pi.flags)
    for a in pi.acc:
        out += struct.pack("<Q", a)
    return out


def _dec_pi(data: bytes, pos: int):
    ctrl_in, ctrl_out, flags = struct.unpack_from("<III", data, pos)
    pos += 12
    acc = []
    for _ in range(4):
        acc.append(struct.unpack_from("<Q", data, pos)[0] % 0xFFFFFFFF00000001)
        pos += 8
    return Pi(ctrl_in, ctrl_out, flags, tuple(acc)), pos


def encode_envelope_v2(bundle_cbor: bytes, root_c: Commitment, root_pi: Pi) -> bytes:
    out = bytearray()
    out += struct.pack("<I", 1)  # WireVersion::V2 (variant index 1)
    out += struct.pack("<I", 1)  # WireEnvelope::V2 (variant index 1)
    out += struct.pack("<Q", len(bundle_cbor))
    out += bundle_cbor
    out += root_c.root
    out += struct.pack("<I", root_c.len)
    out += _enc_pi(root_pi)
    return bytes(out)


def decode_envelope(data: bytes):
    pos = 0
    (wire_ver,) = struct.unpack_from("<I", data, pos)
    pos += 4
    (env_tag,) = struct.unpack_from("<I", data, pos)
    pos += 4
    if wire_ver not in (0, 1) or env_tag not in (0, 1):
        raise ValueError("unsupported fold payload version")
    (blen,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    bundle_bytes = data[pos : pos + blen]
    pos += blen
    root = data[pos : pos + 32]
    pos += 32
    (clen,) = struct.unpack_from("<I", data, pos)
    pos += 4
    root_pi, pos = _dec_pi(data, pos)
    is_cbor = env_tag == 1
    return bundle_bytes, Commitment(root, clen), root_pi, is_cbor


# ------------------------------- backend ------------------------------------


class FoldBackend:
    @staticmethod
    def prove(
        blocks: Sequence[BlockSummary], _manifest_root: bytes, *,
        device=None, device_hash_min: int = DEVICE_HASH_MIN,
        timings: "dict | None" = None,
    ) -> ProofArtifact:
        """Balanced mode hashes batches of at least `device_hash_min`
        single-chunk messages on `device`: None is the CUDA card, and the
        prove raises without one whatever its size; "cpu" runs the kernel's
        plain version. `device_hash_min=0` asks for the host hasher for every
        batch, as MinRam mode, the streamed prove and the verifier always
        use. The proof bytes do not depend on either. `timings` receives the balanced pipeline's stage
        seconds (fold/batch.run_pipeline_batched) and those of the CBOR
        encoding ("serialize")."""
        opts = opts_from_env(
            DriverOptions(device_hash_min=device_hash_min, device=device)
        )
        if opts.fold_mode == FoldMode.BALANCED:
            # level-batched pipeline; bit-identical bundle (fold/batch.py)
            from .batch import run_pipeline_batched

            bundle = run_pipeline_batched(blocks, opts, timings)
        else:
            bundle = run_pipeline(blocks, opts)
        t0 = time.perf_counter()
        root_c, root_pi = bundle_top(bundle)
        bundle_cbor = cbor.dumps(bundle.to_obj())
        proof_bytes = encode_envelope_v2(bundle_cbor, root_c, root_pi)
        if timings is not None:
            timings["serialize"] = time.perf_counter() - t0
        return ProofArtifact(
            backend=BackendKind.STARK,  # parity quirk, see module docstring
            manifest_root=root_c.root,
            proof_bytes=proof_bytes,
            meta={
                "proto": "fold-v2",
                "n_blocks": bundle.n_blocks,
                "wraps": len(bundle.wraps),
                "mode": opts.fold_mode,
            },
        )

    @staticmethod
    def verify(
        artifact: ProofArtifact, _blocks: Sequence[BlockSummary], manifest_root: bytes
    ) -> None:
        meta = artifact.meta if isinstance(artifact.meta, dict) else {}
        if meta.get("stream_format") == "fold-seq-v1":
            path = meta.get("stream_path")
            if not path:
                raise ValueError("streaming artifact missing 'stream_path'")
            with open(path, "rb") as f:
                verify_stream(f)
            if artifact.manifest_root != manifest_root:
                raise ValueError("manifest root mismatch")
            return

        bundle_bytes, env_root_c, env_root_pi, _ = decode_envelope(
            artifact.proof_bytes
        )
        bundle = FoldProofBundle.from_obj(cbor.loads(bundle_bytes))
        verify_bundle(bundle)

        top_c, top_pi = bundle_top(bundle)
        if top_c != env_root_c or top_pi != env_root_pi:
            raise ValueError("root mismatch in payload vs bundle")
        if artifact.manifest_root != top_c.root:
            raise ValueError("artifact.manifest_root does not match final fold root")
        if manifest_root != top_c.root:
            raise ValueError("CLI manifest root does not match final fold root")

    # ----------------------------- streaming --------------------------------

    @staticmethod
    def begin_stream(_manifest_root: bytes):
        opts = opts_from_env()
        path = os.environ.get(ENV_PROOF_STREAM_PATH)
        if not path:
            raise ValueError(
                "SEZKP_PROOF_STREAM_PATH not set (CLI must provide output path "
                "for streaming proofs)"
            )
        fh = open(path, "wb")
        drv = StreamDriverSink(CborSeqSink(fh), opts)
        return {"drv": drv, "fh": fh, "path": path}

    @staticmethod
    def ingest_block(state, block: BlockSummary) -> None:
        state["drv"].push_block(block)

    @staticmethod
    def finish_stream(state) -> ProofArtifact:
        root_c, _root_pi = state["drv"].finish()
        state["fh"].close()
        return ProofArtifact(
            backend=BackendKind.STARK,
            manifest_root=root_c.root,
            proof_bytes=b"",
            meta={
                "proto": "fold-stream",
                "stream_format": "fold-seq-v1",
                "stream_path": state["path"],
                "streaming": True,
            },
        )


FoldAgg = FoldBackend

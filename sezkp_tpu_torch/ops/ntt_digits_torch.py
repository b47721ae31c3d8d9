"""The digit form of the Goldilocks NTT phases on torch tensors.

Counterpart of the digit machinery of sezkp_tpu/ops/ntt_mxu.py (`_digits`,
`_dot_digits`, `_recombine`, `_w_digits`) and of the Pallas kernels of the
probe scripts that time its parts (scripts/exp_mxu_peak.py,
scripts/exp_ntt_breakdown.py, scripts/ntt_twiddle_fold_ab.py). The port's
production NTT (ops/ntt_torch.py, K2-K4) is a different design, radix-2
butterflies on 64-bit integers in shared memory; this module carries the
other one, so that it can be measured on the same card: every operand is
split into NDIG = 8 balanced base-256 digits of its signed representative, a
DFT phase Y = W @ X becomes 64 int8 matrix products with exact int32 sums on
the tensor cores, gathered into 15 diagonals, and one recombination mod p.

Kernels (CUDA C++, ops/csrc/), each with its plain version here:

- **K8 ``i8_gemm``** (i8_gemm.cu): ``epilogue(sum_j W_j[M, K] @ X[K, N])``,
  int8 in, int32 or ``& 127`` int8 out; a persistent TMA + wgmma kernel on
  the swapped product out^T = X^T W^T. Plain: ``i8_gemm_plain``; its tile
  schedule in tensor code: ``i8_gemm_model``.
- **K9 ``gl_digits``** (gl_digits.cu): elements -> digits, as the k-major
  stack int8 ``[NDIG, other, m]`` that K10 loads, or with ``tile`` as the
  tiled stack int8 ``[m, NDIG * other]`` of the Pallas probe. Plain:
  ``digits_plain`` and the two ``stack_*`` layouts; the k-major tile
  schedule in tensor code: ``gl_digits_model``.
- **K10 ``digit_dft``** (digit_dft.cu): one axis-0 phase from a digit stack
  or from elements, ending in the sum of the diagonals (int32) or the
  recombination (field elements); K11's kernel body with one table. Plain:
  ``digit_dft_plain`` on ``dot_digits_plain`` and ``recombine_plain``; its
  tile schedule in tensor code: ``digit_dft_model``.
- **K11 ``digit_dft_last``** (digit_dft_last.cu): the last phase of the
  three-factor transform with one table per middle index k2 (the middle
  twiddle folded into the table) and the natural-order transposed store.
  Plain: ``digit_dft_last_plain``; its tile schedule in tensor code:
  ``digit_dft_last_model``.

K10 and K11 are one persistent TMA + wgmma kernel template
(csrc/digit_wgmma.cuh), instantiated per X source and epilogue.

A wrapper launches its kernel for a CUDA tensor and runs its plain version
only for a CPU tensor. The plain versions compute the integer matrix products
in float64: torch has no integer matmul on CUDA, and every sum here is far
below 2^53, so the float64 product is the exact integer (the operands are
int8, the contraction at most 2^20 long).

Field elements are int64 tensors holding u64 bits (ops/goldilocks_torch.py);
a u32 result (the sum of diagonals) is an int32 tensor holding u32 bits.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from . import _kernels
from . import goldilocks as G
from . import goldilocks_torch as FT
from . import ntt as ntt_host
from . import ntt_torch as NT

NDIG = 8  # balanced base-256 digits per signed representative
DIAGS = 2 * NDIG - 1
# folded-diagonal bound: |sigma| <= 3 * (8 * 2^10 * 128^2) < OFF
OFF = 1 << 29
# signed-representative threshold: values v > MAX_BAL are replaced by v - p
MAX_BAL = 127 * ((1 << 64) - 1) // 255  # 0x7F7F7F7F7F7F7F7F

_tables: Dict[Tuple, torch.Tensor] = {}


def _factor_logs(n_log2: int) -> List[int]:
    """Balanced factor logs, each <= 10, smallest first (so the last factor,
    the one the folded table is built for, is as large as possible)."""
    k = 2 if n_log2 <= 17 else 3
    q, r = divmod(n_log2, k)
    return [q] * (k - r) + [q + 1] * r


# ------------------------------ host tables ----------------------------------


def balanced_digits_host(W: np.ndarray) -> List[np.ndarray]:
    """Canonical u64 array (< p) -> 8 int8 planes of the signed
    representative: r = W - p if W > MAX_BAL else W; r = sum_k d_k 256^k with
    d_k in [-128, 127] (byte-and-carry chain on the two's-complement bytes;
    the final carry-out encodes the sign wrap and is dropped)."""
    with np.errstate(over="ignore"):
        t = np.where(W > np.uint64(MAX_BAL), W - np.uint64(G.P), W)
    r_signed = t.astype(np.uint64).view(np.int64).copy()
    digs = []
    for _ in range(8):
        b = (t & np.uint64(255)).astype(np.int64)
        ge = b >= 128
        digs.append(np.where(ge, b - 256, b).astype(np.int8))
        t = (t >> np.uint64(8)) + ge.astype(np.uint64)
    acc = np.zeros_like(r_signed)
    for k in range(7, -1, -1):
        acc = acc * 256 + digs[k].astype(np.int64)
    assert np.array_equal(acc, r_signed), "balanced digitization not exact"
    return digs


def _dft_matrix(m_log2: int, inverse: bool, scale: int = 1) -> np.ndarray:
    """W[k, j] = scale * w_m^(kj), u64 [m, m] (symmetric)."""
    m = 1 << m_log2
    w = G.primitive_root_2exp(m_log2)
    if inverse:
        w = G.inv(w)
    wp = ntt_host.powers(w, m)
    k = np.arange(m, dtype=np.uint64)
    W = wp[(k[:, None] * k[None, :]) % np.uint64(m)]
    if scale != 1:
        W = G.mul(W, np.uint64(scale))
    return W


def w_digits_host(m_log2: int, inverse: bool, scale: int = 1) -> np.ndarray:
    """The DFT matrix as int8 balanced digit planes [NDIG * m, m]."""
    assert m_log2 <= 10, "factor too large for the diagonal bound"
    return np.concatenate(balanced_digits_host(_dft_matrix(m_log2, inverse, scale)), axis=0)


def w_digits(m_log2: int, inverse: bool, scale: int = 1, device="cpu") -> torch.Tensor:
    """`w_digits_host` as a cached int8 tensor on `device`."""
    key = ("w", m_log2, inverse, scale, str(torch.device(device)))
    t = _tables.get(key)
    if t is None:
        t = torch.from_numpy(w_digits_host(m_log2, inverse, scale)).to(device)
        _tables[key] = t
    return t


# ------------------------------ plain versions -------------------------------


def digits_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K9's arithmetic: int64 field tensor -> int8
    [NDIG, *x.shape], plane k = digit k."""
    big = FT._ult(torch.full_like(x, FT._i64(MAX_BAL)), x)  # unsigned x > MAX_BAL
    t = torch.where(big, x - FT._P_I64, x)
    digs = []
    c = torch.zeros_like(x)
    for k in range(NDIG):
        b = ((t >> (8 * k)) & 255) + c
        c = (b >= 128).to(torch.int64)
        digs.append((b - (c << 8)).to(torch.int8))
    return torch.stack(digs)


def stack_kmajor(planes: torch.Tensor) -> torch.Tensor:
    """Digit planes [NDIG, m, other] -> the k-major stack [NDIG, other, m]."""
    return planes.transpose(1, 2).contiguous()


def stack_tiled(planes: torch.Tensor, tile: int) -> torch.Tensor:
    """Digit planes [NDIG, m, other] -> [m, NDIG * other]: for every `tile`
    columns the NDIG planes [m, tile] side by side."""
    _, m, other = planes.shape
    if other % tile:
        raise ValueError("tile must divide the column count")
    return planes.reshape(NDIG, m, other // tile, tile).permute(1, 2, 0, 3).reshape(m, NDIG * other)


def _imatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer matrix product of small-integer tensors, as int64."""
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int64)


def dot_digits_plain(digs: Sequence[torch.Tensor], w: torch.Tensor, m: int, mode: str):
    """All 64 digit-pair products summed into the 15 diagonals (int64).

    mode "w_x": planes [m, span], products W_j @ x_i -> [m, span];
    mode "x_w": planes [span, m], products x_i @ W_j -> [span, m].
    w is [NDIG * m, m], digit plane j in rows j*m .. (j+1)*m."""
    if mode not in ("w_x", "x_w"):
        raise ValueError(f"unknown mode {mode}")
    diags = [None] * DIAGS
    for j in range(NDIG):
        wj = w[j * m : (j + 1) * m, :]
        for i, xi in enumerate(digs):
            p = _imatmul(wj, xi) if mode == "w_x" else _imatmul(xi, wj)
            d = i + j
            diags[d] = p if diags[d] is None else diags[d] + p
    return diags


def recombine_plain(diags: Sequence[torch.Tensor]) -> torch.Tensor:
    """[s_0 .. s_14] integer diagonal sums (|s_d| < 2^31) -> the canonical
    field element sum_d s_d 2^(8d) mod p, by field arithmetic: the positive
    and the negative part of each s_d times the constant 2^(8d) mod p."""
    acc = None
    for d, s in enumerate(diags):
        s = s.to(torch.int64)
        c = FT.scalar(pow(2, 8 * d, FT.P_INT), s)
        term = FT.sub(FT.mul(s.clamp(min=0), c), FT.mul((-s).clamp(min=0), c))
        acc = term if acc is None else FT.add(acc, term)
    return acc


def _check_epilogue(epilogue: str, allowed) -> None:
    if epilogue not in allowed:
        raise ValueError(f"epilogue must be one of {allowed}")


def i8_gemm_plain(w, x, nrep: int = 1, epilogue: str = "int32"):
    """Plain PyTorch version of K8: w int8 [nrep * M, K], x int8 [K, N] ->
    sum_j W_j @ X wrapped to int32 [M, N], or `& 127` of it as int8."""
    _check_epilogue(epilogue, ("int32", "and127"))
    M = w.shape[0] // nrep
    acc = None
    for j in range(nrep):
        p = _imatmul(w[j * M : (j + 1) * M], x)
        acc = p if acc is None else acc + p
    if epilogue == "and127":
        return (acc & 127).to(torch.int8)
    # int64 -> int32 keeps the low 32 bits: the wrap of an int32 accumulator
    return acc.to(torch.int32)


# K8's tiles (csrc/i8_gemm.cu): output rows m, output columns n, k chunk (bytes)
I8_TILE = (256, 128, 128)


def i8_n_order(bn: int = 128) -> torch.Tensor:
    """[bn]: the column n of an X tile that row r of K8's A operand (X^T) is.
    Warpgroup wg takes n from 64 wg; its warp w4 the 16 from 16 w4, and lane
    (g, q) rows 16 w4 + g and 16 w4 + g + 8 of the product, which are the
    neighbouring columns 2g and 2g + 1 (one 16-bit read)."""
    r = torch.arange(bn)
    wg, w4, g, h = r // 64, r % 64 // 16, r % 8, r % 16 // 8
    return 64 * wg + 16 * w4 + 2 * g + h


def i8_gemm_model(w, x, nrep: int = 1, epilogue: str = "int32", fuse: bool = False, grid: int = 3):
    """K8's schedule in tensor code (csrc/i8_gemm.cu), for int8 w [nrep * M, K]
    and x [K, N] of any size: the swapped product out^T = X^T W^T; `grid`
    persistent blocks, block b taking output tiles b, b + grid, ... (tile t
    at M tile t % mtiles, column tile t // mtiles; 256 m x 128 n); per tile
    the steps over (j, k chunk) in `fuse`'s order (fuse: k chunks outside,
    j inside, one set of X fragments for all j), each a box of W at (row
    j*M + m0, k kc*BK) and of X at (k kc*BK, n n0), zeros outside the tensors
    (TMA's fill: rows past M in the last M tile are the next block's W rows,
    or zeros after the last, and fall outside the store); the A rows in the
    kernel's order of n (``i8_n_order``), undone by the epilogue; the sums
    wrap as int32; the store clipped at (M, N). Raises if an output element
    is written other than once."""
    _check_epilogue(epilogue, ("int32", "and127"))
    bm, bn, bk = I8_TILE
    M, K, N = w.shape[0] // nrep, w.shape[1], x.shape[1]
    mtiles, ntiles_n, kchunks = -(-M // bm), -(-N // bn), -(-K // bk)
    wp = torch.zeros((nrep * M + bm, kchunks * bk), dtype=torch.float64)
    wp[: nrep * M, :K] = w.to(torch.float64)
    xp = torch.zeros((kchunks * bk, ntiles_n * bn), dtype=torch.float64)
    xp[:K, :N] = x.to(torch.float64)
    order = [(s % nrep, s // nrep) if fuse else (s // kchunks, s % kchunks) for s in range(nrep * kchunks)]
    perm = i8_n_order(bn)
    out = torch.zeros((M, N), dtype=torch.int64)
    writes = torch.zeros((M, N), dtype=torch.int64)
    for b in range(grid):
        for t in range(b, mtiles * ntiles_n, grid):
            m0, n0 = (t % mtiles) * bm, (t // mtiles) * bn
            # A = X^T rows in the kernel's order, B = W^T
            a = torch.stack([xp[kc * bk : (kc + 1) * bk, n0 : n0 + bn].T[perm] for _, kc in order])
            bt = torch.stack([wp[j * M + m0 : j * M + m0 + bm, kc * bk : (kc + 1) * bk] for j, kc in order])
            dt = torch.bmm(a, bt.transpose(1, 2)).to(torch.int64).sum(0)  # D^T [n, m], exact: |sum| < 2^53
            acc = torch.empty_like(dt)
            acc[perm] = dt  # the epilogue's store by n
            acc = acc.T
            rows, cols = min(bm, M - m0), min(bn, N - n0)
            out[m0 : m0 + rows, n0 : n0 + cols] = acc[:rows, :cols]
            writes[m0 : m0 + rows, n0 : n0 + cols] += 1
    if not bool((writes == 1).all()):
        raise AssertionError("K8's stores do not cover the output once each")
    if epilogue == "and127":
        return (out & 127).to(torch.int8)
    return out.to(torch.int32)


def digit_dft_plain(src, w, epilogue: str = "recombine", elements: bool = False):
    """Plain PyTorch version of K10. src: the k-major digit stack int8
    [NDIG, other, m], or with elements=True the field tensor [m, other]."""
    _check_epilogue(epilogue, ("sum", "recombine"))
    planes = digits_plain(src) if elements else src.transpose(1, 2)  # [NDIG, m, other]
    m = planes.shape[1]
    diags = dot_digits_plain(list(planes), w, m, "w_x")
    if epilogue == "recombine":
        return recombine_plain(diags)
    acc = diags[0]
    for d in diags[1:]:
        acc = acc + d
    return acc.to(torch.int32)


def digit_dft_last_plain(x: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K11. x: field [cols, m2 * mc] = X[k1, (k2, b3)];
    wf: int8 [m2, mc, NDIG, mc] (`folded_table`). Returns field [mc, m2 * cols]
    = Y[k3, (k2, k1)]."""
    m2, mc = wf.shape[0], wf.shape[1]
    cols = x.shape[0]
    xd = digits_plain(x.reshape(cols, m2, mc))  # [NDIG, k1, k2, b3]
    xd = xd.permute(2, 0, 1, 3).reshape(m2, NDIG * cols, mc).to(torch.float64)
    diags = [None] * DIAGS
    for j in range(NDIG):
        wj = wf[:, :, j, :].transpose(1, 2).to(torch.float64)  # [k2, b3, k3]
        p = torch.bmm(xd, wj).to(torch.int64).reshape(m2, NDIG, cols, mc)
        for i in range(NDIG):
            d = i + j
            diags[d] = p[:, i] if diags[d] is None else diags[d] + p[:, i]
    y = recombine_plain(diags)  # [k2, k1, k3]
    return y.permute(2, 0, 1).reshape(mc, m2 * cols).contiguous()


# K11's schedule, and K10's (csrc/digit_wgmma.cuh): k1 rows of a tile (wgmma's M), k3
# columns of an N-tile (wgmma's N), consumer warpgroups, and the b3 spans of
# the digit cache, of an X stage and of a W stage
K11_TILE = dict(rows=64, n=32, wgs=2, chunk=256, xb=16, wb=128)
# the diagonals each consumer warpgroup accumulates, 32 digit products each
K11_PARTS = ((0, 1, 2, 3, 4, 5, 6, 11), (7, 8, 9, 10, 12, 13, 14))


def k11_balanced_digits(v: torch.Tensor) -> torch.Tensor:
    """``i8mma::balanced_digits`` on int64 tensors holding u64 bits: v - p where
    v > MAX_BAL, then one 64-bit add of 0x80 to every byte and one xor; digit
    k of the signed representative in byte k (two's complement)."""
    k80 = FT._i64(0x8080808080808080)
    v = torch.where(FT._ult(torch.full_like(v, FT._i64(MAX_BAL)), v), v - FT._P_I64, v)
    return (v + k80) ^ k80


def k11_fragment_map() -> Tuple[torch.Tensor, torch.Tensor]:
    """([128, 16] row, [128, 16] k) of every byte of a consumer thread's A
    fragment of one k32 step, as wgmma (mma.m16n8k32's layout) reads it:
    thread t = 32 w + 4 g + q holds word c (bytes 4c .. 4c + 3) at row
    16 w + g + 8 (c % 2), k = 16 (c // 2) + 4 q + byte."""
    t = torch.arange(128)[:, None]
    c, b = torch.arange(16)[None, :] // 4, torch.arange(16)[None, :] % 4
    w, g, q = t // 32, t % 32 // 4, t % 4
    return 16 * w + g + 8 * (c % 2), 16 * (c // 2) + 4 * q + b


def _k11_digitize(xp: torch.Tensor, k2: int, h: int, kc: int, mc: int) -> torch.Tensor:
    """One chunk of the digit cache as the consumer threads write it, uint8
    [chunk / 32 steps, NDIG planes, 128 threads, 16 bytes]. X stage j (16 b3
    of the tile's 64 rows) lands with TMA's 128-byte swizzle (16-byte unit u
    of row r at unit u ^ (r % 8)); warpgroup j % 2 takes it, thread (w, g, q)
    reading rows 16 w + g and + 8 at units 2q, 2q + 1 (elements 4q .. 4q + 3)
    and writing their digits as words 2 (j % 2) and 2 (j % 2) + 1 of its
    fragment of step j // 2."""
    rows, xb, cs = K11_TILE["rows"], K11_TILE["xb"], min(mc, K11_TILE["chunk"])
    cache = torch.zeros((cs // 32, NDIG, 128, 16), dtype=torch.uint8)
    t = torch.arange(128)
    w, g, q = t // 32, t % 32 // 4, t % 4
    r = torch.arange(rows)[:, None]
    for j in range(cs // xb):
        c0 = k2 * mc + kc * cs + xb * j
        box = xp[rows * h : rows * (h + 1), c0 : c0 + xb].reshape(rows, 8, 2)
        smem = torch.empty_like(box)
        smem[r, torch.arange(8)[None, :] ^ (r % 8)] = box
        s, half = divmod(j, 2)
        for rr in range(2):
            row = 16 * w + g + 8 * rr
            e = torch.cat([smem[row, (2 * q) ^ (row % 8)], smem[row, (2 * q + 1) ^ (row % 8)]], dim=1)
            d = k11_balanced_digits(e)  # [128, 4]: element c's digit words
            for i in range(NDIG):
                at = 8 * half + 4 * rr
                cache[s, i, :, at : at + 4] = ((d >> (8 * i)) & 255).to(torch.uint8)
    return cache


def k11_recombine(diags: Dict[int, torch.Tensor]) -> torch.Tensor:
    """The kernel's recombination of the diagonals it is given (int64 sums,
    |s_d| <= 2^27; the others 0): sum_d s_d 2^(8d) mod p through the 8 folded
    signed sums (2^64 = 2^32 - 1, 2^96 = -1) as lo = sum_{r<4} sig_r 2^(8r),
    hi = sum_{r<4} sig_(r+4) 2^(8r), and lo + (hi >> 32)(2^32 - 1) +
    (hi mod 2^32) 2^32, each part canonical. Returns int64 holding u64 bits."""
    like = next(iter(diags.values()))
    v = [diags[d].to(torch.int64) if d in diags else torch.zeros_like(like, dtype=torch.int64) for d in range(DIAGS)]
    if max(int(x.abs().max()) for x in v) > 1 << 27:
        raise AssertionError("a diagonal sum is past its bound")
    sig = [v[0] - v[8] - v[12], v[1] - v[9] - v[13], v[2] - v[10] - v[14], v[3] - v[11],
           v[4] + v[8], v[5] + v[9], v[6] + v[10], v[7] + v[11]]
    lo = sum(sig[r] << (8 * r) for r in range(4))
    hi = sum(sig[4 + r] << (8 * r) for r in range(4))
    t = lo + (hi >> 32) * FT.EPS  # |t| < 2^55: exact in int64
    tc = torch.where(t < 0, t + FT._P_I64, t)  # the u64 bits of t + p
    return FT.add(FT._canon((hi & 0xFFFFFFFF) << 32), tc)


def digit_dft_last_model(x: torch.Tensor, wf: torch.Tensor, grid: int = 3) -> torch.Tensor:
    """K11's schedule in tensor code (csrc/digit_dft_last.cu on
    digit_wgmma.cuh), for the inputs of ``digit_dft_last_plain``. `grid`
    persistent blocks; block b takes tiles
    b, b + grid, ... of (k2, h) = divmod(tile, halves): 64 rows k1 from 64 h
    (TMA's zeros below row cols) of slice k2. Per tile, the N-tiles p (32 k3
    from 32 p), per N-tile the b3 chunks of 256; a chunk's digits are
    (re)built into the cache when there is more than one chunk or p = 0 (the
    kernel builds it step by step, each step's just before its products). Per
    k32 step of a chunk, A is plane i of the cache read by the fragment map,
    B the W stage's plane j (32 rows, b3 from the stage's 128, zeros past
    mc), and warpgroup wg adds the product to diagonal i + j when that is one
    of K11_PARTS[wg]. Each warpgroup recombines its diagonals; the tile is
    the sum of the two mod p, stored at Y[k3, k2 cols + k1] where k1 < cols.
    Raises if an output element is written other than once."""
    rows, n, wb = K11_TILE["rows"], K11_TILE["n"], K11_TILE["wb"]
    m2, mc, cols = wf.shape[0], wf.shape[1], x.shape[0]
    halves = -(-cols // rows)
    cs = min(mc, K11_TILE["chunk"])
    nk, spc = mc // cs, cs // 32
    wspc = min(4, spc)  # k32 steps a W stage
    xp = torch.zeros((halves * rows, m2 * mc), dtype=torch.int64)
    xp[:cols] = x
    wp = torch.zeros((m2, mc, NDIG, -(-mc // wb) * wb), dtype=torch.float64)
    wp[..., :mc] = wf.to(torch.float64)
    frow, fk = k11_fragment_map()
    out = torch.zeros((mc, m2 * cols), dtype=torch.int64)
    writes = torch.zeros((mc, m2 * cols), dtype=torch.int64)
    for b in range(grid):
        for tile in range(b, m2 * halves, grid):
            k2, h = divmod(tile, halves)
            for p in range(mc // n):
                acc = [{d: torch.zeros((rows, n), dtype=torch.int64) for d in part} for part in K11_PARTS]
                for kc in range(nk):
                    if nk > 1 or p == 0:
                        cache = _k11_digitize(xp, k2, h, kc, mc)
                    for s in range(spc):
                        a = torch.zeros((NDIG, rows, 32), dtype=torch.float64)
                        a[:, frow, fk] = cache[s].view(torch.int8).to(torch.float64)
                        b0 = kc * cs + (s // wspc) * wb + 32 * (s % wspc)
                        bw = wp[k2, n * p : n * (p + 1), :, b0 : b0 + 32]  # [k3, plane j, k]
                        prod = torch.einsum("irk,njk->ijrn", a, bw).to(torch.int64)
                        for part in acc:
                            for i in range(NDIG):
                                for j in range(NDIG):
                                    if i + j in part:
                                        part[i + j] += prod[i, j]
                y = [k11_recombine(part) for part in acc]  # [k1 rows, k3]
                tile_y = FT.add(y[0], y[1])
                live = min(rows, cols - rows * h)
                c0 = k2 * cols + rows * h
                out[n * p : n * (p + 1), c0 : c0 + live] = tile_y[:live].T
                writes[n * p : n * (p + 1), c0 : c0 + live] += 1
    if not bool((writes == 1).all()):
        raise AssertionError("K11's stores do not cover the output once each")
    return out


def _k10_cache(xp: torch.Tensor, h: int, kc: int, m: int, elements: bool) -> torch.Tensor:
    """One chunk of K10's digit cache as the consumer threads write it, uint8
    [chunk / 32 steps, NDIG planes, 128 threads, 16 bytes] in K11's fragment
    order: X stage j (16 b of the tile's 64 columns) goes to warpgroup j % 2,
    thread (w, g, q) writing words 2 (j % 2) (column 16 w + g) and
    2 (j % 2) + 1 (column + 8) of its fragment of step j // 2, elements
    b = 4q .. 4q + 3 of the stage.
    elements: xp the field tensor [m, 64 halves] (zeros past `other`); the
    stage lands unswizzled as [16 b][64 columns] and the thread reads rows
    4q .. 4q + 3 of its two columns and digitises them.
    stack: xp the digit stack int8 [NDIG, 64 halves, m]; the stage lands as
    [plane][64 columns][16 b] and the thread copies bytes 4q .. 4q + 3 of its
    two rows of every plane."""
    rows, xb, cs = K11_TILE["rows"], K11_TILE["xb"], min(m, K11_TILE["chunk"])
    cache = torch.zeros((cs // 32, NDIG, 128, 16), dtype=torch.uint8)
    t = torch.arange(128)
    w, g, q = t // 32, t % 32 // 4, t % 4
    b = 4 * q[:, None] + torch.arange(4)[None, :]  # [128 threads, 4 elements]
    for j in range(cs // xb):
        b0 = kc * cs + xb * j
        s, half = divmod(j, 2)
        if elements:
            smem = xp[b0 : b0 + xb, rows * h : rows * (h + 1)]  # [b, column]
        else:
            smem = xp[:, rows * h : rows * (h + 1), b0 : b0 + xb]  # [plane, column, b]
        for rr in range(2):
            at = 8 * half + 4 * rr
            col = (16 * w + g + 8 * rr)[:, None]
            if elements:
                d = k11_balanced_digits(smem[b, col])
                for i in range(NDIG):
                    cache[s, i, :, at : at + 4] = ((d >> (8 * i)) & 255).to(torch.uint8)
            else:
                cache[s, :, :, at : at + 4] = smem[:, col, b].view(torch.uint8)
    return cache


def digit_dft_model(src, w, epilogue: str = "recombine", elements: bool = False, grid: int = 3) -> torch.Tensor:
    """K10's schedule in tensor code (csrc/digit_dft.cu on digit_wgmma.cuh,
    K11's body with one table), for the inputs of ``digit_dft_plain``.
    `grid` persistent blocks; block b takes tiles h = b, b + grid, ... of 64
    columns from 64 h (TMA's zeros past `other`). Per tile the N-tiles p (32
    output rows k from 32 p), per N-tile the b chunks of 256; a chunk's cache
    (``_k10_cache``: the stage layouts of the elements and of the stack) is
    (re)built when there is more than one chunk or p = 0. Per k32 step, A is
    plane i of the cache read by the fragment map, B plane j of the table's
    W stage (rows j m + 32 p .., b from the step's 32), and warpgroup wg adds
    the product to diagonal i + j when that is one of K11_PARTS[wg]. Epilogue
    "recombine": each warpgroup recombines its diagonals and the tile is the
    sum of the two mod p; "sum": each adds its diagonals as int32 and the
    tile is the two halves added, wrapping. Stored at Y[k, 64 h + c] where
    64 h + c < other. Raises if an output element is written other than once."""
    _check_epilogue(epilogue, ("sum", "recombine"))
    rows, n, wb = K11_TILE["rows"], K11_TILE["n"], K11_TILE["wb"]
    if elements:
        m, other = src.shape
    else:
        other, m = src.shape[1], src.shape[2]
    halves = -(-other // rows)
    cs = min(m, K11_TILE["chunk"])
    nk, spc = m // cs, cs // 32
    wspc = min(4, spc)  # k32 steps a W stage
    if elements:
        xp = torch.zeros((m, halves * rows), dtype=torch.int64)
        xp[:, :other] = src
    else:
        xp = torch.zeros((NDIG, halves * rows, m), dtype=torch.int8)
        xp[:, :other] = src
    planes = w.to(torch.float64).reshape(NDIG, m, m)  # [plane j][k][b]
    frow, fk = k11_fragment_map()
    out = torch.zeros((m, other), dtype=torch.int64 if epilogue == "recombine" else torch.int32)
    writes = torch.zeros((m, other), dtype=torch.int64)
    for b in range(grid):
        for h in range(b, halves, grid):
            for p in range(m // n):
                a_steps, b_steps = [], []
                for kc in range(nk):
                    if nk > 1 or p == 0:
                        cache = _k10_cache(xp, h, kc, m, elements)
                    for s in range(spc):
                        a = torch.zeros((NDIG, rows, 32), dtype=torch.float64)
                        a[:, frow, fk] = cache[s].view(torch.int8).to(torch.float64)
                        b0 = kc * cs + (s // wspc) * wb + 32 * (s % wspc)
                        a_steps.append(a)
                        b_steps.append(planes[:, n * p : n * (p + 1), b0 : b0 + 32])
                # [i, j, column, k]: exact, every sum below 2^53
                prod = torch.einsum("sirk,sjnk->ijrn", torch.stack(a_steps), torch.stack(b_steps)).to(torch.int64)
                acc = [{d: sum(prod[i, d - i] for i in range(max(0, d - NDIG + 1), min(d, NDIG - 1) + 1))
                        for d in part} for part in K11_PARTS]
                if epilogue == "recombine":
                    y = [k11_recombine(part) for part in acc]
                    tile = FT.add(y[0], y[1])
                else:
                    y = [sum(part.values()).to(torch.int32) for part in acc]  # each warpgroup's int32 sum
                    tile = (y[0].to(torch.int64) + y[1].to(torch.int64)).to(torch.int32)
                live = min(rows, other - rows * h)
                out[n * p : n * (p + 1), rows * h : rows * h + live] = tile[:live].T
                writes[n * p : n * (p + 1), rows * h : rows * h + live] += 1
    if not bool((writes == 1).all()):
        raise AssertionError("K10's stores do not cover the output once each")
    return out


# K9's k-major tile (csrc/gl_digits.cu): columns, and rows at most
K9_TILE = dict(cols=16, max_rows=256)


def k9_rows(m: int) -> int:
    """Rows of K9's k-major tile for m rows: 256, else the largest of 128,
    64 and 32 that divides m."""
    for r in (K9_TILE["max_rows"], 128, 64, 32):
        if m % r == 0:
            return r
    raise ValueError("gl_digits (k-major) on the card takes m and other that are multiples of 32")


def gl_digits_model(x: torch.Tensor) -> torch.Tensor:
    """K9's k-major schedule in tensor code (csrc/gl_digits.cu), for x field
    [m, other], m and other multiples of 32. Block (by, bx) owns rows R by ..
    (R = ``k9_rows(m)``) and columns 16 bx ..; its item (row quad q, column
    pair cp) is rows 4q .. 4q + 3 of columns 2cp, 2cp + 1. Each element's
    balanced digits, then the 4 x 4 byte transpose: plane i's word of the
    quad holds row 4q + r in byte r, and lands in shared memory
    [plane][column][R / 4 words] at word q ^ (4 (column // 2) & (R / 4 - 4)).
    Store vector (plane * 16 + column) * R / 16 + g reads the 16 bytes at word
    4g of the run (the same xor) and writes them at byte (plane * other +
    16 bx + column) * m + R by + 16 g. Returns the int8 [NDIG, other, m]
    stack; raises if a shared word or an output byte is written other than
    once."""
    m, other = x.shape
    cols = K9_TILE["cols"]
    if other % 32:
        raise ValueError("gl_digits (k-major) on the card takes m and other that are multiples of 32")
    R = k9_rows(m)
    kq = R // 4
    nby, nbx = m // R, other // cols
    by = torch.arange(nby)[:, None, None, None]
    bx = torch.arange(nbx)[None, :, None, None]
    q = torch.arange(kq)[None, None, :, None]
    cp = torch.arange(cols // 2)[None, None, None, :]
    shape = (nby, nbx, kq, cols // 2)
    d = k11_balanced_digits(x)
    smem = torch.zeros((nby, nbx, NDIG * cols * kq), dtype=torch.int64)
    swrites = torch.zeros_like(smem)
    for e in range(2):
        c = 2 * cp + e
        w = q ^ ((4 * (c >> 1)) & (kq - 4))
        quad = [d[R * by + 4 * q + r, cols * bx + c] for r in range(4)]
        for i in range(NDIG):
            word = sum(((quad[r] >> (8 * i)) & 255) << (8 * r) for r in range(4))
            at = ((i * cols + c) * kq + w).expand(shape)
            smem[by.expand(shape), bx.expand(shape), at] = word.expand(shape)
            swrites.index_put_((by.expand(shape), bx.expand(shape), at), torch.ones(shape, dtype=torch.int64),
                               accumulate=True)
    if not bool((swrites == 1).all()):
        raise AssertionError("K9's shared-memory words are not written once each")
    kvec = R // 16
    idx = torch.arange(NDIG * cols * kvec)[None, None, :]
    pc, g = idx // kvec, idx % kvec
    c = pc % cols
    word0 = pc * kq + ((4 * g) ^ ((4 * (c >> 1)) & (kq - 4)))
    base = ((pc // cols) * other + cols * bx[..., 0] + c) * m + R * by[..., 0] + 16 * g
    out = torch.zeros(NDIG * other * m, dtype=torch.int64)
    writes = torch.zeros_like(out)
    vshape = (nby, nbx, idx.shape[-1])
    for k in range(4):
        vals = smem[by[..., 0].expand(vshape), bx[..., 0].expand(vshape), (word0 + k).expand(vshape)]
        for b in range(4):
            at = (base + 4 * k + b).expand(vshape).reshape(-1)
            out[at] = ((vals >> (8 * b)) & 255).reshape(-1)
            writes.index_put_((at,), torch.ones_like(at), accumulate=True)
    if not bool((writes == 1).all()):
        raise AssertionError("K9's stores do not cover the output once each")
    return out.to(torch.uint8).view(torch.int8).reshape(NDIG, other, m)


# ------------------------------ kernel wrappers ------------------------------


def _need(t: torch.Tensor, dtype, dims: int, what: str) -> None:
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor with {dims} dims")


def i8_gemm(w, x, nrep: int = 1, epilogue: str = "int32", fuse: bool = False):
    """K8 wrapper. `fuse` picks the kernel's loop order (one product over the
    stacked weights, or nrep products one after the other); the result is the
    same. On the card M, K and N must be multiples of 64; an operand that
    is not 16-byte aligned (TMA's rule) is copied to one that is."""
    _check_epilogue(epilogue, ("int32", "and127"))
    _need(w, torch.int8, 2, "w")
    _need(x, torch.int8, 2, "x")
    if nrep < 1 or w.shape[0] % nrep or w.shape[1] != x.shape[0] or w.device != x.device:
        raise ValueError("i8_gemm takes w [nrep * M, K] and x [K, N] on one device")
    if not x.is_cuda:
        return i8_gemm_plain(w, x, nrep, epilogue)
    M, K, N = w.shape[0] // nrep, w.shape[1], x.shape[1]
    if M % 64 or K % 64 or N % 64:
        raise ValueError("i8_gemm on the card takes M, K and N that are multiples of 64")
    w, x = (t.clone() if t.data_ptr() % 16 else t for t in (w, x))
    out = torch.empty((M, N), dtype=torch.int32 if epilogue == "int32" else torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernels.lib().sezkp_i8_gemm(
            w.data_ptr(), x.data_ptr(), out.data_ptr(), M, K, N, nrep, int(bool(fuse)),
            0 if epilogue == "int32" else 1, _kernels.stream_ptr(),
        )
    _kernels.check(rc, "i8_gemm")
    i8_gemm.launches += 1
    return out


def gl_digits(x: torch.Tensor, tile: "int | None" = None) -> torch.Tensor:
    """K9 wrapper. x: field [m, other]. tile None: the k-major stack int8
    [NDIG, other, m] (on the card m and other must be multiples of 32);
    tile = T: the tiled stack int8 [m, NDIG * other]."""
    _need(x, torch.int64, 2, "x")
    m, other = x.shape
    if tile is not None and (tile < 1 or other % tile):
        raise ValueError("tile must divide the column count")
    if not x.is_cuda:
        planes = digits_plain(x)
        return stack_kmajor(planes) if tile is None else stack_tiled(planes, tile)
    if tile is None:
        if m % 32 or other % 32:
            raise ValueError("gl_digits (k-major) on the card takes m and other that are multiples of 32")
        if x.data_ptr() % 16:  # the kernel reads 16 bytes a load
            x = x.clone()
        out = torch.empty((NDIG, other, m), dtype=torch.int8, device=x.device)
    else:
        out = torch.empty((m, NDIG * other), dtype=torch.int8, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernels.lib().sezkp_gl_digits(
            x.data_ptr(), out.data_ptr(), m, other, int(tile or 0), _kernels.stream_ptr()
        )
    _kernels.check(rc, "gl_digits")
    gl_digits.launches += 1
    return out


def _check_m(m: int, cols: int, what: str) -> None:
    if m < 32 or m > 1024 or m & (m - 1) or cols % 16:
        raise ValueError(
            f"{what} on the card takes a power-of-two m in 32..1024 and a column count that is a multiple of 16"
        )


def digit_dft(src, w, epilogue: str = "recombine", elements: bool = False):
    """K10 wrapper: one axis-0 phase Y = W @ X. src: the k-major digit stack
    int8 [NDIG, other, m] (what `gl_digits` writes), or with elements=True the
    field tensor [m, other], digitised inside the kernel. w: int8
    [NDIG * m, m] (`w_digits`). Returns int32 [m, other] (epilogue "sum": the
    sum of the 15 diagonals, u32 bits) or field [m, other] ("recombine").
    On the card an operand that is not 16-byte aligned (TMA's rule) is
    copied to one that is."""
    _check_epilogue(epilogue, ("sum", "recombine"))
    if elements:
        _need(src, torch.int64, 2, "src")
        m, other = src.shape
    else:
        _need(src, torch.int8, 3, "src")
        if src.shape[0] != NDIG:
            raise ValueError("the digit stack is [NDIG, other, m]")
        other, m = src.shape[1], src.shape[2]
    _need(w, torch.int8, 2, "w")
    if tuple(w.shape) != (NDIG * m, m) or w.device != src.device:
        raise ValueError("w must be [NDIG * m, m] on the data's device")
    if not src.is_cuda:
        return digit_dft_plain(src, w, epilogue, elements)
    _check_m(m, other, "digit_dft")
    src, w = (t.clone() if t.data_ptr() % 16 else t for t in (src, w))
    out = torch.empty((m, other), dtype=torch.int64 if epilogue == "recombine" else torch.int32,
                      device=src.device)
    with torch.cuda.device(src.device):
        rc = _kernels.lib().sezkp_digit_dft(
            w.data_ptr(), 0 if elements else src.data_ptr(), src.data_ptr() if elements else 0,
            out.data_ptr(), m, other, 1 if epilogue == "recombine" else 0, _kernels.stream_ptr(),
        )
    _kernels.check(rc, "digit_dft")
    digit_dft.launches += 1
    return out


def digit_dft_last(x: torch.Tensor, wf: torch.Tensor) -> torch.Tensor:
    """K11 wrapper. x: field [cols, m2 * mc] = X[k1, (k2, b3)]; wf: int8
    [m2, mc, NDIG, mc] (`folded_table`). Returns field [mc, m2 * cols] =
    Y[k3, (k2, k1)]: flat, the natural order of the transform. On the card
    an operand that is not 16-byte aligned (TMA's rule) is copied to one
    that is."""
    _need(x, torch.int64, 2, "x")
    _need(wf, torch.int8, 4, "wf")
    m2, mc = wf.shape[0], wf.shape[1]
    cols = x.shape[0]
    if tuple(wf.shape) != (m2, mc, NDIG, mc) or x.shape[1] != m2 * mc or wf.device != x.device:
        raise ValueError("digit_dft_last takes x [cols, m2 * mc] and wf [m2, mc, NDIG, mc] on one device")
    if not x.is_cuda:
        return digit_dft_last_plain(x, wf)
    _check_m(mc, cols, "digit_dft_last")
    if m2 > 65535:
        raise ValueError("digit_dft_last takes m2 <= 65535")
    x, wf = (t.clone() if t.data_ptr() % 16 else t for t in (x, wf))
    out = torch.empty((mc, m2 * cols), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        rc = _kernels.lib().sezkp_digit_dft_last(
            wf.data_ptr(), x.data_ptr(), out.data_ptr(), cols, m2, mc, _kernels.stream_ptr()
        )
    _kernels.check(rc, "digit_dft_last")
    digit_dft_last.launches += 1
    return out


i8_gemm.launches = 0
gl_digits.launches = 0
digit_dft.launches = 0
digit_dft_last.launches = 0


# ------------------------------ the folded transform -------------------------


def folded_table(l2: int, l3: int, inverse: bool, scale: int = 1, device="cpu") -> torch.Tensor:
    """The last phase's tables with the middle twiddle folded in, one per k2:
    W'[k2][k3, b3] = scale * w_m3^(k3 b3) * w_(m2 m3)^(k2 b3) (canonical), as
    int8 digits [m2, m3, NDIG, m3] = [k2][k3][digit][b3] (NDIG * m2 * m3^2
    bytes). Built on `device`: the field products are plain tensor code, the
    digits are K9's (tiled layout, one tile per row). Cached per device."""
    key = ("wf", l2, l3, inverse, scale, str(torch.device(device)))
    t = _tables.get(key)
    if t is None:
        m2, m3 = 1 << l2, 1 << l3
        w3 = FT.pack(_dft_matrix(l3, inverse, scale), device)  # [k3, b3], symmetric
        tmid = NT._t_mid(l2, l3, inverse, device)  # [k2, b3]
        folded = FT.mul(w3[None, :, :], tmid[:, None, :]).reshape(m2 * m3, m3).contiguous()
        t = gl_digits(folded, tile=m3).reshape(m2, m3, NDIG, m3)
        _tables[key] = t
    return t


def forward_ntt_folded(a: torch.Tensor) -> torch.Tensor:
    """Forward NTT of a three-factor size (n >= 2^18), natural order in and
    out, with the middle twiddle folded into the last phase's tables: phases A
    and B on K2 and K3 (B without its output twiddle), phase C on K11. Equal
    to `ntt_torch.forward_ntt` bit for bit."""
    n = int(a.shape[0])
    n_log2 = n.bit_length() - 1
    logs = _factor_logs(n_log2)
    if a.dim() != 1 or 1 << n_log2 != n or len(logs) != 3 or logs[2] < 5:
        raise ValueError("forward_ntt_folded takes a 1-D power-of-two size from 2^18 up")
    l1, l2, l3 = logs
    m1, m2, m3 = 1 << l1, 1 << l2, 1 << l3
    dev = a.device
    ta, tb = NT._t_outer(l1, l2, l3, False, dev)
    x = NT.phase_axis(a.contiguous().reshape(m1, m2 * m3), 0, False, tw=tb, tw_period=m3)
    x = NT.phase_batched(x.reshape(m1, m2, m3), False, ta=ta, t=None)
    y = digit_dft_last(x.reshape(m1, m2 * m3), folded_table(l2, l3, False, 1, dev))
    return y.reshape(n)

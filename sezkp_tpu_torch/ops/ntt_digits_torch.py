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
  int8 in, int32 or ``& 127`` int8 out. Plain: ``i8_gemm_plain``.
- **K9 ``gl_digits``** (gl_digits.cu): elements -> digits, as the k-major
  stack int8 ``[NDIG, other, m]`` that K10 loads, or with ``tile`` as the
  tiled stack int8 ``[m, NDIG * other]`` of the Pallas probe. Plain:
  ``digits_plain`` and the two ``stack_*`` layouts.
- **K10 ``digit_dft``** (digit_dft.cu): one axis-0 phase from a digit stack
  or from elements, ending in the sum of the diagonals (int32) or the
  recombination (field elements). Plain: ``digit_dft_plain`` on
  ``dot_digits_plain`` and ``recombine_plain``.
- **K11 ``digit_dft_last``** (digit_dft.cu): the last phase of the three-factor
  transform with one table per middle index k2 (the middle twiddle folded
  into the table) and the natural-order transposed store. Plain:
  ``digit_dft_last_plain``.

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


# ------------------------------ kernel wrappers ------------------------------


def _need(t: torch.Tensor, dtype, dims: int, what: str) -> None:
    if t.dtype != dtype or t.dim() != dims or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} tensor with {dims} dims")


def i8_gemm(w, x, nrep: int = 1, epilogue: str = "int32", fuse: bool = False):
    """K8 wrapper. `fuse` picks the kernel's loop order (one product over the
    stacked weights, or nrep products one after the other); the result is the
    same. On the card M, K and N must be multiples of 64."""
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
    sum of the 15 diagonals, u32 bits) or field [m, other] ("recombine")."""
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
    Y[k3, (k2, k1)]: flat, the natural order of the transform."""
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

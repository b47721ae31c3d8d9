"""Multi-step Goldilocks NTT on torch tensors, and the DEEP coset LDE glue.

Counterpart of sezkp_tpu/ops/ntt_mxu.py (the phase kernels and their
composition), of ``ntt_jax._ntt_stages`` (the radix-2 stages, used here as
the plain version) and of sezkp_tpu/ops/ntt_pallas.py: its four-step kernels
for n < 2^14 and its DEEP glue (``scale_pad``, ``deep_divide``,
``deep_coset_lde_planes``).

A transform of n = m1*m2 (two factors) or m1*m2*m3 (three, from 2^18 up)
points runs as one kernel launch per factor, natural order in and out, the
inverse's n^-1 folded into the last phase:

- **K2 ``ntt_phase_axis``** replaces ``ntt_mxu._dft_call``: DFT along axis 0
  of ``[m, other]`` (or axis 1 of ``[other, m]``), then an optional twiddle
  table (full, or periodic along the columns) and an optional scale.
- **K3 ``ntt_phase_batched``** replaces ``ntt_mxu._batched_call``: on
  ``[m1, mc, cols]``, per k1 an optional pre-multiply by ``ta[k1, a2]``, the
  DFT along the middle axis, an optional twiddle ``t[k2, b3]``.
- **K4 ``ntt_phase_last``** replaces ``ntt_mxu._last_call_t``: DFT along the
  last axis of ``[m1, m2, mc]``, written transposed as ``[mc, m2, m1]`` so the
  flat result is in natural order.

Below 2^MIN_LOG2 the transform is the four-step form n = n1*n2 with
n1 = 2^(log2(n) // 2), in one launch:

- **K5 ``ntt_small``** (csrc/ntt_small.cu) replaces ``ntt_pallas``'s
  ``phase_a_kernel`` and ``phase_b_kernel`` and the gathers, the scale and
  the transpose around them: the length-n1 DFT down every column of
  ``[n1, n2]`` times ``w_n^(k1*j2)`` (n^-1 folded into that table for the
  inverse, ``_small_twiddles``), then the length-n2 DFT along every row,
  stored in natural order. Its plain version is ``small_cols_plain`` then
  ``small_rows_plain`` (the plain versions of the two Pallas phases).

K2 and K3 are in csrc/ntt_phases.cu, K4 in csrc/ntt_last.cu. Each moves 16 B
per element per phase plus the twiddle reads; the integer ALU pipe of an
H100, not its memory, is the nearer bound at the main path's shapes
(chip_smoke.py computes both from instruction counts read in the sm_90a
disassembly). At K5's sizes (at most 64 KB of data) a launch's latency is
the cost, not its bytes or operations.

- **K5** is one launch of one thread block cluster of C CTAs
  (``small_plan``: C = 1 up to n = 2^8, 16 from 2^12). CTA c runs phase A on
  its n2/C columns and leaves them in its shared memory; after a cluster
  barrier it reads its n1/C rows from the C CTAs' shared memory (distributed
  shared memory), runs phase B and stores the result; a second barrier keeps
  the CTAs alive while peers read. Both phases run the register passes
  below with 8 elements a thread and the twiddles between passes from
  tables (``small_cluster_model`` is the kernel's schedule in tensor code).
- **K2-K4** run register-resident radix-16 passes (csrc/ntt_reg.cuh;
  ``pass_registers`` and ``emit_index`` below are the same schedule in
  tensor code), templated on m and the direction: no index arithmetic on
  run-time values, one shared memory exchange and one barrier a tile (two
  from m = 512), and every twiddle inside a length-16 DFT, and between
  passes up to m = 64, a power of two (``gl::mul_pow2``: shifts, no 64-bit
  product; 15 of a length-16 DFT's 32 butterflies have none). General
  products remain for the twiddles between passes from m = 128
  (``_pass_twiddles``), the fused tables and the scale. Loads and stores are
  16 B where the layout allows: on the card K2 along axis 0 and K3 take an
  even column count, a periodic twiddle's period is a power of two >= 2,
  and every tensor is 16-byte aligned. K4 (csrc/ntt_last.cu) stages its
  input through shared memory and stores its transposed output straight
  from registers (``phase_last_model`` is its tile in tensor code).

The phase-A twiddle of the three-factor form stays split into
``ta`` (rides K3) and a periodic ``tb`` (rides K2): two small tables that stay
in cache instead of one of n elements to stream.
Each wrapper launches its kernel for a CUDA tensor and runs its plain
version only for a CPU tensor.

The DEEP glue's division y / (x - z) is **K12 ``deep_divide``**
(csrc/deep_divide.cu) on the card: a batched inverse in registers, one launch
where the plain version (``x - z``, ``x^(p-2)`` by square-and-multiply, the
product; plain jnp in the JAX package, outside any kernel) takes some 6,100
elementwise operations. ``deep_divide_model`` is its schedule in tensor code.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import _kernels
from . import goldilocks as G
from . import goldilocks_torch as FT
from . import ntt as ntt_host
from ..utils.tracing import LAUNCH, WAIT, span

MIN_LOG2 = 14  # below this the four-step small-n form (K5); from here up the multi-step form

_tables: Dict[Tuple, torch.Tensor] = {}


def _cached(key: Tuple, device, make) -> torch.Tensor:
    """Twiddle/table tensors are cached per (kind, sizes, inverse, device).
    `make` returns the table as a uint64 array, or as a tensor on `device`."""
    device = torch.device(device)
    k = key + (str(device),)
    t = _tables.get(k)
    if t is None:
        t = make()
        t = t if isinstance(t, torch.Tensor) else FT.pack(t, device)
        _tables[k] = t
    return t


def _factor_logs(n_log2: int) -> list:
    """Balanced factor logs, each <= 10, smallest first."""
    k = 2 if n_log2 <= 17 else 3
    q, r = divmod(n_log2, k)
    return [q] * (k - r) + [q + 1] * r


def _root(n_log2: int, inverse: bool) -> int:
    w = G.primitive_root_2exp(n_log2)
    return G.inv(w) if inverse else w


def _twiddle_np(l1: int, l2: int, inverse: bool) -> np.ndarray:
    n_log2 = l1 + l2
    wp = ntt_host.powers(_root(n_log2, inverse), 1 << n_log2)
    k1 = np.arange(1 << l1, dtype=np.uint64)[:, None]
    j2 = np.arange(1 << l2, dtype=np.uint64)[None, :]
    return wp[(k1 * j2) & np.uint64((1 << n_log2) - 1)]


def _twiddle_matrix(l1: int, l2: int, inverse: bool, device) -> torch.Tensor:
    """T[k1, j2] = w_n^(k1*j2), n = 2^(l1+l2), int64 [m1, m2]."""
    return _cached(("tmat", l1, l2, inverse), device, lambda: _twiddle_np(l1, l2, inverse))


def _small_twiddles(l1: int, l2: int, inverse: bool, device) -> torch.Tensor:
    """K5's table: w_n^(k1*j2), times n^-1 for the inverse (the scale rides
    in it, so phase B multiplies by nothing more), int64 [n1, n2]."""
    if not inverse:
        return _twiddle_matrix(l1, l2, inverse, device)
    return _cached(
        ("tsmall", l1, l2), device,
        lambda: G.mul(_twiddle_np(l1, l2, True), np.uint64(G.inv(1 << (l1 + l2)))),
    )


def _pow_table(n_log2: int, exps: torch.Tensor, inverse: bool) -> torch.Tensor:
    """w_n^e (w_n^-e for the inverse), n = 2^n_log2, for an int64 tensor of
    exponents e >= 0 (taken mod n), on the exponents' device: two gathers from
    tables of 2^ceil(n_log2/2) and 2^floor(n_log2/2) powers and one product, so
    no n-entry table is built."""
    h = n_log2 // 2
    w = _root(n_log2, inverse)
    lo = _cached(("powlo", n_log2, inverse), exps.device, lambda: ntt_host.powers(w, 1 << h))
    hi = _cached(("powhi", n_log2, inverse), exps.device,
                 lambda: ntt_host.powers(G.pow_scalar(w, 1 << h), 1 << (n_log2 - h)))
    e = exps & ((1 << n_log2) - 1)
    return FT.mul(hi[e >> h], lo[e & ((1 << h) - 1)])


def _t_outer(l1: int, l2: int, l3: int, inverse: bool, device):
    """Phase-A twiddle of the three-factor form, w_n^(k1*(a2*m3+a3)), split as
    TA[k1, a2] = w_n^(m3*k1*a2) ([m1, m2]) times TB[k1, a3] = w_n^(k1*a3)
    ([m1, m3]): m1*(m2+m3) table elements to read instead of n. Built on the
    device from two tables of about sqrt(n) powers (`_pow_table`)."""
    m1, m2, m3 = 1 << l1, 1 << l2, 1 << l3
    n_log2 = l1 + l2 + l3

    def table(kind, cols, step):
        def make():
            k1 = torch.arange(m1, dtype=torch.int64, device=device)[:, None]
            c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
            return _pow_table(n_log2, step * k1 * c, inverse)

        return _cached((kind, l1, l2, l3, inverse), device, make)

    return table("ta", m2, m3), table("tb", m3, 1)


def _t_mid(l_mid: int, l_last: int, inverse: bool, device) -> torch.Tensor:
    """Middle-phase twiddle w_r^(k2*b3), r = m_mid*m_last, int64 [m_mid, m_last]."""

    def make():
        wp = ntt_host.powers(_root(l_mid + l_last, inverse), 1 << (l_mid + l_last))
        k2 = np.arange(1 << l_mid, dtype=np.uint64)
        b3 = np.arange(1 << l_last, dtype=np.uint64)
        return wp[k2[:, None] * b3[None, :]]

    return _cached(("tmid", l_mid, l_last, inverse), device, make)


# ----------------------- the pass schedule of K2-K5 -----------------------

# 2^POW2_ROOT_EXP[k] = w_{2^k} (primitive_root_2exp(k)) for k <= 6: 2 has order
# 192 mod p, so every root of unity of order up to 64 is a power of two. The
# kernels hold the same numbers as compile-time constants (csrc/ntt_reg.cuh,
# kRootExp); tests/test_torch_ntt.py checks both against the roots.
POW2_ROOT_EXP = (0, 96, 48, 120, 156, 78, 39)
REG_LOG2 = 4  # a thread holds 16 elements of a vector: radix-16 register passes


def _pow2_exp(k_log2: int, i: int, inverse: bool) -> int:
    """e with 2^e = w_{2^k}^i (w^-i for the inverse), 0 <= e < 192."""
    e = POW2_ROOT_EXP[k_log2] * i % 192
    return (192 - e) % 192 if inverse else e


def _pow2_exps(m_log2: int, inverse: bool, device) -> torch.Tensor:
    """Exponents e_k, 2^e_k = w_m^k (or w_m^-k), k < m, for m <= 64; int64 [m]."""
    if m_log2 > 6:
        raise ValueError("w_m is a power of two only for m <= 64")
    return _cached(
        ("pow2exp", m_log2, inverse), device,
        lambda: np.array([_pow2_exp(m_log2, k, inverse) for k in range(1 << m_log2)], dtype=np.uint64),
    )


def _pass_twiddles(m_log2: int, inverse: bool, device, reg_log2: int = REG_LOG2) -> torch.Tensor:
    """The general twiddles between the first and the second pass for
    m >= 128: PT[t, k1] = w_m^(k1 t), int64 [m/E, E], E = 2^reg_log2
    registers a vector (row t is one thread's)."""

    def make():
        w = ntt_host.powers(_root(m_log2, inverse), 1 << m_log2)
        t = np.arange((1 << m_log2) >> reg_log2, dtype=np.uint64)[:, None]
        k1 = np.arange(1 << reg_log2, dtype=np.uint64)[None, :]
        return w[(t * k1) & np.uint64((1 << m_log2) - 1)]

    return _cached(("passtw", m_log2, inverse, reg_log2), device, make)


def _pass_logs(m_log2: int, reg_log2: int = REG_LOG2) -> list:
    """log2 of each register pass's radix, r = reg_log2: one pass up to 2^r,
    then 2^r x s, then 2^r x 2^r x s."""
    r = reg_log2
    if m_log2 <= r:
        return [m_log2]
    if m_log2 <= 2 * r:
        return [r, m_log2 - r]
    return [r, r, m_log2 - 2 * r]


class _Tally:
    """Field operations per vector of a pass_model run, by the instruction
    class chip_smoke.py counts in the disassembly (mul_pow2 by shift range)."""

    def __init__(self, nvec: int):
        self.nvec, self.ops = nvec, {}

    def add(self, key: str, t: torch.Tensor, where=None) -> None:
        n = int(t.numel() if where is None else torch.broadcast_to(where, t.shape).sum())
        self.ops[key] = self.ops.get(key, 0) + n // self.nvec

    def pow2(self, t: torch.Tensor, e: int) -> None:
        s = e % 96
        if s:
            self.add("pow2_lo" if s <= 32 else "pow2_mid" if s < 64 else "pow2_hi", t)


def _reg_dft(a: torch.Tensor, lr: int, inverse: bool, tally=None) -> torch.Tensor:
    """Length-2^lr DFT along the last axis as one thread runs it in registers
    (ntt_reg.cuh ``dft_reg``): the inputs renamed into bit-reversed order,
    radix-2 DIT stages, every twiddle w_{2^s}^pos a power of two; a twiddle
    2^e with e >= 96 is -2^(e-96), taken by swapping the add and the subtract."""
    b = [a[..., int(i)] for i in ntt_host.bitrev_permutation(1 << lr)]
    for s in range(1, lr + 1):
        half = 1 << (s - 1)
        for q in range(len(b) // 2):
            grp, pos = divmod(q, half)
            i0 = grp * 2 * half + pos
            i1 = i0 + half
            e = _pow2_exp(s, pos, inverse)
            u, v = b[i0], b[i1]
            t = FT.mul_pow2(v, e % 96) if e % 96 else v
            if tally:
                tally.pow2(v, e)
                tally.add("bfly", u)
            s_, d_ = FT.bfly(u, t)
            b[i0], b[i1] = (s_, d_) if e < 96 else (d_, s_)
    return torch.stack(b, dim=-1)


def _twiddle_pow2(a: torch.Tensor, k_log2: int, idx: torch.Tensor, inverse: bool, tally=None):
    """a * w_{2^k}^idx elementwise as the kernels do it between passes:
    mul_pow2 (negation included); idx == 0 is left alone."""
    e = _pow2_exps(k_log2, inverse, a.device)[idx % (1 << k_log2)]
    if tally:
        nz = idx != 0
        for ev in e[nz].unique().tolist():
            sel = nz & (e == ev)
            s = ev % 96
            if s:
                key = "pow2_lo" if s <= 32 else "pow2_mid" if s < 64 else "pow2_hi"
                tally.add(key, a, sel)
            if ev >= 96:
                tally.add("neg", a, sel)
    return torch.where(idx == 0, a, FT.mul_pow2(a, e))


def _plan(m_log2: int, reg_log2: int = REG_LOG2):
    """(E, T, NT) of ntt_reg.cuh's Plan<L, R>: elements a thread holds of a
    vector, threads of a vector, threads of a block (K2-K4's)."""
    e = 1 << min(m_log2, reg_log2)
    return e, (1 << m_log2) // e, 512 if m_log2 == 10 else 256


def emit_index(m_log2: int, reg_log2: int = REG_LOG2) -> torch.Tensor:
    """[T, E] int64: the output index k that register q of thread t holds
    after the last pass, as ntt_reg.cuh's run_passes emits it (emit(k, q))."""
    logs = _pass_logs(m_log2, reg_log2)
    e, T, _ = _plan(m_log2, reg_log2)
    t = torch.arange(T)[:, None]
    q = torch.arange(e)[None, :]
    if len(logs) == 1:
        return q.expand(T, e).clone()
    if len(logs) == 2:
        d = e // T  # transforms of length T a thread
        return t * d + q // T + e * (q % T)
    m2 = 1 << logs[2]
    d = t * (e // m2) + q // m2
    return d // e + e * (d % e) + e * e * (q % m2)


def pass_registers(x: torch.Tensor, m_log2: int, inverse: bool, tally=None,
                   reg_log2: int = REG_LOG2, table: bool = False) -> torch.Tensor:
    """The DFT along the last axis, length m = 2^m_log2, in the order K2-K5
    compute it (ntt_phases.cu, ntt_last.cu, ntt_small.cu on ntt_reg.cuh), left
    where the kernels leave it: [..., T, E], register q of thread t after the
    last pass (``emit_index`` says which output each one is). Thread t of a
    vector holds E = 2^reg_log2 elements (16 in K2-K4; all of them for
    m <= E) and runs, with M1 = m / E:

    - pass 1: x[j1*M1 + t] for j1 < E -> a length-E DFT in registers
      -> times w_m^(k1 t) (powers of two for m <= 64, ``mul_pow2``; the table
      ``_pass_twiddles`` and ``mul`` from m = 128, or at every m with
      ``table``) -> shared memory at position k1*M1 + t;
    - m <= E^2: pass 2 reads positions E*t .. E*t+E-1, i.e. E/M1 vectors of
      length M1 (k1 = t*E/M1 + i), and their DFTs are y[k1 + E k2];
    - m > E^2 (M1 = E*M2): pass 2, thread t = E*jj + k1, reads positions
      k1*M1 + j2a*M2 + jj, a length-E DFT, times w_M1^(k2a jj) (powers of
      two), written back in place; pass 3 reads positions E*t .. E*t+E-1 =
      d*M2 + j3 (d = E k1 + k2a), length-M2 DFTs, y[k1 + E k2a + E^2 k3]."""
    batch = x.shape[:-1]
    m = 1 << m_log2
    logs = _pass_logs(m_log2, reg_log2)
    e = 1 << logs[0]
    T = m >> logs[0]
    a = _reg_dft(x.reshape(batch + (e, T)).transpose(-1, -2), logs[0], inverse, tally)
    if len(logs) == 1:
        return a  # [..., 1, m]
    t = torch.arange(T, device=x.device)[:, None]
    k1 = torch.arange(e, device=x.device)[None, :]
    if m_log2 <= 6 and not table:
        a = _twiddle_pow2(a, m_log2, t * k1, inverse, tally)
    else:
        pt = _pass_twiddles(m_log2, inverse, x.device, reg_log2)
        a = torch.cat([a[..., :1], FT.mul(a[..., 1:], pt[:, 1:])], -1)
        if tally:
            tally.add("mul", a[..., 1:])
    pos = a.transpose(-1, -2).reshape(batch + (m,))  # position k1*M1 + t
    if len(logs) == 2:
        # [t, i, k2]: thread t's transforms i, register q = i*T + k2
        return _reg_dft(pos.reshape(batch + (T, e // T, T)), logs[1], inverse, tally).reshape(batch + (T, e))
    m2 = 1 << logs[2]
    q = _reg_dft(pos.reshape(batch + (e, e, m2)).transpose(-1, -2), logs[0], inverse, tally)
    jj = torch.arange(m2, device=x.device)[:, None]
    k2a = torch.arange(e, device=x.device)[None, :]
    q = _twiddle_pow2(q, m_log2 - logs[0], jj * k2a, inverse, tally)  # [.., k1, jj, k2a]
    y = _reg_dft(q.transpose(-1, -2), logs[2], inverse, tally)  # [.., k1, k2a, k3]
    # d = E k1 + k2a = t*(E/M2) + i, register q = i*M2 + k3
    return y.reshape(batch + (T, e))


def pass_model(x: torch.Tensor, m_log2: int, inverse: bool, tally=None,
               reg_log2: int = REG_LOG2, table: bool = False) -> torch.Tensor:
    """The DFT along the last axis in the kernels' pass schedule, natural
    order: ``pass_registers`` stored at ``emit_index``. The plain model the
    kernels' design is rehearsed on without the card."""
    regs = pass_registers(x, m_log2, inverse, tally, reg_log2, table)
    y = torch.empty(x.shape, dtype=regs.dtype, device=x.device)
    y[..., emit_index(m_log2, reg_log2).reshape(-1).to(x.device)] = regs.reshape(x.shape)
    return y


def phase_last_model(x: torch.Tensor, inverse: bool, scale: int = 1) -> torch.Tensor:
    """K4's tile in tensor code (csrc/ntt_last.cu), for x [m1, m2, mc]: block
    (b, k2) of the grid (ceil(m1 / V), m2) takes the V values of k1 from
    b * V (rows past m1 are not loaded and not stored: zeros stand in for
    them here); thread (v, t) = (tid % V, tid // V) holds vector
    k1 = b*V + v; the register passes (``pass_registers``); the scale; and
    each register stored by address, straight from registers, at
    y[(k*m2 + k2)*m1 + k1] with k = ``emit_index``[t, q]. Returns
    y [mc, m2, m1]; raises if an address is written other than once."""
    m1, m2, mc = x.shape
    m_log2 = mc.bit_length() - 1
    _, T, NT = _plan(m_log2)
    V = NT // T
    nblk = -(-m1 // V)
    xp = torch.zeros((nblk * V, m2, mc), dtype=x.dtype, device=x.device)
    xp[:m1] = x
    regs = pass_registers(xp, m_log2, inverse)  # [k1, k2, t, q]
    if scale != 1:
        regs = FT.mul(regs, FT.scalar(scale, regs))
    tid = torch.arange(NT, device=x.device)
    v, t = tid % V, tid // V
    k1 = torch.arange(nblk, device=x.device)[:, None] * V + v[None, :]  # [b, tid]
    k2 = torch.arange(m2, device=x.device)
    k = emit_index(m_log2).to(x.device)[t]  # [tid, q]
    shape = (nblk, m2, NT, k.shape[1])
    k1b = k1[:, None, :, None].expand(shape)
    k2b = k2[None, :, None, None].expand(shape)
    tb = t[None, None, :, None].expand(shape)
    qb = torch.arange(k.shape[1], device=x.device)[None, None, None, :].expand(shape)
    kb = k[None, None, :, :].expand(shape)
    live = k1b < m1
    addr = ((kb * m2 + k2b) * m1 + k1b)[live]
    val = regs[k1b[live], k2b[live], tb[live], qb[live]]
    writes = torch.bincount(addr, minlength=mc * m2 * m1)
    if writes.numel() != mc * m2 * m1 or not bool((writes == 1).all()):
        raise AssertionError("K4's stores do not cover the output once each")
    y = torch.empty(mc * m2 * m1, dtype=x.dtype, device=x.device)
    y[addr] = val
    return y.reshape(mc, m2, m1)


def pass_counts(m_log2: int, inverse: bool, reg_log2: int = REG_LOG2, table: bool = False) -> dict:
    """Field operations per vector of length 2^m_log2 in the kernels' pass
    schedule (general ``mul``; ``bfly``, the butterflies; ``mul_pow2`` by
    shift range; ``neg``), for the operation bounds of
    chip_smoke.py. The fused table twiddles and the scale are not in it."""
    tally = _Tally(1)
    pass_model(torch.zeros(1 << m_log2, dtype=torch.int64), m_log2, inverse, tally, reg_log2, table)
    return tally.ops


# K5's constants, as csrc/ntt_small.cu has them (kReg, kClusterCap,
# kMinThreads; tests/test_torch_ntt.py compares the two)
SMALL_REG_LOG2 = 3  # a thread holds 2^3 elements of a vector
SMALL_CLUSTER_CAP = 16  # the largest cluster
SMALL_MIN_THREADS = 32  # a CTA's threads before the transform takes more CTAs


def small_plan(n_log2: int) -> dict:
    """ntt_small.cu's Small<L> for n = 2^n_log2: the factor logs l1, l2; the
    cluster's CTAs C; a CTA's phase-A columns and phase-B rows; the threads
    busy in each phase (na, nb) and a CTA's threads (nt)."""
    l1 = min(10, n_log2 // 2)
    l2 = n_log2 - l1
    _, ta, _ = _plan(l1, SMALL_REG_LOG2)
    _, tb, _ = _plan(l2, SMALL_REG_LOG2)
    tot = max((1 << l2) * ta, (1 << l1) * tb)
    c = min(max(tot // SMALL_MIN_THREADS, 1), SMALL_CLUSTER_CAP, 1 << l1)
    cols, rows = (1 << l2) // c, (1 << l1) // c
    return dict(l1=l1, l2=l2, C=c, cols=cols, rows=rows, na=cols * ta, nb=rows * tb,
                nt=max(cols * ta, rows * tb))


def small_cluster_model(a: torch.Tensor, inverse: bool, cluster: int = None) -> torch.Tensor:
    """K5's schedule in tensor code (csrc/ntt_small.cu), for a [n], n < 2^14,
    with a cluster of ``cluster`` CTAs (default: the kernel's, ``small_plan``).
    Phase A: CTA c takes columns j2 = c*cols + col of A [n1, n2]; thread
    (col, t)'s registers are x[(j1*TA + t)*n2 + j2]; the register passes
    (``pass_registers``); register q, output k1 = ``emit_index``[t, q], times
    ``_small_twiddles``[k1, j2] is stored in CTA c's shared memory at
    k1*cols + col. Phase B: CTA c takes rows k1 = c*rows + r and reads
    B[k1, j2] from CTA j2 // cols at k1*cols + j2 % cols; the register passes;
    register q of thread t, output k2 = ``emit_index``[t, q], is stored at
    y[k1 + n1*k2]. Raises if a shared-memory slot or an output is written
    other than once. Returns y [n]."""
    n = int(a.shape[0])
    n_log2 = n.bit_length() - 1
    p = small_plan(n_log2)
    l1, l2, c = p["l1"], p["l2"], cluster or p["C"]
    n1, n2 = 1 << l1, 1 << l2
    cols, slice_ = n2 // c, n // c
    dev = a.device
    # phase A: the registers of column j2's threads, [n2, TA, EA]
    regs = pass_registers(a.reshape(n1, n2).T, l1, inverse, reg_log2=SMALL_REG_LOG2, table=True)
    k1 = emit_index(l1, SMALL_REG_LOG2).to(dev)[None]  # [1, TA, EA]
    j2 = torch.arange(n2, device=dev)[:, None, None]
    val = FT.mul(regs, _small_twiddles(l1, l2, inverse, dev)[k1, j2])
    slot = (j2 // cols) * slice_ + k1 * cols + j2 % cols  # (CTA, address in its shared memory)
    if not bool((torch.bincount(slot.reshape(-1), minlength=n) == 1).all()):
        raise AssertionError("K5's phase A does not fill the CTAs' shared memory once each")
    shared = torch.empty(n, dtype=a.dtype, device=dev)
    shared[slot.reshape(-1)] = val.reshape(-1)
    # phase B: row k1 gathered from the CTAs that hold its columns
    rk1 = torch.arange(n1, device=dev)[:, None]
    rj2 = torch.arange(n2, device=dev)[None, :]
    rows = shared[(rj2 // cols) * slice_ + rk1 * cols + rj2 % cols]  # [n1, n2]
    regs = pass_registers(rows, l2, inverse, reg_log2=SMALL_REG_LOG2, table=True)  # [n1, TB, EB]
    k2 = emit_index(l2, SMALL_REG_LOG2).to(dev)[None]
    addr = (rk1[:, :, None] + n1 * k2).reshape(-1)
    if not bool((torch.bincount(addr, minlength=n) == 1).all()):
        raise AssertionError("K5's stores do not cover the output once each")
    y = torch.empty(n, dtype=a.dtype, device=dev)
    y[addr] = regs.reshape(-1)
    return y


# ------------------------------ plain versions ------------------------------


def _stage_tables(m_log2: int, inverse: bool, device):
    return [
        _cached(("stage", m_log2, s, inverse), device, lambda t=t: t)
        for s, t in enumerate(ntt_host.twiddle_tables(m_log2, inverse), start=1)
    ]


def _ntt_stages(x: torch.Tensor, m_log2: int, inverse: bool) -> torch.Tensor:
    """Radix-2 DIT stages over the LAST axis; leading axes are batch dims."""
    m = 1 << m_log2
    tables = _stage_tables(m_log2, inverse, x.device)
    perm = torch.as_tensor(ntt_host.bitrev_permutation(m), device=x.device)
    x = x[..., perm]
    batch = x.shape[:-1]
    for s in range(1, m_log2 + 1):
        half = 1 << (s - 1)
        blk = x.reshape(batch + (m >> s, 2, half))
        u = blk[..., 0, :]
        v = FT.mul(blk[..., 1, :], tables[s - 1])
        x = torch.stack([FT.add(u, v), FT.sub(u, v)], dim=-2).reshape(batch + (m,))
    return x


def _scaled(y, scale: int):
    return y if scale == 1 else FT.mul(y, FT.scalar(scale, y))


def phase_axis_plain(x, axis: int, inverse: bool, tw=None, tw_period=None, scale: int = 1):
    """Plain PyTorch version of K2."""
    if axis == 0:
        m, other = x.shape
        y = _ntt_stages(x.T, m.bit_length() - 1, inverse).T
        if tw is not None:
            if tw_period is not None:
                tw = tw.repeat(1, other // tw_period)
            y = FT.mul(y, tw)
    else:
        other, m = x.shape
        y = _ntt_stages(x, m.bit_length() - 1, inverse)
        if tw is not None:
            y = FT.mul(y, tw)
    return _scaled(y, scale).contiguous()


def phase_batched_plain(x, inverse: bool, ta=None, t=None):
    """Plain PyTorch version of K3: x [m1, mc, cols]."""
    m1, mc, cols = x.shape
    if ta is not None:
        x = FT.mul(x, ta[:, :, None])
    y = _ntt_stages(x.transpose(1, 2), mc.bit_length() - 1, inverse).transpose(1, 2)
    if t is not None:
        y = FT.mul(y, t[None, :, :])
    return y.contiguous()


def phase_last_plain(x, inverse: bool, scale: int = 1):
    """Plain PyTorch version of K4: x [m1, m2, mc] -> [mc, m2, m1]."""
    mc = x.shape[2]
    y = _ntt_stages(x, mc.bit_length() - 1, inverse)
    return _scaled(y, scale).permute(2, 1, 0).contiguous()


def small_cols_plain(x, inverse: bool, tw):
    """K5's phase A (``ntt_pallas.phase_a_kernel``), plain: x [n1, n2] ->
    [n1, n2], the DFT down every column times tw."""
    n1 = x.shape[0]
    return FT.mul(_ntt_stages(x.T, n1.bit_length() - 1, inverse).T, tw).contiguous()


def small_rows_plain(x, inverse: bool, scale: int = 1):
    """K5's phase B (``ntt_pallas.phase_b_kernel``) with the scale and the
    transpose, plain: x [n1, n2] -> [n2, n1]."""
    n2 = x.shape[1]
    return _scaled(_ntt_stages(x, n2.bit_length() - 1, inverse), scale).T.contiguous()


def small_ntt_plain(a, inverse: bool):
    """Plain PyTorch version of K5: the NTT of a [n], n = 2^1 .. 2^13,
    natural order, the inverse scaled by n^-1 (phase A, then phase B)."""
    n = int(a.shape[0])
    n_log2 = n.bit_length() - 1
    l1 = min(10, n_log2 // 2)
    l2 = n_log2 - l1
    x = small_cols_plain(a.reshape(1 << l1, 1 << l2), inverse, _twiddle_matrix(l1, l2, inverse, a.device))
    return small_rows_plain(x, inverse, scale=G.inv(n) if inverse else 1).reshape(n)


# ------------------------------ kernel wrappers -----------------------------


def _check_field(x: torch.Tensor, dims: int, what: str) -> None:
    if x.dtype != torch.int64 or x.dim() != dims or not x.is_contiguous():
        raise ValueError(f"{what} takes a contiguous int64 tensor with {dims} dims")


def _ptr(t, device) -> int:
    if t is None:
        return 0
    if t.dtype != torch.int64 or not t.is_contiguous() or t.device != device:
        raise ValueError("twiddle tables must be contiguous int64 tensors on the data's device")
    return t.data_ptr()


def _check_aligned(*ts) -> None:
    for t in ts:
        if t is not None and t.data_ptr() % 16:
            raise ValueError("K2-K4 take 16-byte aligned tensors (their loads and stores are 16 B)")


def phase_axis(x, axis: int, inverse: bool, tw=None, tw_period=None, scale: int = 1):
    """K2 wrapper. axis 0: x [m, other]; axis 1: x [other, m]. tw: full table
    of x's shape, or (axis 0 only) [m, tw_period] repeating along columns.
    On the card: axis 0 takes an even `other`, tw_period a power of two >= 2."""
    if not x.is_cuda:
        return phase_axis_plain(x, axis, inverse, tw, tw_period, scale)
    _check_field(x, 2, "phase_axis")
    m, other = (x.shape[0], x.shape[1]) if axis == 0 else (x.shape[1], x.shape[0])
    m_log2 = m.bit_length() - 1
    if tw is not None:
        want = (m, tw_period) if tw_period is not None else tuple(x.shape)
        if tuple(tw.shape) != want or (tw_period is not None and other % tw_period):
            raise ValueError("twiddle table shape does not match")
    if tw_period is not None and (tw_period < 2 or tw_period & (tw_period - 1)):
        raise ValueError("phase_axis on the card takes a tw_period that is a power of two >= 2")
    if axis == 0 and other % 2:
        raise ValueError("phase_axis along axis 0 on the card takes an even number of columns")
    y = torch.empty_like(x)
    _check_aligned(x, y, tw)
    pt = _pass_twiddles(m_log2, inverse, x.device) if m_log2 >= 7 else None
    with torch.cuda.device(x.device):
        rc = _kernels.lib().sezkp_ntt_phase_axis(
            x.data_ptr(), y.data_ptr(), m_log2, other, axis, int(inverse),
            _ptr(pt, x.device), _ptr(tw, x.device),
            int(tw_period or 0), int(scale), _kernels.stream_ptr(),
        )
    _kernels.check(rc, "ntt_phase_axis")
    phase_axis.launches += 1
    return y


def phase_batched(x, inverse: bool, ta=None, t=None):
    """K3 wrapper: x [m1, mc, cols] -> same shape. ta [m1, mc], t [mc, cols].
    On the card: cols even."""
    if not x.is_cuda:
        return phase_batched_plain(x, inverse, ta, t)
    _check_field(x, 3, "phase_batched")
    m1, mc, cols = x.shape
    if ta is not None and tuple(ta.shape) != (m1, mc):
        raise ValueError("ta must be [m1, mc]")
    if t is not None and tuple(t.shape) != (mc, cols):
        raise ValueError("t must be [mc, cols]")
    if cols % 2:
        raise ValueError("phase_batched on the card takes an even number of columns")
    mc_log2 = mc.bit_length() - 1
    y = torch.empty_like(x)
    _check_aligned(x, y, t)
    pt = _pass_twiddles(mc_log2, inverse, x.device) if mc_log2 >= 7 else None
    with torch.cuda.device(x.device):
        rc = _kernels.lib().sezkp_ntt_phase_batched(
            x.data_ptr(), y.data_ptr(), m1, mc_log2, cols, int(inverse),
            _ptr(pt, x.device), _ptr(ta, x.device), _ptr(t, x.device), _kernels.stream_ptr(),
        )
    _kernels.check(rc, "ntt_phase_batched")
    phase_batched.launches += 1
    return y


def phase_last(x, inverse: bool, scale: int = 1):
    """K4 wrapper: x [m1, m2, mc] -> [mc, m2, m1] (flat = natural order).
    On the card x is 16-byte aligned."""
    if not x.is_cuda:
        return phase_last_plain(x, inverse, scale)
    _check_field(x, 3, "phase_last")
    m1, m2, mc = x.shape
    mc_log2 = mc.bit_length() - 1
    y = torch.empty((mc, m2, m1), dtype=torch.int64, device=x.device)
    _check_aligned(x, y)
    pt = _pass_twiddles(mc_log2, inverse, x.device) if mc_log2 >= 7 else None
    with torch.cuda.device(x.device):
        rc = _kernels.lib().sezkp_ntt_phase_last(
            x.data_ptr(), y.data_ptr(), m1, m2, mc_log2, int(inverse),
            _ptr(pt, x.device), int(scale), _kernels.stream_ptr(),
        )
    _kernels.check(rc, "ntt_phase_last")
    phase_last.launches += 1
    return y


_small_args: Dict[Tuple, Tuple] = {}


def _small_tables(n_log2: int, inverse: bool, device) -> Tuple:
    """K5's tables for n = 2^n_log2 on `device` and the pointers the launch
    takes (the four-step twiddles, phase A's and phase B's pass twiddles or
    0), looked up once: the wrapper's host time is most of a small
    transform's time issued from Python."""
    key = (n_log2, inverse, device)
    args = _small_args.get(key)
    if args is None:
        p = small_plan(n_log2)
        tables = (_small_twiddles(p["l1"], p["l2"], inverse, device),) + tuple(
            _pass_twiddles(l, inverse, device, SMALL_REG_LOG2) if l > SMALL_REG_LOG2 else None
            for l in (p["l1"], p["l2"]))
        args = _small_args[key] = (tables, tuple(_ptr(t, device) for t in tables))
    return args


def small_ntt(a, inverse: bool):
    """K5 wrapper: the NTT of a [n], n = 2^1 .. 2^13, natural order in and
    out, the inverse scaled by n^-1: one launch of one thread block cluster."""
    if not a.is_cuda:
        return small_ntt_plain(a, inverse)
    _check_field(a, 1, "small_ntt")
    n = int(a.shape[0])
    n_log2 = n.bit_length() - 1
    if n != 1 << n_log2 or not 1 <= n_log2 < MIN_LOG2:
        raise ValueError(f"small_ntt takes n = 2^1 .. 2^{MIN_LOG2 - 1}")
    tw, pta, ptb = _small_tables(n_log2, inverse, a.device)[1]
    y = torch.empty_like(a)
    with torch.cuda.device(a.device):
        rc = _kernels.lib().sezkp_ntt_small(
            a.data_ptr(), y.data_ptr(), n_log2, int(inverse), tw, pta, ptb, _kernels.stream_ptr())
    _kernels.check(rc, "ntt_small")
    small_ntt.launches += 1
    return y


phase_axis.launches = 0
phase_batched.launches = 0
phase_last.launches = 0
small_ntt.launches = 0


# ------------------------------ whole transforms -----------------------------


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous, and on the card 16-byte aligned (copied if not): the
    phase kernels K2-K4 take 16-byte aligned rows."""
    x = x.contiguous()
    return x.clone() if x.is_cuda and x.data_ptr() % 16 else x


def _ntt(a: torch.Tensor, inverse: bool) -> torch.Tensor:
    n = int(a.shape[0])
    n_log2 = n.bit_length() - 1
    assert a.dim() == 1 and 1 << n_log2 == n
    if n <= 1:
        return a.clone()
    a = a.contiguous()
    if n_log2 < MIN_LOG2:
        return small_ntt(a, inverse)
    dev = a.device
    inv_n = G.inv(n) if inverse else 1
    a = _aligned(a)
    logs = _factor_logs(n_log2)
    if len(logs) == 2:
        l1, l2 = logs
        m1, m2 = 1 << l1, 1 << l2
        x = phase_axis(a.reshape(m1, m2), 0, inverse, tw=_twiddle_matrix(l1, l2, inverse, dev))
        x = phase_axis(x, 1, inverse, scale=inv_n)
        # natural order: y[k1 + m1*k2] = Y[k1, k2]
        return x.T.reshape(n)
    l1, l2, l3 = logs
    m1, m2, m3 = 1 << l1, 1 << l2, 1 << l3
    ta, tb = _t_outer(l1, l2, l3, inverse, dev)
    x = phase_axis(a.reshape(m1, m2 * m3), 0, inverse, tw=tb, tw_period=m3)
    x = phase_batched(x.reshape(m1, m2, m3), inverse, ta=ta, t=_t_mid(l2, l3, inverse, dev))
    x = phase_last(x, inverse, scale=inv_n)
    return x.reshape(n)


def forward_ntt(a: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations, natural order; int64 [n] field tensor."""
    return _ntt(a, False)


def inverse_ntt(a: torch.Tensor) -> torch.Tensor:
    """Evaluations -> coefficients (scaled by n^-1)."""
    return _ntt(a, True)


def forward_ntt_u64(a: np.ndarray, device=None) -> np.ndarray:
    return FT.unpack(forward_ntt(FT.pack(a, torch.device("cuda" if device is None else device))))


def inverse_ntt_u64(a: np.ndarray, device=None) -> np.ndarray:
    return FT.unpack(inverse_ntt(FT.pack(a, torch.device("cuda" if device is None else device))))


# ------------------------------ DEEP coset LDE ------------------------------


def _deep_lde_tables(base_log2: int, lde_log2: int, shift: int, device):
    """Shift powers [n_base] and coset points [lde_n] on the device."""
    shift_pows = _cached(
        ("shiftpow", base_log2, shift), device, lambda: ntt_host.powers(shift, 1 << base_log2)
    )
    xs = _cached(
        ("coset", lde_log2, shift), device,
        lambda: G.mul(
            np.uint64(shift),
            ntt_host.powers(G.primitive_root_2exp(lde_log2), 1 << lde_log2),
        ),
    )
    return shift_pows, xs


def scale_pad(coeffs: torch.Tensor, shift_pows: torch.Tensor, lde_n: int) -> torch.Tensor:
    out = torch.zeros(lde_n, dtype=torch.int64, device=coeffs.device)
    out[: coeffs.shape[0]] = FT.mul(coeffs, shift_pows)
    return out


DIVIDE_POINTS, DIVIDE_THREADS = 8, 128  # K12: points a thread, threads a block (kPoints, kThreads)


def deep_divide_plain(y: torch.Tensor, z: int, xs: torch.Tensor) -> torch.Tensor:
    """y / (xs - z) elementwise on any device: x - z, the inverse by
    ``FT.pow_p_minus_2`` (0 -> 0), the product."""
    return FT.mul(y, FT.pow_p_minus_2(FT.sub(xs, FT.scalar(z, xs))))


def deep_divide(y: torch.Tensor, z: int, xs: torch.Tensor) -> torch.Tensor:
    """y / (xs - z) elementwise, 1/0 taken as 0; z an int. K12 wrapper: for
    CUDA tensors (contiguous int64 of one shape) one launch, z passed by
    value; for CPU tensors ``deep_divide_plain``."""
    if not y.is_cuda:
        return deep_divide_plain(y, z, xs)
    for t in (y, xs):
        if t.dtype != torch.int64 or not t.is_contiguous() or t.shape != y.shape or t.device != y.device:
            raise ValueError("deep_divide takes contiguous int64 tensors of one shape on one device")
    out = torch.empty_like(y)
    if out.numel() == 0:
        return out
    with torch.cuda.device(y.device):
        rc = _kernels.lib().sezkp_deep_divide(
            y.data_ptr(), xs.data_ptr(), out.data_ptr(), y.numel(), int(z) % FT.P_INT, _kernels.stream_ptr())
    _kernels.check(rc, "deep_divide")
    deep_divide.launches += 1
    return out


deep_divide.launches = 0


def inverse_chain(x: torch.Tensor) -> torch.Tensor:
    """x^(p-2) by K12's addition chain (csrc/deep_divide.cu ``pow_p_minus_2``):
    with t_k = x^(2^k - 1), t_2, t_3, t_6, t_12, t_24, t_30 = t_24^(2^6) t_6,
    t_31; s = t_31^2; s^(2^32) * (s x). 63 squarings and 9 multiplies."""
    def sqr_n(a, n):
        for _ in range(n):
            a = FT.mul(a, a)
        return a

    t2 = FT.mul(sqr_n(x, 1), x)
    t3 = FT.mul(sqr_n(t2, 1), x)
    t6 = FT.mul(sqr_n(t3, 3), t3)
    t12 = FT.mul(sqr_n(t6, 6), t6)
    t24 = FT.mul(sqr_n(t12, 12), t12)
    t30 = FT.mul(sqr_n(t24, 6), t6)
    t31 = FT.mul(sqr_n(t30, 1), x)
    s = sqr_n(t31, 1)
    return FT.mul(sqr_n(s, 32), FT.mul(s, x))


def deep_divide_model(y: torch.Tensor, z: int, xs: torch.Tensor, k: int = DIVIDE_POINTS,
                      threads: int = DIVIDE_THREADS) -> torch.Tensor:
    """K12's schedule in tensor code, for flat y, xs [n]: thread t of block b
    owns the k points b*k*threads + j*threads + t; d_j = xs - z, a zero d_j
    and a point past n enter as 1; the prefix products c_j; one inverse of
    c_{k-1} by ``inverse_chain``; back through the prefixes, d_j^-1 =
    inv * c_{j-1} and inv *= d_j; each live point stored by address, y * d^-1,
    or 0 where d_j was 0. Raises if an address is written other than once."""
    n = int(y.shape[0])
    per_block = k * threads
    nblk = -(-n // per_block)
    idx = torch.arange(nblk * per_block, device=y.device).reshape(nblk, k, threads)  # [b, j, t]
    live = idx < n
    src = idx.clamp(max=n - 1)
    d = FT.sub(xs[src], FT.scalar(z, xs))
    zero = live & (d == 0)
    d = torch.where(zero | ~live, torch.ones_like(d), d)
    c = [d[:, 0]]
    for j in range(1, k):
        c.append(FT.mul(c[-1], d[:, j]))
    inv = inverse_chain(c[-1])
    dinv = [None] * k
    for j in range(k - 1, 0, -1):
        dinv[j] = FT.mul(inv, c[j - 1])
        inv = FT.mul(inv, d[:, j])
    dinv[0] = inv
    val = torch.where(zero, torch.zeros_like(d), FT.mul(y[src], torch.stack(dinv, 1)))
    addr = idx[live]
    writes = torch.bincount(addr, minlength=n)
    if writes.numel() != n or not bool((writes == 1).all()):
        raise AssertionError("K12's stores do not cover the output once each")
    out = torch.empty(n, dtype=y.dtype, device=y.device)
    out[addr] = val[live]
    return out


def deep_coset_lde(base: torch.Tensor, blow_log2: int, shift: int, z: int) -> torch.Tensor:
    """y[i] = LDE(base)(x_i) / (x_i - z) over the coset shift*<w> of size
    n*2^blow: INTT -> shift-scale + zero-pad -> NTT -> divide. Takes and
    returns device-resident field tensors (no host round trip). While a
    prove is recorded the four parts are spans that synchronise at their
    ends, so that each is charged its device time."""
    n_base = int(base.shape[0])
    base_log2 = n_base.bit_length() - 1
    assert 1 << base_log2 == n_base
    lde_log2 = base_log2 + blow_log2
    with span("lde.intt", LAUNCH, sync=True):
        coeffs = inverse_ntt(base)
    # the tables are cached after the first prove
    with span("lde.tables", WAIT, sync=True):
        shift_pows, xs = _deep_lde_tables(base_log2, lde_log2, shift, base.device)
    with span("lde.coset_ntt", LAUNCH, sync=True):
        y = forward_ntt(scale_pad(coeffs, shift_pows, 1 << lde_log2))
    with span("lde.divide", LAUNCH, sync=True):
        return deep_divide(y, z, xs)


def deep_coset_lde_u64(base_evals: np.ndarray, blow_log2: int, shift: int, z: int, device=None):
    device = torch.device("cuda" if device is None else device)
    return FT.unpack(deep_coset_lde(FT.pack(base_evals, device), blow_log2, shift, z))


# ------------------- batched transforms along one axis ----------------------
#
# The local steps of the sharded four-step NTT (parallel/ntt_sharded.py): the
# DFT down every column of [m, C] with the step-2 twiddle fused, and the DFT
# along every row of [R, m]. Up to 2^max_phase_log2 points (K2's largest m)
# one K2 launch; above, two phases (K2 and K3) of the factorisation `_ntt`
# uses, and one copy that puts the two output digits in natural order.

MAX_PHASE_LOG2 = 10


def _step2_twiddle(n_log2: int, rows: torch.Tensor, col0: int, cols: int, inverse: bool) -> torch.Tensor:
    """T[i, c] = w_n^(rows[i] * (col0 + c)), int64 [len(rows), cols]."""
    c = col0 + torch.arange(cols, dtype=torch.int64, device=rows.device)
    return _pow_table(n_log2, rows[:, None] * c[None, :], inverse)


def _split_logs(m_log2: int, max_phase_log2: int) -> Tuple[int, int]:
    la = m_log2 // 2
    if max(la, m_log2 - la) > max_phase_log2:
        raise ValueError(f"a transform of 2^{m_log2} points takes more than two phases of "
                         f"at most 2^{max_phase_log2}")
    return la, m_log2 - la


def ntt_axis0(x: torch.Tensor, inverse: bool, n_log2: int = None, col0: int = 0,
              max_phase_log2: int = MAX_PHASE_LOG2) -> torch.Tensor:
    """The length-m DFT down every column of x [m, C], natural order in and
    out; with `n_log2`, output (k, c) times w_n^(k * (col0 + c)), the step-2
    twiddle of a four-step transform of n points whose columns col0 ..
    col0 + C - 1 x holds. On the card C is even.

    One phase (m <= 2^max_phase_log2): K2 with that table fused. Two
    (m = a*b, j = ja*b + jb, k = ka + a*kb): K2 down the ja axis of
    [a, b*C] times w_n^(ka*(col0 + c)) (a table of period C), then K3 on
    [a, b, C] with ta = w_m^(ka*jb) before and t = w_n^(a*kb*(col0 + c))
    after its DFT over jb; the result [ka, kb, C] is copied to [kb, ka, C]."""
    x = _aligned(x)
    m, cols = x.shape
    m_log2 = m.bit_length() - 1
    dev = x.device
    tw_key = ("step2", n_log2, m_log2, col0, cols, inverse)
    if m_log2 <= max_phase_log2:
        tw = None if n_log2 is None else _cached(tw_key, dev, lambda: _step2_twiddle(
            n_log2, torch.arange(m, dtype=torch.int64, device=dev), col0, cols, inverse))
        return phase_axis(x, 0, inverse, tw=tw)
    la, lb = _split_logs(m_log2, max_phase_log2)
    a, b = 1 << la, 1 << lb
    tw1 = t = None
    if n_log2 is not None:
        ka = torch.arange(a, dtype=torch.int64, device=dev)
        kb = torch.arange(b, dtype=torch.int64, device=dev)
        tw1 = _cached(tw_key + ("a",), dev, lambda: _step2_twiddle(n_log2, ka, col0, cols, inverse))
        t = _cached(tw_key + ("b",), dev, lambda: _step2_twiddle(n_log2, a * kb, col0, cols, inverse))
    y = phase_axis(x.reshape(a, b * cols), 0, inverse, tw=tw1, tw_period=None if tw1 is None else cols)
    y = phase_batched(y.reshape(a, b, cols), inverse, ta=_twiddle_matrix(la, lb, inverse, dev), t=t)
    return y.transpose(0, 1).contiguous().reshape(m, cols)


def ntt_axis1(x: torch.Tensor, inverse: bool, scale: int = 1,
              max_phase_log2: int = MAX_PHASE_LOG2) -> torch.Tensor:
    """The length-m DFT along every row of x [R, m], natural order in and out,
    times `scale`. One phase: K2. Two (m = m1*m2, j = j1*m2 + j2,
    k = k1 + m1*k2): K3 on [R, m1, m2], the DFT over j1 times w_m^(k1*j2),
    then K2 along the rows of [R*m1, m2] with the scale; the result
    [R, k1, k2] is copied to [R, k2, k1]."""
    x = _aligned(x)
    rows, m = x.shape
    m_log2 = m.bit_length() - 1
    if m_log2 <= max_phase_log2:
        return phase_axis(x, 1, inverse, scale=scale)
    l1, l2 = _split_logs(m_log2, max_phase_log2)
    m1, m2 = 1 << l1, 1 << l2
    y = phase_batched(x.reshape(rows, m1, m2), inverse, t=_twiddle_matrix(l1, l2, inverse, x.device))
    y = phase_axis(y.reshape(rows * m1, m2), 1, inverse, scale=scale)
    return y.reshape(rows, m1, m2).transpose(1, 2).contiguous().reshape(rows, m)

"""Port NTT (plain versions of the phase kernels, on the CPU) vs the JAX
package: the MXU kernels in interpret mode at 2^14, the roll-based four-step
kernels in interpret mode below that, the host oracle at every size, each
phase against a direct per-axis DFT, the DEEP coset LDE, the model of the
register-pass schedule of K2-K5 (``pass_model``) at every length they take,
K4's tile (``phase_last_model``) and K5's cluster schedule
(``small_cluster_model``) at every n it takes.

Tolerance: none -- field elements, exact equality."""

import functools
import os
import re

import jax
import numpy as np
import pytest
import torch

from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.ops import goldilocks_jax as FJ
from sezkp_tpu.ops import ntt as N
from sezkp_tpu.ops import ntt_jax
from sezkp_tpu.ops import ntt_mxu
from sezkp_tpu.ops import ntt_pallas
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.ops import ntt_torch as NT

P = int(G.P)


def _rand(n, seed):
    a = np.random.default_rng(seed).integers(0, P, n, dtype=np.uint64)
    a[0], a[1] = 0, P - 1
    return a


@pytest.mark.parametrize("inverse", [False, True])
def test_matches_mxu_kernels_interpret_2_14(inverse):
    a = _rand(1 << 14, 14)
    if inverse:
        want = ntt_mxu.inverse_ntt_u64(a)
        got = NT.inverse_ntt_u64(a, "cpu")
    else:
        want = ntt_mxu.forward_ntt_u64(a)
        got = NT.forward_ntt_u64(a, "cpu")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [14, 15, 18])  # two- and three-factor
@pytest.mark.parametrize("inverse", [False, True])
def test_matches_host_oracle(k, inverse):
    a = _rand(1 << k, k)
    assert NT._factor_logs(k) == ntt_mxu._factor_logs(k)
    if inverse:
        assert np.array_equal(NT.inverse_ntt_u64(a, "cpu"), N.inverse_ntt(a))
    else:
        assert np.array_equal(NT.forward_ntt_u64(a, "cpu"), N.forward_ntt(a))


def test_small_sizes_plain_on_cpu_only():
    """Below 2^MIN_LOG2 a CPU tensor goes through K5's plain version (phase A
    then phase B), and no launch is counted."""
    a = _rand(1 << 8, 8)
    before = NT.small_ntt.launches
    assert np.array_equal(NT.forward_ntt_u64(a, "cpu"), N.forward_ntt(a))
    assert np.array_equal(NT.inverse_ntt_u64(a, "cpu"), N.inverse_ntt(a))
    assert NT.small_ntt.launches == before
    assert NT.MIN_LOG2 == ntt_mxu.MIN_LOG2
    one = np.array([12345], dtype=np.uint64)
    assert np.array_equal(NT.forward_ntt_u64(one, "cpu"), one)
    assert np.array_equal(NT.inverse_ntt_u64(one, "cpu"), one)


@pytest.mark.parametrize("k", range(1, 14))
@pytest.mark.parametrize("inverse", [False, True])
def test_small_plain_vs_pallas_interpret_and_host_oracle(k, inverse):
    """small_cols_plain / small_rows_plain composed as small_ntt_plain
    composes them == K5's cluster schedule (small_cluster_model) == the
    Pallas four-step kernels (interpret mode) == the host oracle."""
    a = _rand(1 << k, 100 + k)
    l1 = min(10, k // 2)
    l2 = k - l1
    tw = NT._twiddle_matrix(l1, l2, inverse, "cpu")
    x = NT.small_cols_plain(FT.pack(a).reshape(1 << l1, 1 << l2), inverse, tw)
    y = NT.small_rows_plain(x, inverse, scale=G.inv(1 << k) if inverse else 1)
    assert tuple(y.shape) == (1 << l2, 1 << l1) and y.is_contiguous()
    got = FT.unpack(y).reshape(-1)
    assert np.array_equal(FT.unpack(NT.small_ntt_plain(FT.pack(a), inverse)), got)
    assert np.array_equal(FT.unpack(NT.small_cluster_model(FT.pack(a), inverse)), got)
    if inverse:
        assert np.array_equal(got, N.inverse_ntt(a))
        assert np.array_equal(got, ntt_pallas.inverse_ntt_u64(a))
        assert np.array_equal(NT.inverse_ntt_u64(a, "cpu"), got)
    else:
        assert np.array_equal(got, N.forward_ntt(a))
        assert np.array_equal(got, ntt_pallas.forward_ntt_u64(a))
        assert np.array_equal(NT.forward_ntt_u64(a, "cpu"), got)


@pytest.mark.parametrize("inverse", [False, True])
def test_small_phases_plain_vs_direct_dft(inverse):
    rng = np.random.default_rng(24)
    n1, n2 = 8, 32
    x = rng.integers(0, P, (n1, n2), dtype=np.uint64)
    tw = rng.integers(0, P, (n1, n2), dtype=np.uint64)
    scale = 987654321987654321 % P
    got = NT.small_cols_plain(FT.pack(x), inverse, FT.pack(tw))
    assert np.array_equal(FT.unpack(got), G.mul(_dft_rows(x.T.copy(), inverse).T, tw))
    got = NT.small_rows_plain(FT.pack(x), inverse, scale=scale)
    assert np.array_equal(FT.unpack(got), G.mul(_dft_rows(x, inverse), np.uint64(scale)).T)
    # a factor of 1 is the identity transform (n = 2 has n1 = 1)
    row = FT.pack(x[:1])
    assert np.array_equal(FT.unpack(NT.small_cols_plain(row, inverse, FT.pack(tw[:1]))), G.mul(x[:1], tw[:1]))
    # the whole transform: K5 on a CPU tensor is its plain version
    flat = x.reshape(-1)
    want = N.inverse_ntt(flat) if inverse else N.forward_ntt(flat)
    assert np.array_equal(FT.unpack(NT.small_ntt(FT.pack(flat), inverse)), want)


def _dft_rows(x, inverse):
    """Direct DFT of every row by the host oracle (n^-1 of the inverse undone)."""
    m = x.shape[-1]
    flat = x.reshape(-1, m)
    out = np.empty_like(flat)
    for i, row in enumerate(flat):
        out[i] = G.mul(N.inverse_ntt(row), np.uint64(m)) if inverse else N.forward_ntt(row)
    return out.reshape(x.shape)


@pytest.mark.parametrize("inverse", [False, True])
def test_phase_axis_plain_vs_direct_dft(inverse):
    rng = np.random.default_rng(21)
    m, other = 16, 24
    x = rng.integers(0, P, (m, other), dtype=np.uint64)
    tw = rng.integers(0, P, (m, other), dtype=np.uint64)
    twp = rng.integers(0, P, (m, 8), dtype=np.uint64)
    scale = 12345678901234567
    want = _dft_rows(x.T.copy(), inverse).T
    got = NT.phase_axis(FT.pack(x), 0, inverse)
    assert np.array_equal(FT.unpack(got), want)
    got = NT.phase_axis(FT.pack(x), 0, inverse, tw=FT.pack(tw), scale=scale)
    assert np.array_equal(FT.unpack(got), G.mul(G.mul(want, tw), np.uint64(scale)))
    got = NT.phase_axis(FT.pack(x), 0, inverse, tw=FT.pack(twp), tw_period=8)
    assert np.array_equal(FT.unpack(got), G.mul(want, np.tile(twp, (1, 3))))
    # axis 1: [other, m]
    x1 = np.ascontiguousarray(x.T)
    got = NT.phase_axis(FT.pack(x1), 1, inverse, scale=scale)
    assert np.array_equal(FT.unpack(got), G.mul(_dft_rows(x1, inverse), np.uint64(scale)))


@pytest.mark.parametrize("inverse", [False, True])
def test_phase_batched_plain_vs_direct_dft(inverse):
    rng = np.random.default_rng(22)
    m1, mc, cols = 4, 8, 6
    x = rng.integers(0, P, (m1, mc, cols), dtype=np.uint64)
    ta = rng.integers(0, P, (m1, mc), dtype=np.uint64)
    t = rng.integers(0, P, (mc, cols), dtype=np.uint64)
    pre = G.mul(x, ta[:, :, None])
    want = _dft_rows(np.ascontiguousarray(pre.transpose(0, 2, 1)), inverse).transpose(0, 2, 1)
    want = G.mul(want, t[None])
    got = NT.phase_batched(FT.pack(x), inverse, ta=FT.pack(ta), t=FT.pack(t))
    assert np.array_equal(FT.unpack(got), want)
    got = NT.phase_batched(FT.pack(x), inverse)
    want = _dft_rows(np.ascontiguousarray(x.transpose(0, 2, 1)), inverse).transpose(0, 2, 1)
    assert np.array_equal(FT.unpack(got), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_phase_last_plain_vs_direct_dft(inverse):
    rng = np.random.default_rng(23)
    m1, m2, mc = 4, 2, 8
    x = rng.integers(0, P, (m1, m2, mc), dtype=np.uint64)
    scale = G.inv(64)
    want = G.mul(_dft_rows(x, inverse), np.uint64(scale)).transpose(2, 1, 0)
    got = NT.phase_last(FT.pack(x), inverse, scale=scale)
    assert tuple(got.shape) == (mc, m2, m1)
    assert np.array_equal(FT.unpack(got), want)


def test_phase_wrappers_count_no_launch_on_cpu():
    x = FT.pack(_rand(64, 3).reshape(8, 8))
    before = (NT.phase_axis.launches, NT.phase_batched.launches, NT.phase_last.launches)
    NT.phase_axis(x, 0, False)
    NT.phase_batched(x.reshape(2, 4, 8), False)
    NT.phase_last(x.reshape(2, 4, 8), False)
    assert (NT.phase_axis.launches, NT.phase_batched.launches, NT.phase_last.launches) == before
    before = NT.small_ntt.launches
    NT.small_ntt(x.reshape(-1), False)
    NT.small_ntt(x.reshape(-1), True)
    assert NT.small_ntt.launches == before


def test_deep_coset_lde_matches_jax():
    base = _rand(1 << 11, 11)
    z = 0x1234567890ABCDEF % P
    want = ntt_jax.deep_coset_lde_u64(base, 3, 3, z)
    got = NT.deep_coset_lde_u64(base, 3, 3, z, "cpu")
    assert got.shape == (1 << 14,)
    assert np.array_equal(got, want)


def test_tables_cached_per_device():
    a = NT._small_twiddles(3, 4, True, "cpu")
    assert NT._small_twiddles(3, 4, True, torch.device("cpu")) is a
    assert NT._small_twiddles(3, 4, False, "cpu") is not a
    # the forward table is the four-step table itself; the inverse's has n^-1 in it
    assert NT._small_twiddles(3, 4, False, "cpu") is NT._twiddle_matrix(3, 4, False, "cpu")
    assert torch.equal(a, FT.mul(NT._twiddle_matrix(3, 4, True, "cpu"), FT.scalar(G.inv(1 << 7), a)))
    # K5's launch arguments at 2^13: the tables above and the pass tables of
    # both phases (two passes each), looked up once, pointers included
    tables, ptrs = NT._small_tables(13, True, torch.device("cpu"))
    assert NT._small_tables(13, True, torch.device("cpu"))[0] is tables
    assert tables[0] is NT._small_twiddles(6, 7, True, "cpu")
    assert [tuple(t.shape) for t in tables[1:]] == [(8, 8), (16, 8)]
    assert ptrs == tuple(t.data_ptr() for t in tables)
    assert NT._small_tables(3, False, torch.device("cpu"))[1][1:] == (0, 0)  # one pass a phase: no pass tables


# ------------------- the register-pass schedule of K2 and K3 -------------------


def test_pow2_root_exponents_match_roots_and_header():
    """2^POW2_ROOT_EXP[k] = w_{2^k} (k <= 6); the kernels' compile-time copy in
    csrc/ntt_reg.cuh (root_exp) holds the same numbers."""
    for k, e in enumerate(NT.POW2_ROOT_EXP):
        assert pow(2, e, P) == int(G.primitive_root_2exp(k)), k
    hdr = open(os.path.join(os.path.dirname(NT.__file__), "csrc", "ntt_reg.cuh")).read()
    body = re.search(r"constexpr int root_exp\(int k\) \{(.*?)\}", hdr, re.S).group(1)
    table = {int(k): int(e) for k, e in re.findall(r"k == (\d+) \? (\d+)", body)}
    assert table == {k: e for k, e in enumerate(NT.POW2_ROOT_EXP) if k}


@pytest.mark.parametrize("m_log2", range(1, 7))
@pytest.mark.parametrize("inverse", [False, True])
def test_pow2_exps_are_powers_of_the_root(m_log2, inverse):
    """Every _pow2_exps entry: 2^e_k = w_m^k (w_m^-k for the inverse), m <= 64."""
    m = 1 << m_log2
    w = NT._root(m_log2, inverse)
    exps = NT._pow2_exps(m_log2, inverse, "cpu").tolist()
    assert len(exps) == m and all(0 <= e < 192 for e in exps)
    assert [pow(2, e, P) for e in exps] == [pow(w, k, P) for k in range(m)]
    assert NT._pow2_exps(m_log2, inverse, torch.device("cpu")) is NT._pow2_exps(m_log2, inverse, "cpu")


def test_pow2_exps_refuse_m_above_64():
    with pytest.raises(ValueError):
        NT._pow2_exps(7, False, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_stages(m_log2):
    """ntt_jax._ntt_stages jitted once per length, the tables an argument, so
    both directions share one XLA:CPU compile."""
    return jax.jit(lambda lo, hi, tables: ntt_jax._ntt_stages((lo, hi), tables, m_log2))


@pytest.mark.parametrize("m_log2", range(1, 11))
@pytest.mark.parametrize("inverse", [False, True])
def test_pass_model_matches_plain_and_jax(m_log2, inverse):
    """The kernels' pass schedule in tensor code (split into register radices,
    exchange order, twiddle placement) == the port's radix-2 stages
    (phase_axis_plain, phase_batched_plain) == the JAX package's
    ntt_jax._ntt_stages, at every length K2 and K3 take, both directions."""
    m = 1 << m_log2
    rng = np.random.default_rng(300 + 2 * m_log2 + inverse)
    x = rng.integers(0, P, (3, m), dtype=np.uint64)
    x[0, 0], x[-1, -1], x[1, :] = 0, P - 1, P - 1
    got = NT.pass_model(FT.pack(x), m_log2, inverse)
    lo, hi = _jax_stages(m_log2)(*FJ.pack(x), ntt_jax._tables_packed(m_log2, inverse))
    assert np.array_equal(FT.unpack(got), FJ.unpack((lo, hi)))
    # the phases as the kernels order them: ta before the passes, the table
    # twiddle, then the scale, after
    xt = FT.pack(x)
    tw = FT.pack(rng.integers(0, P, (3, m), dtype=np.uint64))
    scale = G.inv(m) if inverse else 12345
    want = NT.phase_axis_plain(xt, 1, inverse, tw=tw, scale=scale)
    assert torch.equal(FT.mul(FT.mul(got, tw), FT.scalar(scale, got)), want)
    assert torch.equal(NT.pass_model(xt, m_log2, inverse).T, NT.phase_axis_plain(xt.T.contiguous(), 0, inverse))
    ta = FT.pack(rng.integers(0, P, (2, m), dtype=np.uint64))
    t = FT.pack(rng.integers(0, P, (m, 3), dtype=np.uint64))
    xb = FT.pack(rng.integers(0, P, (2, m, 3), dtype=np.uint64))
    model = FT.mul(NT.pass_model(FT.mul(xb, ta[:, :, None]).transpose(1, 2), m_log2, inverse).transpose(1, 2), t)
    assert torch.equal(model, NT.phase_batched_plain(xb, inverse, ta=ta, t=t))


@pytest.mark.parametrize("m1", [3, 37])
@pytest.mark.parametrize("m_log2", range(1, 11))
@pytest.mark.parametrize("inverse", [False, True])
def test_phase_last_model_matches_plain_and_jax(m_log2, inverse, m1):
    """K4's tile in tensor code (csrc/ntt_last.cu): staged rows, the register
    passes along the last axis, the (t, q) -> k emission map, the scale and
    the transposed store by address, with m1 below a block's V vectors (3)
    and m1 over several blocks (37 at mc = 1024) == phase_last_plain == the
    JAX package's _ntt_stages, transposed."""
    m, m2 = 1 << m_log2, 2
    rng = np.random.default_rng(500 + 4 * m_log2 + 2 * inverse + (m1 > 3))
    scale = G.inv(m) if inverse else 977
    x = rng.integers(0, P, (m1, m2, m), dtype=np.uint64)
    x[0, 0, 0], x[-1, -1, -1] = 0, P - 1
    xt = FT.pack(x)
    got = NT.phase_last_model(xt, inverse, scale)
    assert tuple(got.shape) == (m, m2, m1)
    assert torch.equal(got, NT.phase_last_plain(xt, inverse, scale))
    lo, hi = _jax_stages(m_log2)(*FJ.pack(x.reshape(m1 * m2, m)), ntt_jax._tables_packed(m_log2, inverse))
    want = G.mul(FJ.unpack((lo, hi)), np.uint64(scale)).reshape(m1, m2, m).transpose(2, 1, 0)
    assert np.array_equal(FT.unpack(got), want)


def test_emit_index_is_a_permutation():
    """Every output index k is emitted by exactly one (thread, register), with
    16 registers a vector (K2-K4) and with 8 (at most three passes: m <= 2^9)."""
    for m_log2 in range(1, 11):
        for reg_log2 in (4, 3) if m_log2 <= 9 else (4,):
            k = NT.emit_index(m_log2, reg_log2)
            assert sorted(k.reshape(-1).tolist()) == list(range(1 << m_log2))


@pytest.mark.parametrize("m_log2", [4, 7, 8, 10])
def test_pass_counts(m_log2):
    """The schedule keeps the radix-2 butterfly count (m/2 log2 m a vector),
    multiplies generally only between passes from
    m = 128 up (15 of the 16 twiddles of each thread), and every other twiddle
    is a shift."""
    m = 1 << m_log2
    for inverse in (False, True):
        c = NT.pass_counts(m_log2, inverse)
        assert c["bfly"] == m * m_log2 // 2
        assert c.get("mul", 0) == (15 * m // 16 if m_log2 >= 7 else 0)
        pow2 = sum(v for k, v in c.items() if k.startswith("pow2_"))
        assert 0 < pow2 < m * m_log2 // 2


@pytest.mark.parametrize("m_log2", range(1, 10))
@pytest.mark.parametrize("inverse", [False, True])
def test_pass_model_with_8_registers_matches_jax(m_log2, inverse):
    """The pass schedule with 8 registers a vector (ntt_reg.cuh's Plan<L, 3>:
    up to three passes of radix 8) == the JAX package's _ntt_stages, at every
    length it takes."""
    m = 1 << m_log2
    rng = np.random.default_rng(700 + 2 * m_log2 + inverse)
    x = rng.integers(0, P, (3, m), dtype=np.uint64)
    x[0, 0], x[-1, -1], x[1, :] = 0, P - 1, P - 1
    got = NT.pass_model(FT.pack(x), m_log2, inverse, reg_log2=3)
    lo, hi = _jax_stages(m_log2)(*FJ.pack(x), ntt_jax._tables_packed(m_log2, inverse))
    assert np.array_equal(FT.unpack(got), FJ.unpack((lo, hi)))


# ------------------------- K5's cluster schedule -------------------------


def test_small_constants_match_kernel_source():
    """ntt_torch's copies of K5's constants equal csrc/ntt_small.cu's, and the
    plan covers every n = 2^1 .. 2^13 with whole warps from 2^9 up."""
    src = open(os.path.join(os.path.dirname(NT.__file__), "csrc", "ntt_small.cu")).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const == {"kReg": NT.SMALL_REG_LOG2, "kClusterCap": NT.SMALL_CLUSTER_CAP,
                     "kMinThreads": NT.SMALL_MIN_THREADS}
    for k in range(1, NT.MIN_LOG2):
        p = NT.small_plan(k)
        c, n1, n2 = p["C"], 1 << p["l1"], 1 << p["l2"]
        assert c & (c - 1) == 0 and c <= min(NT.SMALL_CLUSTER_CAP, n1) and n2 % c == 0
        assert p["nt"] == max(p["na"], p["nb"]) and p["cols"] * n1 == p["rows"] * n2 == (1 << k) // c
        if k >= 8:  # whole warps, every thread busy in both phases
            assert p["na"] == p["nb"] == p["nt"] and p["nt"] % 32 == 0
    assert [NT.small_plan(k)["C"] for k in (8, 9, 10, 11, 12, 13)] == [1, 2, 4, 8, 16, 16]


@pytest.mark.parametrize("k", range(1, 14))
@pytest.mark.parametrize("inverse", [False, True])
def test_small_cluster_model_matches_oracle_and_plain(k, inverse):
    """K5's schedule in tensor code (CTA column slices, the register passes of
    each phase, the four-step twiddle with n^-1 folded in, the row gathered
    from the CTAs' shared memory, the natural-order store by address) ==
    small_ntt_plain == the JAX host oracle, with the cluster the launch picks
    and with every other cluster size that divides the transform (up to 16)."""
    a = _rand(1 << k, 900 + 2 * k + inverse)
    want = N.inverse_ntt(a) if inverse else N.forward_ntt(a)
    t = FT.pack(a)
    assert np.array_equal(FT.unpack(NT.small_ntt_plain(t, inverse)), want)
    n1 = 1 << NT.small_plan(k)["l1"]
    for c in [1 << i for i in range(5) if 1 << i <= n1]:
        assert np.array_equal(FT.unpack(NT.small_cluster_model(t, inverse, c)), want), c
    assert np.array_equal(FT.unpack(NT.small_cluster_model(t, inverse)), want)


# ------------------------- K12's batched inversion -------------------------

_EDGES = [0, 1, 2, 1 << 32, (1 << 32) - 1, 1 << 63, P - 2, P - 1]


def test_inverse_chain_matches_pow_p_minus_2():
    """K12's addition chain for x^(p-2) (63 squarings, 9 multiplies) ==
    FT.pow_p_minus_2's square-and-multiply, on random and edge values, and
    x * x^(p-2) = 1 for every nonzero x."""
    x = _rand(1000, 1200)
    x[2:2 + len(_EDGES)] = _EDGES
    t = FT.pack(x)
    got = NT.inverse_chain(t)
    assert torch.equal(got, FT.pow_p_minus_2(t))
    nz = x != 0
    assert np.all(G.mul(x[nz], FT.unpack(got)[nz]) == 1) and np.all(FT.unpack(got)[~nz] == 0)


def test_divide_constants_match_kernel_source():
    """ntt_torch's copies of K12's constants equal csrc/deep_divide.cu's."""
    src = open(os.path.join(os.path.dirname(NT.__file__), "csrc", "deep_divide.cu")).read()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert const == {"kPoints": NT.DIVIDE_POINTS, "kThreads": NT.DIVIDE_THREADS}


def _divide_oracle(y, z, xs):
    """numpy: y / (xs - z) by G.inv_array over the nonzero denominators, 0 elsewhere."""
    d = G.sub(xs, np.uint64(z))
    nz = d != 0
    out = np.zeros_like(y)
    out[nz] = G.mul(y[nz], G.inv_array(d[nz]))
    return out


_BLOCK = NT.DIVIDE_POINTS * NT.DIVIDE_THREADS


@pytest.mark.parametrize("grouping", [(NT.DIVIDE_POINTS, NT.DIVIDE_THREADS), (5, 3)])
@pytest.mark.parametrize("z_on", ["none", "one", "several"])
@pytest.mark.parametrize("n", [1, 7, _BLOCK - 1, _BLOCK + 1, (1 << 13) + 5])
def test_deep_divide_model_matches_plain_and_oracle(n, z_on, grouping):
    """K12's schedule in tensor code (per-thread strided batches, prefix
    products, the addition chain, the zero mask, the tail past n), with the
    kernel's grouping and with 5 points a thread and 3 threads a block, ==
    deep_divide_plain == the numpy oracle, with 0, 1, 2^32 and p - 1 among
    the values and z equal to no, one or several of the xs (0 there, the
    neighbours right)."""
    rng = np.random.default_rng(1300 + n + 7 * len(z_on))
    xs = rng.integers(0, P, n, dtype=np.uint64)
    y = rng.integers(0, P, n, dtype=np.uint64)
    for a in (xs, y):
        a[: min(n, 4)] = [0, 1, 1 << 32, P - 1][: min(n, 4)]
    if z_on == "none":
        z = int(rng.integers(0, P, dtype=np.uint64))
        while z in set(xs.tolist()):
            z += 1
    else:
        z = int(xs[n // 2])
        if z_on == "several":
            xs[[0, n // 3, n - 1]] = z
    want = _divide_oracle(y, z, xs)
    assert (want == 0).sum() >= {"none": 0, "one": 1, "several": min(n, 3)}[z_on]
    plain = NT.deep_divide(FT.pack(y), z, FT.pack(xs))
    assert np.array_equal(FT.unpack(plain), want)
    k, threads = grouping
    model = NT.deep_divide_model(FT.pack(y), z, FT.pack(xs), k, threads)
    assert torch.equal(model, plain)


def test_deep_divide_counts_no_launch_on_cpu():
    """On a CPU tensor the wrapper runs the plain version and counts no launch;
    z is taken mod p."""
    y, xs = FT.pack(_rand(64, 1400)), FT.pack(_rand(64, 1401))
    before = NT.deep_divide.launches
    got = NT.deep_divide(y, P + 5, xs)
    assert NT.deep_divide.launches == before
    assert torch.equal(got, NT.deep_divide_plain(y, 5, xs))

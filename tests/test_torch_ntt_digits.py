"""The port's digit form of the NTT phases (plain versions of K9-K11, on the
CPU) vs the JAX package: `_digits`, `_dot_digits` and `_recombine` called as
ordinary jnp functions, `_dft_call` and the probe script's
`_last_call_t_folded` in interpret mode, the host table builders, and the
folded transform against the port's own NTT and the host oracle.

Tolerance: none -- integers and field elements, exact equality."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.ops import goldilocks_jax as FJ
from sezkp_tpu.ops import ntt as N
from sezkp_tpu.ops import ntt_mxu as NM
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.ops import ntt_digits_torch as ND
from sezkp_tpu_torch.ops import ntt_torch as NT

P = int(G.P)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EDGES = (0, 1, ND.MAX_BAL, ND.MAX_BAL + 1, P - 1)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; with a full set of
    OpenMP threads in each, the float64 products of the plain versions slow
    down by orders of magnitude. Two threads keep them quick in any company."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    a = np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)
    flat = a.reshape(-1)
    flat[: len(EDGES)] = EDGES
    return a


def _fold_script():
    """scripts/ntt_twiddle_fold_ab.py as a module (it reads AB_K at import)."""
    os.environ.setdefault("AB_K", "20")
    spec = importlib.util.spec_from_file_location(
        "ntt_twiddle_fold_ab", os.path.join(ROOT, "scripts", "ntt_twiddle_fold_ab.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_planes(a):
    lo, hi = FJ.pack(a)
    return jnp.asarray(lo), jnp.asarray(hi)


def _field(planes):
    return FJ.unpack((np.asarray(planes[0]), np.asarray(planes[1])))


def test_constants_and_factor_logs():
    assert (ND.NDIG, ND.DIAGS, ND.MAX_BAL, ND.OFF) == (NM.NDIG, NM.DIAGS, NM.MAX_BAL, NM.OFF)
    for k in range(14, 31):
        assert ND._factor_logs(k) == NM._factor_logs(k)


def test_digits_equal_jax_and_host():
    a = _rand((64, 96), 1)
    got = ND.digits_plain(FT.pack(a)).numpy()
    want = np.stack([np.asarray(d) for d in NM._digits(*_jax_planes(a))])
    host = np.stack(NM._balanced_digits_host(a))
    own = np.stack(ND.balanced_digits_host(a))
    assert got.dtype == np.int8 and got.shape == (8, 64, 96)
    assert np.array_equal(got, want)
    assert np.array_equal(got, host)
    assert np.array_equal(got, own)
    # the digits are the signed representative
    val = sum(got[k].astype(object) * (256 ** k) for k in range(8))
    rep = np.where(a > np.uint64(ND.MAX_BAL), a.astype(object) - P, a.astype(object))
    assert np.array_equal(val, rep)


@pytest.mark.parametrize("tile", [8, 32, 96])
def test_stack_layouts(tile):
    """The tiled stack is the probe's: per `tile` columns the 8 planes side by
    side (jnp.concatenate(digs, axis=1) per block); the k-major stack is the
    planes transposed. gl_digits on a CPU tensor gives both."""
    a = _rand((16, 96), 2)
    x = FT.pack(a)
    digs = NM._digits(*_jax_planes(a))
    want = np.concatenate(
        [np.concatenate([np.asarray(d)[:, c : c + tile] for d in digs], axis=1)
         for c in range(0, 96, tile)], axis=1)
    got = ND.gl_digits(x, tile=tile)
    assert got.shape == (16, 8 * 96) and np.array_equal(got.numpy(), want)
    planes = ND.digits_plain(x)
    km = ND.gl_digits(x)
    assert km.shape == (8, 96, 16) and torch.equal(km, planes.transpose(1, 2))
    assert ND.gl_digits.launches == 0


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("mode", ["w_x", "x_w"])
def test_dot_digits_equal_jax(m, mode):
    m_log2 = m.bit_length() - 1
    span = 24
    a = _rand((m, span) if mode == "w_x" else (span, m), 3 + m)
    wj = NM._w_digits(m_log2, False)
    w = ND.w_digits(m_log2, False)
    assert np.array_equal(w.numpy(), np.asarray(wj))
    digs_j = NM._digits(*_jax_planes(a))
    want = NM._dot_digits(digs_j, wj, m, mode)
    got = ND.dot_digits_plain(list(ND.digits_plain(FT.pack(a))), w, m, mode)
    assert len(got) == ND.DIAGS
    for g, wnt in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(wnt).astype(np.int64))


def test_recombine_equal_jax_at_the_bound():
    rng = np.random.default_rng(5)
    s = rng.integers(-(1 << 27), (1 << 27) + 1, (ND.DIAGS, 16, 40), dtype=np.int64)
    s[:, 0, 0] = 1 << 27
    s[:, 0, 1] = -(1 << 27)
    s[:, 0, 2] = 0
    s[::2, 0, 3] = 1 << 27
    s[1::2, 0, 3] = -(1 << 27)
    want = _field(NM._recombine([jnp.asarray(x.astype(np.int32)) for x in s]))
    got = FT.unpack(ND.recombine_plain([torch.from_numpy(x) for x in s]))
    assert np.array_equal(got, want)
    # and it is the value it says it is
    ref = [sum(int(s[d, i, j]) << (8 * d) for d in range(ND.DIAGS)) % P
           for i in range(2) for j in range(40)]
    assert [int(v) for v in got[:2].reshape(-1)] == ref


def test_recombine_of_real_products():
    m = 64
    a = _rand((m, 48), 6)
    w = ND.w_digits(6, True, 12345)
    wj = NM._w_digits(6, True, 12345)
    diags_j = NM._dot_digits(NM._digits(*_jax_planes(a)), wj, m, "w_x")
    want = _field(NM._recombine(diags_j))
    diags = ND.dot_digits_plain(list(ND.digits_plain(FT.pack(a))), w, m, "w_x")
    assert np.array_equal(FT.unpack(ND.recombine_plain(diags)), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_digit_dft_equals_phase_axis_and_pallas_interpret(inverse):
    m_log2, other = 6, 128
    m = 1 << m_log2
    a = _rand((m, other), 7)
    x = FT.pack(a)
    w = ND.w_digits(m_log2, inverse)
    from_elements = ND.digit_dft(x, w, "recombine", elements=True)
    from_stack = ND.digit_dft(ND.gl_digits(x), w, "recombine")
    butterflies = NT.phase_axis_plain(x, 0, inverse)
    assert torch.equal(from_elements, butterflies)
    assert torch.equal(from_stack, butterflies)
    lo, hi = _jax_planes(a)
    pallas = NM._dft_call(m_log2, other, 0, NM._w_digits(m_log2, inverse))(lo, hi)
    assert np.array_equal(FT.unpack(from_elements), _field(pallas))
    assert ND.digit_dft.launches == 0


def test_digit_dft_sum_epilogue():
    """The probe's `k_dots`: the 15 diagonals added up and stored as u32."""
    m = 64
    rng = np.random.default_rng(8)
    stack = torch.from_numpy(rng.integers(-128, 128, (8, 40, m), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-128, 128, (8 * m, m), dtype=np.int8))
    got = ND.digit_dft(stack, w, "sum")
    digs = [jnp.asarray(stack[i].numpy().T) for i in range(8)]
    diags = NM._dot_digits(digs, jnp.asarray(w.numpy()), m, "w_x")
    acc = diags[0]
    for d in diags[1:]:
        acc = acc + d
    want = np.asarray(acc.astype(jnp.uint32))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("inverse,scale", [(False, 1), (True, 977)])
def test_folded_table_equals_script(inverse, scale):
    fold = _fold_script()
    l2, l3 = 2, 5
    want = fold._w3_folded_host(l2, l3, inverse, scale)  # [m2, NDIG*m3 (digit, b3), m3 (k3)]
    got = ND.folded_table(l2, l3, inverse, scale)  # [k2, k3, digit, b3]
    m2, m3 = 1 << l2, 1 << l3
    assert got.shape == (m2, m3, 8, m3) and got.dtype == torch.int8
    assert np.array_equal(got.permute(0, 2, 3, 1).numpy(), want.reshape(m2, 8, m3, m3))
    assert np.array_equal(ND.w_digits_host(l3, inverse, scale), np.asarray(NM._w_digits(l3, inverse, scale)))


def test_digit_dft_last_equals_pallas_interpret():
    fold = _fold_script()
    l2, l3, cols = 2, 7, 8
    m2, mc = 1 << l2, 1 << l3
    a = _rand((cols, m2 * mc), 9)
    lo, hi = _jax_planes(a)
    wf_ref = fold._w3_folded_host(l2, l3, False, 1)
    olo, ohi = fold._last_call_t_folded(m2, l3, cols)(lo, hi, jnp.asarray(wf_ref))
    got = ND.digit_dft_last(FT.pack(a), ND.folded_table(l2, l3, False, 1))
    assert got.shape == (mc, m2 * cols)
    assert np.array_equal(FT.unpack(got), _field((olo, ohi)))
    # the same phase on the port's butterfly kernels' plain versions: middle
    # twiddle, then the last phase with its transposed store
    x3 = FT.pack(a).reshape(cols, m2, mc)
    tw = FT.mul(x3, NT._t_mid(l2, l3, False, "cpu")[None])
    assert torch.equal(got.reshape(mc, m2, cols), NT.phase_last_plain(tw, False))
    assert ND.digit_dft_last.launches == 0


def test_forward_ntt_folded_equals_port_ntt_and_host_oracle():
    n_log2 = 20  # the smallest three-factor size whose last factor is 128
    assert ND._factor_logs(n_log2) == [6, 7, 7]
    a = _rand(1 << n_log2, 10)
    x = FT.pack(a)
    folded = ND.forward_ntt_folded(x)
    assert torch.equal(folded, NT.forward_ntt(x))
    assert np.array_equal(FT.unpack(folded), N.forward_ntt(a))


def test_wrappers_refuse():
    x = torch.zeros((64, 64), dtype=torch.int64)
    w = ND.w_digits(6, False)
    with pytest.raises(ValueError):
        ND.gl_digits(x.to(torch.int32))
    with pytest.raises(ValueError):
        ND.gl_digits(x, tile=48)
    with pytest.raises(ValueError):
        ND.digit_dft(x, w[:64], elements=True)
    with pytest.raises(ValueError):
        ND.digit_dft(x, w, "mean", elements=True)
    with pytest.raises(ValueError):
        ND.digit_dft(x.T, w, elements=True)
    with pytest.raises(ValueError):
        ND.digit_dft_last(x, torch.zeros((2, 32, 8, 16), dtype=torch.int8))
    with pytest.raises(ValueError):
        ND.forward_ntt_folded(torch.zeros(1 << 14, dtype=torch.int64))

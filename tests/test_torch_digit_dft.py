"""K10 `digit_dft`'s schedule in tensor code (`digit_dft_model`: K11's body
with one table, the stage layouts of the elements and of the digit stack,
the digit cache in fragment order, the two warpgroups'
diagonals, both epilogues, the stores clipped at `other`) against the JAX
package's `_dft_call` in interpret mode, its `_dot_digits` diagonals and the
plain version, in every (source, epilogue) combination.

Tolerance: none -- integers and field elements, exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.ops import goldilocks_jax as FJ
from sezkp_tpu.ops import ntt_mxu as NM
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.ops import ntt_digits_torch as ND

P = int(G.P)
# MAX_BAL + 1 has the digit -128 in planes 4-7, p - 0x80808080 (the signed
# representative -0x80808080) in planes 0-3
EDGES = (0, 1, ND.MAX_BAL, ND.MAX_BAL + 1, P - 1, P - 0x80808080)
COMBOS = [(False, "recombine"), (False, "sum"), (True, "recombine"), (True, "sum")]


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the machine: two OpenMP threads each keep
    the float64 products quick in any company."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _field(shape, seed):
    """Random canonical elements [m, other] with EDGES down the start of every column."""
    a = np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)
    a[: len(EDGES)] = np.array(EDGES, dtype=np.uint64)[:, None]
    return a


def _src(a, elements):
    x = FT.pack(a)
    return x if elements else ND.stack_kmajor(ND.digits_plain(x))


def test_edge_inputs_put_minus_128_in_every_digit_plane_of_the_stack():
    stack = _src(_field((32, 16), 1), False)
    assert all(bool((stack[i] == -128).any()) for i in range(ND.NDIG))


@pytest.mark.parametrize("inverse,scale", [(False, 1), (True, 977)])
@pytest.mark.parametrize("m_log2,other", [(5, 48), (6, 16)])
def test_model_equals_pallas_interpret(m_log2, other, inverse, scale):
    m = 1 << m_log2
    a = _field((m, other), m_log2 + other + inverse)
    lo, hi = FJ.pack(a)
    pallas = NM._dft_call(m_log2, other, 0, NM._w_digits(m_log2, inverse, scale))(jnp.asarray(lo), jnp.asarray(hi))
    want = FJ.unpack((np.asarray(pallas[0]), np.asarray(pallas[1])))
    w = ND.w_digits(m_log2, inverse, scale)
    for elements in (True, False):
        got = ND.digit_dft_model(_src(a, elements), w, "recombine", elements)
        assert got.shape == (m, other) and got.dtype == torch.int64
        assert np.array_equal(FT.unpack(got), want)


@pytest.mark.parametrize("elements", [False, True])
@pytest.mark.parametrize("m", [32, 64])
def test_model_sum_equals_jax_dot_digits(m, elements):
    """The probe's `k_dots`: the 15 diagonals added up and stored as u32."""
    rng = np.random.default_rng(m + elements)
    w = torch.from_numpy(rng.integers(-128, 128, (ND.NDIG * m, m), dtype=np.int8))
    if elements:
        a = _field((m, 40), m)
        lo, hi = FJ.pack(a)
        digs = NM._digits(jnp.asarray(lo), jnp.asarray(hi))
        src = FT.pack(a)
    else:
        src = torch.from_numpy(rng.integers(-128, 128, (ND.NDIG, 40, m), dtype=np.int8))
        digs = [jnp.asarray(src[i].numpy().T) for i in range(ND.NDIG)]
    diags = NM._dot_digits(digs, jnp.asarray(w.numpy()), m, "w_x")
    acc = diags[0]
    for d in diags[1:]:
        acc = acc + d
    got = ND.digit_dft_model(src, w, "sum", elements)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(acc.astype(jnp.uint32)))


@pytest.mark.parametrize("elements,epilogue", COMBOS)
@pytest.mark.parametrize("m_log2,other,grid", [
    (5, 16, 1),   # one k32 step, one W stage of one step, 48 of a tile's 64 columns outside the tensor
    (6, 16, 2),   # two steps a W stage
    (10, 16, 2),  # four chunks of 256 b: the cache rebuilt for every N-tile and chunk
    (5, 48, 3),   # 48 columns: a 64-column tile cut at the tensor's edge
    (7, 144, 2),  # three tiles over two blocks, the last cut at 16 columns
])
def test_model_equals_plain(m_log2, other, grid, elements, epilogue):
    m = 1 << m_log2
    src = _src(_field((m, other), m + other), elements)
    w = ND.w_digits(m_log2, bool(other % 32), 977 if other % 32 else 1)
    got = ND.digit_dft_model(src, w, epilogue, elements, grid=grid)
    assert torch.equal(got, ND.digit_dft_plain(src, w, epilogue, elements))
    assert torch.equal(ND.digit_dft(src, w, epilogue, elements), got)  # the wrapper on the CPU: the plain version
    assert ND.digit_dft.launches == 0


@pytest.mark.parametrize("epilogue", ["recombine", "sum"])
@pytest.mark.parametrize("m", [64, 1024])
def test_model_at_the_diagonal_bound(m, epilogue):
    """A random stack and a random table, with every plane of the stack's
    first 16 columns and of the table's first 16 rows all -128: those
    outputs' diagonal sums reach their bound, 8 m 2^14 (2^27 at m = 1024)."""
    rng = np.random.default_rng(m)
    stack = torch.from_numpy(rng.integers(-128, 128, (ND.NDIG, 32, m), dtype=np.int8))
    stack[:, :16] = -128
    w = torch.from_numpy(rng.integers(-128, 128, (ND.NDIG, m, m), dtype=np.int8))
    w[:, :16] = -128
    w = w.reshape(ND.NDIG * m, m)
    diags = ND.dot_digits_plain(list(stack.transpose(1, 2)), w, m, "w_x")
    assert int(diags[ND.NDIG - 1][0, 0]) == 8 * m << 14
    got = ND.digit_dft_model(stack, w, epilogue)
    assert torch.equal(got, ND.digit_dft_plain(stack, w, epilogue))


def test_model_rejects_an_unknown_epilogue():
    with pytest.raises(ValueError):
        ND.digit_dft_model(torch.zeros((32, 16), dtype=torch.int64), ND.w_digits(5, False), "int32", True)

"""K9 gl_digits' k-major tile schedule on the CPU (ntt_digits_torch.
gl_digits_model: the loads of each block's items, the digits, the 4 x 4 byte
transpose, the xor-swizzled shared-memory words and the 16-byte stores by
address) against the plain version (digits_plain + stack_kmajor) and the JAX
package's digits (ntt_mxu._digits, which the Pallas kernel k_dig of
scripts/exp_ntt_breakdown.py runs), at the edges of its tiles.

Tolerance: none -- int8 digits, exact equality."""

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
EDGES = (0, 1, ND.MAX_BAL, ND.MAX_BAL + 1, P - 0x80808080, P - 1)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test workers share the machine: two torch threads keep each quick."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(shape, seed):
    a = np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)
    a.reshape(-1)[: len(EDGES)] = EDGES
    return a


def _jax_kmajor(a):
    """The JAX package's 8 digit planes of a [m, other], stacked k-major [8, other, m]."""
    lo, hi = FJ.pack(a)
    digs = NM._digits(jnp.asarray(lo), jnp.asarray(hi))
    return np.stack([np.asarray(d).T for d in digs])


@pytest.mark.parametrize("other", [32, 96])
@pytest.mark.parametrize("m", [32, 288, 1024])
def test_model_equals_plain_and_reference(m, other):
    a = _rand((m, other), m + other)
    x = FT.pack(a)
    got = ND.gl_digits_model(x)
    assert got.dtype == torch.int8 and got.shape == (ND.NDIG, other, m)
    assert torch.equal(got, ND.stack_kmajor(ND.digits_plain(x)))
    assert torch.equal(got, ND.gl_digits(x))
    assert np.array_equal(got.numpy(), _jax_kmajor(a))


@pytest.mark.parametrize("m, rows", [(32, 32), (64, 64), (96, 32), (128, 128), (256, 256), (288, 32), (1024, 256)])
def test_tile_rows(m, rows):
    """256 rows a tile, else the largest of 128, 64, 32 that divides m, as
    sezkp_gl_digits dispatches."""
    assert ND.k9_rows(m) == rows
    x = FT.pack(_rand((m, 32), m))
    assert torch.equal(ND.gl_digits_model(x), ND.stack_kmajor(ND.digits_plain(x)))


def test_all_max_bal_plus_one():
    """MAX_BAL + 1, the least element whose representative is negative, has
    the digit -128 in planes 4-7."""
    a = np.full((64, 32), ND.MAX_BAL + 1, dtype=np.uint64)
    x = FT.pack(a)
    got = ND.gl_digits_model(x)
    assert torch.equal(got, ND.stack_kmajor(ND.digits_plain(x)))
    assert np.array_equal(got.numpy(), _jax_kmajor(a))
    assert bool((got[4:] == -128).all())


@pytest.mark.parametrize("m, other", [(48, 32), (32, 48)])
def test_model_refuses_shapes_the_kernel_refuses(m, other):
    with pytest.raises(ValueError):
        ND.gl_digits_model(torch.zeros((m, other), dtype=torch.int64))

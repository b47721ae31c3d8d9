"""K11 `digit_dft_last`'s schedule in tensor code (`digit_dft_last_model`: the
kernel's tiles, X stages as TMA swizzles them, the digit cache in fragment
order, the products by diagonal, the recombination on the folded signed
sums, the stores by address) against the probe script's Pallas kernel
`_last_call_t_folded` in interpret mode and against the plain version.

Tolerance: none -- field elements, exact equality."""

import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.ops import goldilocks_jax as FJ
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.ops import ntt_digits_torch as ND

P = int(G.P)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# MAX_BAL + 1 has the digit -128 in planes 4-7, p - 0x80808080 (the signed
# representative -0x80808080) in planes 0-3
EDGES = (0, 1, ND.MAX_BAL, ND.MAX_BAL + 1, P - 1, P - 0x80808080)


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """Several test workers share the machine: two OpenMP threads each keep
    the float64 products quick in any company."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _field(shape, seed):
    """Random canonical elements with EDGES at the start of every row."""
    a = np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)
    a[:, : len(EDGES)] = EDGES
    return a


def _table(m2, mc, seed):
    """Random int8 folded tables [m2, mc, NDIG, mc]; in slice 0 every plane of
    the first 16 rows k3 is all -128, so that with X's digit -128 the
    diagonal sums reach their bound."""
    wf = np.random.default_rng(seed).integers(-128, 128, (m2, mc, ND.NDIG, mc), dtype=np.int8)
    wf[0, :16] = -128
    return torch.from_numpy(wf)


def _fold_script():
    """scripts/ntt_twiddle_fold_ab.py as a module (it reads AB_K at import)."""
    os.environ.setdefault("AB_K", "20")
    spec = importlib.util.spec_from_file_location(
        "ntt_twiddle_fold_ab", os.path.join(ROOT, "scripts", "ntt_twiddle_fold_ab.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_edge_inputs_put_minus_128_in_every_digit_plane():
    planes = ND.digits_plain(FT.pack(np.array(EDGES, dtype=np.uint64)))
    assert all(bool((planes[i] == -128).any()) for i in range(ND.NDIG))


def test_kernel_digit_trick_equals_plain_digits():
    a = FT.pack(_field((64, 64), 1))
    d = ND.k11_balanced_digits(a)
    got = torch.stack([((d >> (8 * i)) & 255).to(torch.uint8).view(torch.int8) for i in range(ND.NDIG)])
    assert torch.equal(got, ND.digits_plain(a))


def test_fragment_map_is_the_whole_tile_once():
    row, k = ND.k11_fragment_map()
    flat = (row * 32 + k).reshape(-1)
    assert torch.equal(flat.sort().values, torch.arange(64 * 32))


@pytest.mark.parametrize("inverse,scale", [(False, 1), (True, 977)])
@pytest.mark.parametrize("l2,l3,cols", [(2, 5, 16), (1, 7, 64)])
def test_model_equals_pallas_interpret_and_plain(l2, l3, cols, inverse, scale):
    fold = _fold_script()
    m2, mc = 1 << l2, 1 << l3
    a = _field((cols, m2 * mc), l2 + l3 + cols)
    lo, hi = FJ.pack(a)
    wf_ref = fold._w3_folded_host(l2, l3, inverse, scale)
    olo, ohi = fold._last_call_t_folded(m2, l3, cols)(jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(wf_ref))
    want = FJ.unpack((np.asarray(olo), np.asarray(ohi)))
    x, wf = FT.pack(a), ND.folded_table(l2, l3, inverse, scale)
    got = ND.digit_dft_last_model(x, wf)
    assert got.shape == (mc, m2 * cols)
    assert np.array_equal(FT.unpack(got), want)
    assert torch.equal(got, ND.digit_dft_last_plain(x, wf))


@pytest.mark.parametrize("m2,mc,cols,grid", [
    (3, 64, 32, 2),    # three slices, two blocks
    (1, 128, 64, 1),   # one slice, one tile
    (2, 32, 48, 3),    # 48 rows: the second k1 tile of nothing, the first cut at the tensor's edge
    (1, 32, 16, 1),    # the smallest: one k32 step, one W stage of one step
    (1, 1024, 16, 2),  # four chunks of 256 b3: the cache rebuilt for every N-pair and chunk
])
def test_model_equals_plain_on_random_tables(m2, mc, cols, grid):
    x = FT.pack(_field((cols, m2 * mc), mc + cols))
    x[:, 8:mc] = FT._i64(ND.MAX_BAL + 1)  # digit -128 in planes 4-7 across slice 0
    wf = _table(m2, mc, m2 + mc)
    got = ND.digit_dft_last_model(x, wf, grid=grid)
    assert torch.equal(got, ND.digit_dft_last_plain(x, wf))
    assert torch.equal(ND.digit_dft_last(x, wf), got)  # the wrapper on the CPU: the plain version
    assert ND.digit_dft_last.launches == 0


def test_model_constants_equal_kernel_source():
    with open(os.path.join(ROOT, "sezkp_tpu_torch", "ops", "csrc", "digit_wgmma.cuh")) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    t = ND.K11_TILE
    assert (const("kRows"), const("kN"), const("kConsumers"), const("kChunk"), const("kXB"), const("kWB")) == (
        t["rows"], t["n"], t["wgs"], t["chunk"], t["xb"], t["wb"])

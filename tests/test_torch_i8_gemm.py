"""K8 `i8_gemm` (plain version, on the CPU) vs the dot products of
scripts/exp_mxu_peak.py, written here as that script writes them (its kernels
are closures inside main() and cannot be imported): `jax.lax.dot_general`
with `preferred_element_type=int32`, nrep products summed or one stacked
product whose row blocks are summed, and the `& 127` int8 store.

Tolerance: none -- integers, including sums that wrap int32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sezkp_tpu_torch.ops import ntt_digits_torch as ND

DIMS = (((1,), (0,)), ((), ()))


@pytest.fixture(autouse=True)
def _two_torch_threads():
    """The suite runs in several worker processes at once; with a full set of
    OpenMP threads in each, the float64 products of the plain versions slow
    down by orders of magnitude. Two threads keep them quick in any company."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _dots(w, x, m, nrep, fuse):
    """exp_mxu_peak.py:52-69, without the refs."""
    if fuse:
        p = jax.lax.dot_general(w, x, DIMS, preferred_element_type=jnp.int32)
        acc = p[:m, :]
        for j in range(1, nrep):
            acc = acc + p[j * m : (j + 1) * m, :]
        return acc
    acc = None
    for j in range(nrep):
        p = jax.lax.dot_general(w[j * m : (j + 1) * m, :], x, DIMS, preferred_element_type=jnp.int32)
        acc = p if acc is None else acc + p
    return acc


def _rand(shape, seed):
    return np.random.default_rng(seed).integers(-128, 128, shape, dtype=np.int8)


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("m,nrep,cols", [(8, 1, 24), (16, 9, 40), (64, 8, 96)])
def test_stacked_products_equal_script(m, nrep, cols, fuse):
    w, x = _rand((nrep * m, m), m + nrep), _rand((m, cols), m)
    want = np.asarray(_dots(jnp.asarray(w), jnp.asarray(x), m, nrep, fuse))
    got = ND.i8_gemm(torch.from_numpy(w), torch.from_numpy(x), nrep, "int32", fuse)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, ND.i8_gemm_plain(torch.from_numpy(w), torch.from_numpy(x), nrep))
    assert ND.i8_gemm.launches == 0


@pytest.mark.parametrize("mm,tile", [(32, 16), (128, 64)])
def test_single_product_both_epilogues_equal_script(mm, tile):
    w, x = _rand((mm, mm), mm), _rand((mm, tile), tile)
    p = jax.lax.dot_general(jnp.asarray(w), jnp.asarray(x), DIMS, preferred_element_type=jnp.int32)
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    assert np.array_equal(ND.i8_gemm(wt, xt).numpy(), np.asarray(p))
    i8 = ND.i8_gemm(wt, xt, 1, "and127")
    assert i8.dtype == torch.int8
    assert np.array_equal(i8.numpy(), np.asarray((p & 127).astype(jnp.int8)))


@pytest.mark.parametrize("fuse", [False, True])
def test_sums_wrap_int32_as_the_script_does(fuse):
    """All operands -128: every product is 2^14, 1024 of them a row block,
    128 blocks: the sum reaches 2^31 and wraps; one more block and it is past."""
    k, m, nrep = 1024, 8, 160
    w = np.full((nrep * m, k), -128, dtype=np.int8)
    x = np.full((k, 4), -128, dtype=np.int8)
    x[:, 1] = 127
    x[::3, 2] = 5
    want = np.asarray(_dots(jnp.asarray(w), jnp.asarray(x), m, nrep, fuse))
    got = ND.i8_gemm(torch.from_numpy(w), torch.from_numpy(x), nrep, "int32", fuse).numpy()
    assert np.array_equal(got, want)
    exact = nrep * k * (1 << 14)
    assert exact >= 1 << 31 and int(got[0, 0]) == ((exact + (1 << 31)) % (1 << 32)) - (1 << 31)
    and127 = ND.i8_gemm(torch.from_numpy(w), torch.from_numpy(x), nrep, "and127", fuse).numpy()
    assert np.array_equal(and127, np.asarray((jnp.asarray(want) & 127).astype(jnp.int8)))


def test_refusals():
    w = torch.zeros((64, 64), dtype=torch.int8)
    x = torch.zeros((64, 64), dtype=torch.int8)
    with pytest.raises(ValueError):
        ND.i8_gemm(w.to(torch.int32), x)
    with pytest.raises(ValueError):
        ND.i8_gemm(w, x.to(torch.int64))
    with pytest.raises(ValueError):
        ND.i8_gemm(w, x[:32])  # contraction lengths differ
    with pytest.raises(ValueError):
        ND.i8_gemm(w, x, nrep=3)  # 64 rows are not 3 blocks
    with pytest.raises(ValueError):
        ND.i8_gemm(w, x, epilogue="relu")
    with pytest.raises(ValueError):
        ND.i8_gemm(w.T, x)  # not contiguous


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises: without a
    card (or a built library) the call fails, it does not detour."""
    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a card")

    class FakeCuda:
        """Quacks like a contiguous int8 CUDA matrix as far as the checks look."""
        dtype = torch.int8
        is_cuda = True
        device = torch.device("cuda", 0)
        shape = (64, 64)

        def dim(self):
            return 2

        def is_contiguous(self):
            return True

    called = []
    monkeypatch.setattr(ND, "i8_gemm_plain", lambda *a, **k: called.append(1))
    with pytest.raises(Exception):
        ND.i8_gemm(FakeCuda(), FakeCuda())
    assert not called


# ----------------- K8's tile schedule (csrc/i8_gemm.cu) in tensor code -----------------


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("M,K,N,nrep", [(8, 8, 24, 1), (16, 16, 40, 9), (64, 64, 96, 8), (192, 320, 576, 2),
                                        (64, 128, 192, 3)])
def test_tile_model_equals_plain_and_script(M, K, N, nrep, fuse):
    """The swapped product, the persistent walk over 256 x 128 tiles, the (j,
    k chunk) order of `fuse`, zero-filled boxes past the edges (M, K, N that
    are no multiple of the tile: the last M tile reads the next block's rows),
    the permutation of n and the clipped store == i8_gemm_plain == the
    script's products, both epilogues."""
    w, x = _rand((nrep * M, K), M + K + nrep), _rand((K, N), N)
    want = np.asarray(_dots(jnp.asarray(w), jnp.asarray(x), M, nrep, fuse))
    wt, xt = torch.from_numpy(w), torch.from_numpy(x)
    got = ND.i8_gemm_model(wt, xt, nrep, "int32", fuse)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(got, ND.i8_gemm_plain(wt, xt, nrep))
    i8 = ND.i8_gemm_model(wt, xt, nrep, "and127", fuse)
    assert i8.dtype == torch.int8 and np.array_equal(i8.numpy(), np.asarray((jnp.asarray(want) & 127).astype(jnp.int8)))
    assert torch.equal(i8, ND.i8_gemm_plain(wt, xt, nrep, "and127"))


@pytest.mark.parametrize("fuse", [False, True])
def test_tile_model_sums_wrap_int32(fuse):
    """The wrap case of test_sums_wrap_int32_as_the_script_does through the
    tile schedule: 1280 k chunks of 128 summed in one tile."""
    k, m, nrep = 1024, 8, 160
    w = np.full((nrep * m, k), -128, dtype=np.int8)
    x = np.full((k, 4), -128, dtype=np.int8)
    x[:, 1] = 127
    x[::3, 2] = 5
    want = np.asarray(_dots(jnp.asarray(w), jnp.asarray(x), m, nrep, fuse))
    got = ND.i8_gemm_model(torch.from_numpy(w), torch.from_numpy(x), nrep, "int32", fuse)
    exact = nrep * k * (1 << 14)
    assert np.array_equal(got.numpy(), want)
    assert int(got[0, 0]) == ((exact + (1 << 31)) % (1 << 32)) - (1 << 31)


def test_n_order_pairs_fragment_rows():
    """Row r of K8's A operand is a permutation of the tile's 128 columns, in
    which rows g and g + 8 of every 16 are neighbouring columns (2g, 2g + 1):
    one 16-bit shared-memory read serves both of a lane's fragment rows."""
    perm = ND.i8_n_order()
    assert sorted(perm.tolist()) == list(range(128))
    r = torch.arange(128).reshape(8, 16)
    assert torch.equal(perm[r[:, 8:]], perm[r[:, :8]] + 1) and bool((perm[r[:, :8]] % 2 == 0).all())

"""The port's parallel/traffic.py and the pieces of the sharded prover that
run without a world: analytic_phase_bytes and scaling_model against the JAX
package's, ppermute and the collective tally in a world of one,
_fold_layer_local at D = 1 against the JAX host fold, and the sharded
prover's tables against the JAX ``_tables``. In process; tolerance: none
(field values and byte counts compared exactly, the model's floats too)."""

import numpy as np
import pytest
import torch

P = 0xFFFFFFFF00000001
GRID = [(base, 3, d) for base in (12, 20, 23) for d in (1, 2, 4, 8)]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _one_rank():
    from sezkp_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(device="cpu")


@pytest.mark.parametrize("base_log2,blow_log2,d", GRID)
def test_analytic_phase_bytes_equal_jax(base_log2, blow_log2, d):
    from sezkp_tpu.parallel import traffic as jax_traffic
    from sezkp_tpu_torch.parallel import traffic

    for tau in (2, 8):
        assert traffic.analytic_phase_bytes(base_log2, blow_log2, d, tau) == \
            jax_traffic.analytic_phase_bytes(base_log2, blow_log2, d, tau)


@pytest.mark.parametrize("base_log2,blow_log2,d", GRID)
def test_scaling_model_equals_jax(base_log2, blow_log2, d):
    from sezkp_tpu.parallel import traffic as jax_traffic
    from sezkp_tpu_torch.parallel import traffic

    for seconds, host in ((1.5, 0.0), (0.25, 0.125)):
        assert traffic.scaling_model(base_log2, blow_log2, d, seconds, host_seconds=host) == \
            jax_traffic.scaling_model(base_log2, blow_log2, d, seconds, host_seconds=host)


def test_ppermute_and_tally_in_a_world_of_one():
    """jax.lax.ppermute at one device: the pair (0, 0) is the identity, no
    pair gives zeros; a world of one runs no collective, so nothing is
    tallied; a rank in two pairs is refused."""
    from sezkp_tpu_torch.parallel.mesh import all_gather_tiled, all_to_all_tiled, ppermute
    from sezkp_tpu_torch.parallel.traffic import collective_bytes

    mesh = _one_rank()
    x = torch.arange(12, dtype=torch.int64).reshape(3, 4)
    assert torch.equal(ppermute(x, mesh, [(0, 0)]), x)
    assert torch.equal(ppermute(x, mesh, []), torch.zeros_like(x))
    assert torch.equal(all_to_all_tiled(x, mesh, 0, 1), x)
    assert torch.equal(all_gather_tiled(x, mesh, 0), x)
    assert collective_bytes(mesh) == {}
    with pytest.raises(ValueError, match="two pairs"):
        ppermute(x, mesh, [(0, 0), (0, 1)])


def test_tally_scopes():
    """Records are kept by scope and kind; collective_bytes sums a scope or
    all of them."""
    from sezkp_tpu_torch.parallel.traffic import collective_bytes

    mesh = _one_rank()
    with mesh.tally.scoped("phase1"):
        mesh.tally.add("all-to-all", 64, 48)
        mesh.tally.add("all-to-all", 64, 48)
        with mesh.tally.scoped("open"):
            mesh.tally.add("all-gather", 128, 96)
        mesh.tally.add("collective-permute", 16, 0)
    assert mesh.tally.scope == ""
    assert collective_bytes(mesh, "phase1") == {
        "all-to-all": {"count": 2, "bytes": 128, "link_bytes": 96},
        "collective-permute": {"count": 1, "bytes": 16, "link_bytes": 0}}
    assert collective_bytes(mesh, "open") == {"all-gather": {"count": 1, "bytes": 128, "link_bytes": 96}}
    assert sum(v["link_bytes"] for v in collective_bytes(mesh).values()) == 192
    mesh.tally.clear()
    assert collective_bytes(mesh) == {}


@pytest.mark.parametrize("log2", [1, 5, 12])
def test_fold_layer_local_at_one_rank_equals_jax_fold(log2):
    from sezkp_tpu.stark.v1 import fri as jax_fri
    from sezkp_tpu_torch.ops import goldilocks_torch as FT
    from sezkp_tpu_torch.parallel.prove_sharded import _fold_layer_local

    rng = np.random.default_rng(log2)
    vals = rng.integers(0, P, 1 << log2, dtype=np.uint64)
    beta = int(rng.integers(0, P, dtype=np.uint64))
    got = FT.unpack(_fold_layer_local(FT.pack(vals, "cpu"), beta, _one_rank()))
    assert np.array_equal(got, jax_fri.fold(vals, beta))


def _u64(pair) -> np.ndarray:
    lo, hi = (np.asarray(x).astype(np.uint64) for x in pair)
    return lo | (hi << np.uint64(32))


@pytest.mark.parametrize("d", [1, 2, 4])
def test_tables_equal_jax_tables(d):
    """The sharded prover's tables of rank r: the sqrt-size and n/D-size
    entries of the JAX _tables as they are, and the step-2 twiddles that the
    local phases fuse (ntt_torch._step2_twiddle, from two tables of about
    sqrt(n) powers) equal to rank r's slice of JAX's replicated n-entry INTT
    and ln-entry LDE tables."""
    from sezkp_tpu.parallel.prove_sharded import _tables as jax_tables
    from sezkp_tpu_torch.ops import goldilocks_torch as FT
    from sezkp_tpu_torch.ops import ntt_torch as NT
    from sezkp_tpu_torch.parallel.prove_sharded import _tables

    base_log2, blow_log2, shift = 12, 3, 3
    want = jax_tables(base_log2, blow_log2, d, shift)
    got = _tables(base_log2, blow_log2, d, shift, "cpu")
    for k in ("b1", "b2", "l1", "l2"):
        assert got[k] == want[k]
    for k in ("s1", "s2", "x1", "x2", "xs_loc", "xs_dev"):
        assert np.array_equal(FT.unpack(got[k]), _u64(want[k])), k
    for n_log2, a_log2, b_log2, name, inverse in (
        (base_log2, got["b1"], got["b2"], "w_inv", True),
        (base_log2 + blow_log2, got["l1"], got["l2"], "w_fwd", False),
    ):
        w = _u64(want[name])
        cols = (1 << b_log2) // d
        for r in range(d):
            k1 = np.arange(1 << a_log2, dtype=np.uint64)[:, None]
            j2 = np.arange(r * cols, (r + 1) * cols, dtype=np.uint64)[None, :]
            sl = w[(k1 * j2) & np.uint64((1 << n_log2) - 1)]
            tw = NT._step2_twiddle(n_log2, torch.arange(1 << a_log2), r * cols, cols, inverse)
            assert np.array_equal(FT.unpack(tw), sl), (name, r)

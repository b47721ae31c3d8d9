"""Port DeviceFri (on the CPU) vs the JAX package's host FRI: roots, final
value, betas and query openings, byte for byte (tolerance: none)."""

import numpy as np
import pytest

from sezkp_tpu.crypto.transcript import Blake3Transcript
from sezkp_tpu.ops import goldilocks as G
from sezkp_tpu.stark.v1 import params
from sezkp_tpu.stark.v1.fri import fri_commit, fri_open_query, fri_verify, layer_tree
from sezkp_tpu_torch.ops import goldilocks_torch as FT
from sezkp_tpu_torch.stark.v1.fri_device import MIN_DEVICE_LAYER_LOG2, DeviceFri


@pytest.fixture(scope="module")
def lde_vals():
    rng = np.random.default_rng(0)
    return rng.integers(0, int(G.P), 1 << 7, dtype=np.uint64)


def _run(eng, lde_vals, label, seed, n_rows):
    tr_host = Blake3Transcript(label)
    roots_h, layers_h, betas_h = fri_commit(tr_host, lde_vals)
    trees_h = [layer_tree(l) for l in layers_h]

    tr_dev = Blake3Transcript(label)
    root0 = eng.commit_layer0()
    tr_dev.absorb(params.DS_FRI_LAYER_ROOT, root0)
    betas_d = params.derive_betas_for_fri(tr_dev, lde_vals.shape[0].bit_length() - 1)
    rest = eng.commit_rest(betas_d)
    for r in rest:
        tr_dev.absorb(params.DS_FRI_LAYER_ROOT, r)

    assert betas_d == betas_h
    assert [root0] + rest == roots_h
    assert eng.final_value_le() == G.to_le_bytes(layers_h[-1][0]).tobytes()
    assert tr_dev.challenge_bytes("x", 16) == tr_host.challenge_bytes("x", 16)

    rng = np.random.default_rng(seed)
    rows = [int(r) for r in rng.integers(0, lde_vals.shape[0], n_rows)]
    got = eng.open_queries(rows)
    want = [fri_open_query(layers_h, trees_h, r) for r in rows]
    for a, b in zip(got, want):
        assert a.positions == b.positions
        assert a.pairs == b.pairs
    fri_verify(Blake3Transcript(label), roots_h, got, eng.final_value_le())


def test_device_fri_matches_host(lde_vals):
    assert MIN_DEVICE_LAYER_LOG2 == 11
    _run(DeviceFri(FT.pack(lde_vals)), lde_vals, "fri-test", 1, 8)


def test_device_fri_bounded_layers_match_host(lde_vals):
    """The mixed device/host-tail path with several device layers."""
    eng = DeviceFri(FT.pack(lde_vals), min_device_layer_log2=3)
    _run(eng, lde_vals, "fri-test2", 2, 6)
    assert eng._dev_layers == 4  # 7 - 3


def test_device_fri_five_device_layers(lde_vals):
    eng = DeviceFri(FT.pack(lde_vals), min_device_layer_log2=5)
    _run(eng, lde_vals, "fri-test3", 3, 4)


def test_device_fri_larger_domain():
    rng = np.random.default_rng(9)
    vals = rng.integers(0, int(G.P), 1 << 13, dtype=np.uint64)
    _run(DeviceFri(FT.pack(vals)), vals, "fri-test4", 4, 5)

"""The seeded generator: same seed, same inputs; another seed, others."""

import numpy as np
import pytest

import inputs
from sezkp_tpu_torch.core import types as program_types


def _pool(seed, pool=2):
    return inputs.make_pool(seed, 1 << 10, 64, 2, pool, program_types)


def _key(p):
    ml = p.ref_blocks[0].movement_log
    return p.root, np.concatenate([b.movement_log.tape_mv.ravel() for b in p.ref_blocks]).tobytes(), ml


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**63 + 11, -3])
def test_same_seed_same_inputs(seed):
    a, b = _pool(seed), _pool(seed)
    assert [x.root for x in a] == [x.root for x in b]
    for x, y in zip(a, b):
        assert _key(x)[:2] == _key(y)[:2]


def test_other_seed_other_inputs_and_the_pool_is_distinct():
    a, b = _pool(2**31 + 5), _pool(2**31 + 6)
    assert {x.root for x in a}.isdisjoint({x.root for x in b})
    assert a[0].root != a[1].root
    assert _pool(3)[0].root != _pool(-3)[0].root


def test_distribution_and_shapes():
    (p,) = inputs.make_pool(11, 1 << 14, 512, 8, 1, program_types)
    ml = [b.movement_log for b in p.ref_blocks]
    tape = np.concatenate([m.tape_mv for m in ml])
    wf = np.concatenate([m.write_flag for m in ml])
    ws = np.concatenate([m.write_sym for m in ml])
    assert len(p.ref_blocks) == 32 and tape.shape == (1 << 14, 8) and p.steps == 1 << 14
    assert set(np.unique(tape)) == {-1, 0, 1}
    assert abs(wf.mean() - 0.4) < 0.01
    assert ws[wf].min() == 0 and ws[wf].max() == 14 and not ws[~wf].any()
    assert set(np.unique(np.concatenate([m.input_mv for m in ml]))) == {-1, 0, 1}


def test_program_blocks_share_the_arrays():
    (p,) = _pool(5, pool=1)
    for r, b in zip(p.ref_blocks, p.blocks):
        assert type(b).__module__.startswith("sezkp_tpu_torch")
        assert b.movement_log.tape_mv is r.movement_log.tape_mv
        assert b.block_id == r.block_id and np.array_equal(b.windows, r.windows)
        assert not b.movement_log.tape_mv.flags.writeable

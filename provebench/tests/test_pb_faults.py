"""A whole run on the CPU at a size a test can hold, the look for a card
skipped: clean, it comes out correct; with the timed path broken
underneath, or with the control in the program's place, it does not.

Faults (the ones a prover can have): a prove that returns its state
unchanged (the last proof again), half of the blocks left out, one byte of
an answer altered where it is produced. One chip: no exchange to leave out.
"""

import time

import pytest
import torch

import harness

SMALL = {"stark-v1.t20": 1 << 13}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def small(monkeypatch, bench):
    """The cells' own files, at a trace length a CPU test holds, two traces."""
    load = harness.load_cell

    def load_small(benchmark, name):
        cell = load(benchmark, name)
        cell.traffic = dict(cell.traffic, steps=SMALL[name], pool=2)
        return cell

    monkeypatch.setattr(harness, "load_cell", load_small)
    return bench


def stale(prove, pool):
    last = []

    def f(blocks, root, timings=None, i=None):
        if last:
            return last[0]
        last.append(prove(blocks, root, timings, i=i))
        return last[0]

    return f


def half(prove, pool):
    def f(blocks, root, timings=None, i=None):
        return prove(blocks[: len(blocks) // 2], root, timings, i=i)

    return f


def flip(prove, pool):
    def f(blocks, root, timings=None, i=None):
        out = bytearray(prove(blocks, root, timings, i=i))
        out[len(out) // 2] ^= 1
        return bytes(out)

    return f


def _run(bench, cell, **kw):
    quiet = lambda *a, **k: None
    return harness.run_cell(bench, cell, 2**31 + 99, 0.001, False, "cpu", time.perf_counter(),
                            log=quiet, **kw)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_clean_run_is_correct(small, cell):
    r = _run(small, cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] == r["failed"] + 1 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", [stale, half, flip], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_fault_is_not_correct(small, cell, fault):
    # two proves in the window, one of each trace, so that a stale answer shows
    r = _run(small, cell, wrap_program=fault, min_proves=2)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_control_is_not_correct(small, cell):
    r = _run(small, cell, use_control=True)
    assert not r["correct"]
    assert r["checks"]["mismatched_proofs"]["value"] > 0

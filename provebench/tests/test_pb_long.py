"""The long-trace configuration (stark-v1-long) on the CPU: its bounded
reference (plain/stark_v1_bounded.py) equals the whole-tree reference and
the program's prove with the memory-bounded route forced, byte for byte;
a whole run of its cell at a size a test holds is correct clean, and not
correct under a fault or with the control in the program's place."""

import time

import pytest
import torch

import harness
import inputs
from plain import stark_v1, stark_v1_bounded
from sezkp_tpu_torch.core import types as program_types
from test_pb_faults import flip, half, stale

CELL = "stark-v1-long.t24"
# the program's memory-bounded branches at any size: roots-only commitments,
# the column matrix released, slab composition, chunked FRI
FORCED = dict(cv_budget_bytes=0, release_planes_bytes=0, fri_chunked_min_log2=12,
              compose_scan_min_log2=0)


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("t, b, tau", [(1 << 13, 512, 8), (1 << 12, 1000, 2), (1 << 14, 512, 8)])
def test_bounded_reference_equals_the_whole_one_and_the_programs(t, b, tau):
    from sezkp_tpu_torch.stark.backends import StarkV1
    from sezkp_tpu_torch.utils import tracing

    (p,) = inputs.make_pool(2**41 + t, t, b, tau, 1, program_types)
    want = stark_v1.prove(p.ref_blocks, p.root, "cpu")
    # segments of 2^10 rows and FRI chunks of 2^9 leaves: several a column
    # and a layer
    assert stark_v1_bounded.prove(p.ref_blocks, p.root, "cpu", seg_log2=10,
                                  fri_chunk_log2=9) == want
    if t < 1 << 13:  # below the program's device-resident route
        return
    rec = tracing.Recorder()
    timings = {}
    with tracing.proving(timings, rec):
        got = StarkV1.prove(p.blocks, p.root, device="cpu", timings=timings, **FORCED).proof_bytes
    assert got == want
    spans = rec.spans()
    names = {s.name for s in spans}
    assert "fri_commit_chunked" in timings
    assert {"commit.scan", "air_openings.recompute", "air_openings.derive_ranges",
            "fri_openings.rehash"} <= names
    counts = tracing.counters(spans)
    assert counts["planes.released_bytes"] == 8 * (3 + 7 * tau) * t
    assert counts["compose.slabs"] > 1 and counts["openings.rebuilt_chunks"] > 0


def test_the_default_segments_equal_the_whole_reference_and_29_queries_do_not():
    (p,) = inputs.make_pool(2**41 + 5, 1 << 13, 512, 8, 1, program_types)
    want = stark_v1.prove(p.ref_blocks, p.root, "cpu")
    assert stark_v1_bounded.prove(p.ref_blocks, p.root, "cpu") == want
    assert stark_v1_bounded.prove(p.ref_blocks, p.root, "cpu", queries=29) != want


@pytest.fixture
def small(monkeypatch, bench):
    """The cell's own files at 2^13 steps, the bounded branches forced."""
    load = harness.load_cell

    def load_small(benchmark, name):
        cell = load(benchmark, name)
        cell.traffic = dict(cell.traffic, steps=1 << 13)
        cell.config = dict(cell.config, prove_options=FORCED)
        return cell

    monkeypatch.setattr(harness, "load_cell", load_small)
    return bench


def _run(bench, **kw):
    quiet = lambda *a, **k: None
    return harness.run_cell(bench, CELL, 2**31 + 77, 0.001, False, "cpu", time.perf_counter(),
                            log=quiet, **kw)


def test_clean_run_is_correct(small):
    r = _run(small)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0
    assert all(c["value"] == 0 and c["limit"] == 0 for c in r["checks"].values())


@pytest.mark.parametrize("fault", [stale, half, flip], ids=lambda f: f.__name__)
def test_a_fault_is_not_correct(small, fault):
    # two proves in the window, one of each trace, so that a stale answer shows
    r = _run(small, wrap_program=fault, min_proves=2)
    assert not r["correct"], r["checks"]


def test_the_control_is_not_correct(small):
    r = _run(small, use_control=True)
    assert not r["correct"]
    assert r["checks"]["mismatched_proofs"]["value"] > 0

"""The span recorder (sezkp_tpu_torch/utils/tracing.py): nesting, parents,
prove ids and kinds, its bounded ring, the no-op when nothing is recorded,
a recorded CPU prove, and the benchmark's three readers of the spans."""

import importlib.util
import os
import sys
import time

import pytest

from sezkp_tpu_torch.commit.merkle import commit_blocks
from sezkp_tpu_torch.stark.backends import StarkV1
from sezkp_tpu_torch.stark.v1.prover import prove_v1
from sezkp_tpu_torch.trace.generator import generate_trace
from sezkp_tpu_torch.trace.partition import partition_trace
from sezkp_tpu_torch.utils import tracing
from sezkp_tpu_torch.utils.tracing import HOST, LAUNCH, WAIT, Recorder, Span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "provebench")

STAGES = ["device_columns", "commit", "device_compose", "lde", "fri_commit", "air_openings",
          "fri_openings"]


def test_nesting_parents_prove_ids_and_kinds():
    rec = Recorder()
    for _ in range(2):
        with tracing.proving({}, rec):
            with tracing.span("outer", WAIT):
                with tracing.span("inner", LAUNCH):
                    pass
                with tracing.span("next"):
                    pass
    spans = rec.spans()
    assert [s.name for s in spans] == ["inner", "next", "outer", "prove"] * 2
    for p in (0, 1):
        inner, nxt, outer, prove = spans[4 * p : 4 * p + 4]
        assert {s.prove for s in (inner, nxt, outer, prove)} == {p}
        assert prove.parent == -1 and outer.parent == prove.seq
        assert inner.parent == nxt.parent == outer.seq
        assert (inner.kind, nxt.kind, outer.kind, prove.kind) == (LAUNCH, HOST, WAIT, HOST)
        assert prove.begin <= outer.begin <= inner.begin <= inner.end <= nxt.begin
        assert nxt.end <= outer.end <= prove.end
    assert len({s.seq for s in spans}) == 8 and rec.dropped == 0


def test_a_prove_inside_a_prove_is_one_prove():
    rec = Recorder()
    with tracing.proving({}, rec):
        with tracing.proving({}, rec):
            with tracing.span("x"):
                pass
    assert [(s.name, s.prove) for s in rec.spans()] == [("x", 0), ("prove", 0)]


def test_the_ring_counts_what_it_drops():
    rec = Recorder(capacity=3)
    for _ in range(3):
        with tracing.proving({}, rec):
            with tracing.span("a"):
                pass
    # six spans through a ring of three: prove 0's two and prove 1's "a" are gone
    assert rec.dropped == 3 and rec.dropped_prove == 1
    assert [(s.name, s.prove) for s in rec.spans()] == [("prove", 1), ("a", 2), ("prove", 2)]
    assert rec.proves(-1e9, 1e9) is None  # prove 1 began in that window
    begin2 = next(s.begin for s in rec.spans() if s.prove == 2 and s.parent < 0)
    assert [(s.name, s.prove) for s in rec.proves(begin2, 1e9)] == [("a", 2), ("prove", 2)]


def test_stages_are_spans_under_the_prove_and_keep_their_timings():
    rec = Recorder()
    out = {}
    with tracing.proving(out, rec):
        stages = tracing.Stages(out, None)
        with tracing.span("one.part"):
            pass
        stages.mark("one")
        stages.mark("two", HOST)
        stages.mark("one")
    by_name = {}
    for s in rec.spans():
        by_name.setdefault(s.name, []).append(s)
    prove = by_name["prove"][0]
    (part,) = by_name["one.part"]
    first, again = by_name["one"]
    assert part.parent == first.seq and first.parent == by_name["two"][0].parent == prove.seq
    assert (first.kind, by_name["two"][0].kind) == (WAIT, HOST)
    assert list(out) == ["one", "two"]
    assert out["one"] == pytest.approx((first.end - first.begin) + (again.end - again.begin))


def test_nothing_recorded_and_no_clock_read_when_off(monkeypatch):
    calls = []
    clock = time.perf_counter
    monkeypatch.setattr(time, "perf_counter", lambda: calls.append(1) or clock())
    before = len(tracing.RECORDER.spans())
    noop = tracing.span("a")
    for _ in range(100):
        with tracing.span("b", LAUNCH, sync=True) as s:
            assert s is None
        assert tracing.span("c") is noop
    stages = tracing.Stages(None, None)
    stages.mark("stage")
    assert calls == []
    assert len(tracing.RECORDER.spans()) == before


def test_cover_gives_the_innermost_span():
    spans = [
        Span("prove", HOST, 0.0, 10.0, -1, 0, 0),
        Span("s", WAIT, 0.0, 6.0, 0, 0, 1),
        Span("s.a", HOST, 1.0, 2.0, 1, 0, 2),
        Span("s.b", LAUNCH, 2.0, 4.0, 1, 0, 3),
    ]
    gaps = [(-1.0, 0.5), (1.5, 3.0), (5.0, 7.0), (9.5, 11.0)]
    by_name = tracing.cover(spans, gaps, key=lambda s: s.name)
    assert by_name == pytest.approx({"s": 1.5, "s.a": 0.5, "s.b": 1.0, "prove": 1.5})
    assert tracing.cover(spans, gaps) == pytest.approx({WAIT: 1.5, HOST: 2.0, LAUNCH: 1.0})


@pytest.fixture(scope="module")
def traced():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        blocks = partition_trace(generate_trace(1 << 13, 2), 256)
        root = commit_blocks(blocks).root
        plain = StarkV1.prove(blocks, root, device="cpu")
        rec = Recorder()
        timings = {}
        with tracing.proving(timings, rec):
            art = StarkV1.prove(blocks, root, device="cpu", timings=timings)
        return plain, art, timings, rec.spans()
    finally:
        torch.set_num_threads(n)


def test_traced_prove_gives_the_same_bytes_and_the_old_keys_and_encode(traced):
    plain, art, timings, _ = traced
    assert art.proof_bytes == plain.proof_bytes
    assert list(timings) == STAGES + ["encode"]


def test_traced_prove_sub_spans_lie_inside_their_stage(traced):
    _, _, timings, spans = traced
    by_seq = {s.seq: s for s in spans}
    (prove,) = [s for s in spans if s.parent < 0]
    stages = [s for s in spans if s.parent == prove.seq]
    assert [s.name for s in stages] == STAGES + ["encode"]
    for s in stages:
        assert s.end - s.begin == pytest.approx(timings[s.name])
        assert prove.begin <= s.begin <= s.end <= prove.end
    for a, b in zip(stages, stages[1:]):
        assert a.end <= b.begin
    parts = [s for s in spans if s.parent >= 0 and s.parent != prove.seq]
    assert len(parts) >= 25 and {s.prove for s in spans} == {prove.prove}
    for s in parts:
        stage = by_seq[s.parent]
        assert s.name.split(".")[0] == stage.name and s.kind in (HOST, LAUNCH, WAIT)
        assert stage.begin <= s.begin <= s.end <= stage.end
    for stage in stages:
        kids = sorted((s for s in parts if s.parent == stage.seq), key=lambda s: s.begin)
        for a, b in zip(kids, kids[1:]):
            assert a.end <= b.begin
    assert {s.name for s in parts} >= {
        "device_columns.host_inputs", "device_columns.upload", "device_columns.derive",
        "commit.hash", "commit.pull_roots", "commit.outer_trees", "commit.transcript",
        "device_compose.challenges", "device_compose.args", "device_compose.rows",
        "lde.intt", "lde.tables", "lde.coset_ntt", "lde.divide",
        "fri_commit.layer0", "fri_commit.fold", "fri_commit.pull_tops", "fri_commit.transcript",
        "air_openings.requests", "air_openings.paths", "air_openings.pull",
        "air_openings.assemble",
        "fri_openings.plan", "fri_openings.gather", "fri_openings.pull", "fri_openings.assemble",
    }


def test_prove_v1_alone_is_one_recorded_prove(traced):
    plain, _, _, _ = traced
    blocks = partition_trace(generate_trace(1 << 13, 2), 256)
    before = tracing.RECORDER.spans()
    timings = {}
    proof = prove_v1(blocks, commit_blocks(blocks).root, device="cpu", timings=timings)
    new = [s for s in tracing.RECORDER.spans() if s not in before]
    tops = [s for s in new if s.parent < 0]
    assert len(tops) == 1 and {s.prove for s in new} == {tops[0].prove}
    assert list(timings) == STAGES
    assert [s.name for s in new if s.parent == tops[0].seq] == STAGES
    from sezkp_tpu_torch.stark.v1 import proof as proof_mod

    assert proof_mod.encode_proof(proof) == plain.proof_bytes


# ----------------- the benchmark's readers of the spans ----------------------


def _reader(name):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    path = os.path.join(BENCH, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(device_events):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import harness

    return harness.Run(cell=None, setup_s=0.0, window_start=0.0, window_end=10.0, proves=[],
                       peak_window_bytes=0, device_events=device_events)


def _hand_spans(rec):
    # a prove before the window, one inside it, one after it
    for prove, t0 in ((0, -20.0), (1, 0.0), (2, 10.0)):
        seq = 10 * prove
        for s in (
            Span("device_columns.host_inputs", HOST, t0 + 1, t0 + 2, seq + 1, prove, seq + 2),
            Span("device_columns.derive", LAUNCH, t0 + 2, t0 + 4, seq + 1, prove, seq + 3),
            Span("device_columns", WAIT, t0 + 1, t0 + 5, seq, prove, seq + 1),
            Span("lde.divide", LAUNCH, t0 + 6, t0 + 8, seq + 4, prove, seq + 5),
            Span("lde", WAIT, t0 + 5, t0 + 9, seq, prove, seq + 4),
            Span("prove", HOST, t0 + 1, t0 + 9, -1, prove, seq),
        ):
            rec.add(s)


# busy [1.5, 2.5], [3, 3.5], [6.5, 9.5]: idle [1, 1.5] under host_inputs,
# [2.5, 3] and [3.5, 4] under derive, [4, 5] under the stage, [5, 6] under
# `lde`, [6, 6.5] under the divide
EVENTS = [("k", 1.5, 2.5), ("k", 3.0, 3.5), ("k", 6.5, 9.5)]


@pytest.mark.parametrize("name, want", [
    ("lde_divide_s.stark", 2.0), ("idle_host_s.stark", 0.5), ("idle_launch_s.stark", 1.5),
])
def test_readers_on_a_hand_built_run(monkeypatch, name, want):
    rec = Recorder()
    _hand_spans(rec)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    read = _reader(name)
    assert read(_run(EVENTS)) == pytest.approx(want)
    assert read(_run(None)) is None  # no device trace


@pytest.mark.parametrize("name", ["lde_divide_s.stark", "idle_host_s.stark", "idle_launch_s.stark"])
def test_readers_give_none_after_a_drop(monkeypatch, name):
    rec = Recorder(capacity=8)  # 18 spans: the ring lets prove 0 and two of prove 1's go
    _hand_spans(rec)
    assert rec.dropped == 10 and rec.dropped_prove == 1
    monkeypatch.setattr(tracing, "RECORDER", rec)
    assert _reader(name)(_run(EVENTS)) is None


# ----------------------------- counters --------------------------------------


def test_counters_add_up_in_the_prove_and_close_with_it():
    rec = Recorder()
    for k in (1, 2):
        with tracing.proving({}, rec):
            tracing.count("a", 3 * k)
            with tracing.span("outer", WAIT):
                with tracing.span("inner", LAUNCH):
                    tracing.count("a", 1)
                    tracing.count("b", 7)
    spans = rec.spans()
    assert [s.name for s in spans] == ["inner", "outer", "a", "b", "prove"] * 2
    for k, p in ((1, 0), (2, 1)):
        inner, outer, a, b, prove = spans[5 * p : 5 * p + 5]
        assert (a.kind, b.kind) == (tracing.COUNT, tracing.COUNT)
        assert (a.value, b.value) == (3 * k + 1, 7)
        assert a.parent == b.parent == prove.seq and a.prove == b.prove == prove.prove == p
        assert a.begin == a.end == b.begin == b.end == prove.end
    assert len({s.seq for s in spans}) == 10
    assert tracing.counters(spans) == {"a": 4 + 7, "b": 14}
    # counter entries are of no length: the spans' cover does not see them
    assert tracing.cover(spans, [(-1e9, 1e9)], key=lambda s: s.name).keys() == {
        "inner", "outer", "prove"}


def test_a_dropped_counter_drops_its_prove():
    rec = Recorder(capacity=3)
    for _ in range(2):
        with tracing.proving({}, rec):
            tracing.count("a", 1)
            with tracing.span("x"):
                pass
    # six entries through a ring of three: prove 0's three are gone
    assert rec.dropped == 3 and rec.dropped_prove == 0
    assert tracing.counters(rec.proves(-1e9, 1e9)) == {"a": 1}
    rec = Recorder(capacity=2)
    with tracing.proving({}, rec):
        tracing.count("a", 1)
        with tracing.span("x"):
            pass
    assert rec.proves(-1e9, 1e9) is None


def test_count_is_a_noop_when_off(monkeypatch):
    calls = []
    clock = time.perf_counter
    monkeypatch.setattr(time, "perf_counter", lambda: calls.append(1) or clock())
    before = len(tracing.RECORDER.spans())
    for _ in range(100):
        assert tracing.count("a", 1) is None
        with tracing.span("b"):
            tracing.count("a", 1)
    assert calls == [] and len(tracing.RECORDER.spans()) == before


# the program's memory-bounded branches at T = 2^13: roots-only commitments,
# the column matrix released, slab composition, chunked FRI
BOUNDED = dict(cv_budget_bytes=0, release_planes_bytes=0, fri_chunked_min_log2=12,
               compose_scan_min_log2=0)
CHUNK = 1 << 10      # rows of a column chunk
FRI_CHUNK = 1 << 11  # leaves of a FRI chunk


@pytest.fixture(scope="module")
def bounded(traced):
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        blocks = partition_trace(generate_trace(1 << 13, 2), 256)
        root = commit_blocks(blocks).root
        rec = Recorder()
        timings = {}
        with tracing.proving(timings, rec):
            proof = prove_v1(blocks, root, device="cpu", timings=timings, **BOUNDED)
        quiet = prove_v1(blocks, root, device="cpu", **BOUNDED)
        return proof, quiet, timings, rec.spans()
    finally:
        torch.set_num_threads(n)


def test_bounded_prove_gives_the_same_bytes_traced_or_not(traced, bounded):
    from sezkp_tpu_torch.stark.v1 import proof as proof_mod

    plain = traced[0]
    proof, quiet, timings, _ = bounded
    assert proof_mod.encode_proof(proof) == proof_mod.encode_proof(quiet) == plain.proof_bytes
    assert list(timings) == [s if s != "fri_commit" else "fri_commit_chunked" for s in STAGES]


def test_bounded_sub_spans_lie_under_their_stages_with_their_kinds(bounded):
    _, _, _, spans = bounded
    by_seq = {s.seq: s for s in spans}

    def one(name):
        (s,) = [s for s in spans if s.name == name]
        return s, by_seq[s.parent]

    want = {
        "commit.scan": (LAUNCH, "commit.hash"),
        "commit.hash": (LAUNCH, "commit"),
        "air_openings.recompute": (WAIT, "air_openings"),
        "air_openings.derive_ranges": (LAUNCH, "air_openings.recompute"),
        "air_openings.rehash": (LAUNCH, "air_openings.recompute"),
        "fri_openings.gather": (WAIT, "fri_openings"),
        "fri_openings.rehash": (LAUNCH, "fri_openings"),
        "fri_openings.pull": (WAIT, "fri_openings"),
    }
    for name, (kind, parent) in want.items():
        s, p = one(name)
        assert (s.kind, p.name) == (kind, parent)
        assert p.begin <= s.begin <= s.end <= p.end
    gather, rehash, pull = (one(f"fri_openings.{x}")[0] for x in ("gather", "rehash", "pull"))
    assert gather.end <= rehash.begin and rehash.end <= pull.begin
    derive, again = one("air_openings.derive_ranges")[0], one("air_openings.rehash")[0]
    assert derive.end <= again.begin
    assert not any(s.name in ("air_openings.upload", "air_openings.paths") for s in spans)


def test_bounded_counters_are_what_the_shapes_give(bounded):
    from sezkp_tpu_torch.stark.v1.columns import all_labels

    proof, _, _, spans = bounded
    n, tau, lde_log2 = 1 << 13, 2, 16
    cols = len(all_labels(tau))
    # the AIR openings' distinct (column, chunk) trees: every column at the
    # queried row, the moves and heads at the next row too
    air = set()
    for q in proof.queries:
        nxt = (q.row + 1) % n
        air |= {(c, q.row // CHUNK) for c in range(cols)}
        air |= {(c, nxt // CHUNK) for c in range(3, 3 + tau)}          # mv_r
        air |= {(c, nxt // CHUNK) for c in range(3 + 3 * tau, 3 + 4 * tau)}  # head_r
    # the FRI openings' distinct (layer, chunk) trees, in the device layers
    dev_layers = lde_log2 - 11
    fri = set()
    for fq in proof.fri_queries:
        for layer in range(dev_layers + 1):
            idx, half = fq.positions[layer], 1 << (lde_log2 - layer - 1)
            fri |= {(layer, idx // FRI_CHUNK), (layer, (idx ^ half) // FRI_CHUNK)}
    assert tracing.counters(spans) == {
        "commit.scan_segments": cols * n // min(n, 1 << 21),
        "compose.slabs": n // (1 << 12),
        "planes.released_bytes": 8 * cols * n,
        "fri.chunk_tops_segments": dev_layers + 1,
        "openings.rebuilt_chunks": len(air) + len(fri),
    }


def test_the_resident_route_records_no_bounded_counter(traced):
    _, _, _, spans = traced
    assert tracing.counters(spans) == {}
    assert not {s.name for s in spans} & {"commit.scan", "air_openings.recompute",
                                         "fri_openings.rehash"}


def _bounded_spans(rec):
    # a prove before the window, one inside it, one after it
    for prove, t0 in ((0, -20.0), (1, 0.0), (2, 10.0)):
        seq = 10 * prove
        for s in (
            Span("air_openings.recompute", WAIT, t0 + 2, t0 + 3, seq + 1, prove, seq + 2),
            Span("air_openings", WAIT, t0 + 1, t0 + 4, seq, prove, seq + 1),
            Span("fri_openings.rehash", LAUNCH, t0 + 5, t0 + 5.5, seq + 3, prove, seq + 4),
            Span("fri_openings", WAIT, t0 + 4, t0 + 6, seq, prove, seq + 3),
            Span("openings.rebuilt_chunks", tracing.COUNT, t0 + 9, t0 + 9, seq, prove, seq + 5,
                 100),
            Span("commit.scan_segments", tracing.COUNT, t0 + 9, t0 + 9, seq, prove, seq + 6, 472),
            Span("compose.slabs", tracing.COUNT, t0 + 9, t0 + 9, seq, prove, seq + 7, 32),
            Span("fri.chunk_tops_segments", tracing.COUNT, t0 + 9, t0 + 9, seq, prove, seq + 8,
                 137),
            Span("prove", HOST, t0 + 1, t0 + 9, -1, prove, seq),
        ):
            rec.add(s)


@pytest.mark.parametrize("name, want", [
    ("recompute_s.stark", 1.5), ("rebuilt_chunks.stark", 100), ("scan_segments.stark", 641),
])
def test_bounded_readers_on_a_hand_built_run(monkeypatch, name, want):
    rec = Recorder()
    _bounded_spans(rec)
    monkeypatch.setattr(tracing, "RECORDER", rec)
    read = _reader(name)
    assert read(_run(EVENTS)) == pytest.approx(want)
    assert read(_run(None)) is None  # no device trace
    small = Recorder(capacity=12)  # 27 entries: prove 0 and part of prove 1 dropped
    _bounded_spans(small)
    monkeypatch.setattr(tracing, "RECORDER", small)
    assert read(_run(EVENTS)) is None
    monkeypatch.setattr(tracing, "RECORDER", Recorder())
    _hand_spans(tracing.RECORDER)  # a prove with none of the reader's spans or counters
    assert read(_run(EVENTS)) is None

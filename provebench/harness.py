"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell needs is found by name: the cell's entry in
BENCHMARK.json names its configuration (configs/<config>.json) and its
traffic (traffic/<traffic>.json); the configuration names its backend
(backends/<backend>.py: the program's prove, the reference's and the
control's); each metric is read by metrics/<metric>.py. Adding a cell, a
configuration, a traffic mix or a metric adds files and entries and edits
none.
"""

from __future__ import annotations

import gc
import hashlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

import inputs
import window

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "sezkp_tpu")


def _load_module(kind: str, name: str):
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"provebench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    backend: object
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(benchmark: dict, name: str) -> Cell:
    """The cell `name` of BENCHMARK.json with its files, and the metrics it
    reports: an end-to-end metric where it lists the cell or lists no cells;
    a per-layer metric where it lists the cell, or lists none and moves an
    end-to-end metric the cell reports."""
    entry = next((w for w in benchmark["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = _load_json("configs", entry["config"])
    traffic = _load_json("traffic", entry["traffic"])
    e2e = [m for m in benchmark["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [
        m for m in benchmark["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in names)
    ]
    return Cell(name, config, traffic, _load_module("backends", config["backend"]), e2e, layer)


@dataclass
class Run:
    """What the metric readers read."""

    cell: Cell
    setup_s: float
    window_start: float
    window_end: float
    proves: List[dict]
    peak_window_bytes: int
    device_events: Optional[list] = None
    stage_spans: List[tuple] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start


def read_metrics(run: Run, entries: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = _load_module("metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(
    benchmark: dict, name: str, seed: int, seconds: float, trace: bool, device: str,
    t_start: float, *, wrap_program: Optional[Callable] = None, use_control: bool = False,
    min_proves: int = 0, log=print,
) -> dict:
    """Set up, measure for `seconds`, check against the reference, and return
    the result line's object. `wrap_program` wraps the program's prove (the
    fault tests); `use_control` puts the control in the program's place;
    `min_proves` makes the window run at least that many proves."""
    import torch

    cell = load_cell(benchmark, name)
    cfg, trf, backend = cell.config, cell.traffic, cell.backend
    os.environ.update(cfg.get("env", {}))
    from sezkp_tpu_torch.core import types as program_types

    pool = inputs.make_pool(seed, trf["steps"], cfg["block_steps"], cfg["tapes"], trf["pool"],
                            program_types)
    if use_control:
        control = backend.control(cfg, device)
        prove = lambda blocks, root, timings=None, i=None: control(pool[i].ref_blocks, root)
    else:
        program = backend.program(cfg, device)
        prove = lambda blocks, root, timings=None, i=None: program(blocks, root, timings)
    if wrap_program is not None:
        prove = wrap_program(prove, pool)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    prove(pool[0].blocks, pool[0].root, i=0)  # warm-up: the cell's one shape
    sync()
    # the pool and the set-up's objects are the harness's, not the prover's:
    # keep the collector from scanning them again in every full collection
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    proves, outputs, failed = [], [[] for _ in pool], 0
    tracer = None
    if trace and cuda:
        from profiling import DeviceTrace

        tracer = DeviceTrace()
        tracer.__enter__()
    gc_before = [g["collections"] for g in gc.get_stats()]
    cpu0 = time.process_time()
    w0 = time.perf_counter()
    k = 0
    while k < min_proves or time.perf_counter() - w0 < seconds:
        i = k % len(pool)
        k += 1
        timings = {} if trace else None
        t0 = time.perf_counter()
        try:
            out = prove(pool[i].blocks, pool[i].root, timings, i=i)
            sync()
        except Exception as e:  # a prove that fails counts, and the window goes on
            failed += 1
            log(f"prove {k} of trace {i} failed: {e!r}", file=sys.stderr)
            continue
        t1 = time.perf_counter()
        proves.append({"index": i, "start": t0, "end": t1, "steps": pool[i].steps,
                       "timings": timings})
        outputs[i].append(out)
    w1 = proves[-1]["end"] if proves else time.perf_counter()
    cpu_s = time.process_time() - cpu0
    gcs = [g["collections"] - b for g, b in zip(gc.get_stats(), gc_before)]
    if tracer is not None:
        tracer.__exit__(None, None, None)
    peak_window = torch.cuda.max_memory_allocated() if cuda else 0

    run = Run(cell, setup_s, w0, w1, proves, peak_window)
    if tracer is not None:
        run.device_events = tracer.events
        for p in proves:
            if p["timings"]:
                run.stage_spans += window.stage_edges(
                    p["start"], [(f"{backend.STAGE_PREFIX}.{n}", s)
                                 for n, s in backend.stages(p["timings"])])
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    walls = sorted(p["end"] - p["start"] for p in proves)
    if walls:
        log(f"window: {len(walls)} proves in {run.window_s:.3f} s, walls min {walls[0]:.4f} "
            f"median {walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s; process cpu "
            f"{cpu_s:.2f} s; collections by generation {gcs}",
            file=sys.stderr)

    dev = {"platform": "gpu" if cuda else "cpu", "count": 1,
           "memory_peak_bytes": int(max(peak_setup, peak_window))}
    if cuda:
        dev["kind"] = torch.cuda.get_device_name()
    breakdown = None
    if tracer is not None and run.device_events is not None:
        dev["busy_s"] = window.busy([(b, e) for _, b, e in run.device_events], w0, w1)
        dev["window_s"] = run.window_s
        breakdown = _breakdown(run)
        log(f"profiler: {len(run.device_events)} device events, clock skew "
            f"{tracer.clock_skew_s!r} s, parsed in {tracer.parse_s:.1f} s", file=sys.stderr)
    elif tracer is not None:
        log("profiler: no device activity recorded", file=sys.stderr)

    # ---- the check, once the window has closed and the program is freed ----
    del prove, tracer
    if not use_control:
        del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = check_outputs(cell, pool, outputs, seed, device, log)
    result = {
        "correct": failed == 0 and bool(proves) and all(
            c["value"] <= c["limit"] for c in checks.values()),
        "attempted": k,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def check_outputs(cell: Cell, pool, outputs, seed: int, device: str, log) -> Dict[str, dict]:
    """Every proof of a trace must equal that trace's first proof and no
    other trace's; the proofs of `check_traces` traces drawn from the seed
    (among those proved) must equal the reference's bytes."""
    digests = [[hashlib.sha256(o).digest() for o in outs] for outs in outputs]
    firsts = {d[0]: i for i, d in enumerate(digests) if d}
    unstable = sum(sum(x != d[0] for x in d[1:]) for d in digests if d)
    crossed = sum(sum(firsts.get(x, i) != i for x in d) for i, d in enumerate(digests))
    proved = [i for i, d in enumerate(digests) if d]
    rng = np.random.default_rng(inputs.seed_sequence(seed).spawn(len(pool) + 1)[-1])
    sample = sorted(rng.choice(proved, size=min(cell.traffic["check_traces"], len(proved)),
                               replace=False).tolist()) if proved else []
    reference = cell.backend.reference(cell.config, device)
    mismatched, checked = 0, 0
    t0 = time.perf_counter()
    for i in sample:
        want = reference(pool[i].ref_blocks, pool[i].root)
        mismatched += sum(o != want for o in outputs[i])
        checked += len(outputs[i])
    log(f"reference: trace(s) {sample} of {len(pool)}, {checked} proofs compared, "
        f"{time.perf_counter() - t0:.2f} s", file=sys.stderr)
    return {
        "mismatched_proofs": {"value": mismatched, "limit": 0},
        "unstable_proofs": {"value": unstable, "limit": 0},
        "crossed_proofs": {"value": crossed, "limit": 0},
    }


def _breakdown(run: Run) -> dict:
    """The device operations that took most time, and the idle seconds by
    the prover stage the host was in, ten of each."""
    by_name: Dict[str, float] = {}
    for name, b, e in run.device_events:
        if e > run.window_start and b < run.window_end:
            key = name[:120]
            by_name[key] = by_name.get(key, 0.0) + (min(e, run.window_end) - max(b, run.window_start))
    idle = window.label_gaps(
        window.gaps([(b, e) for _, b, e in run.device_events], run.window_start, run.window_end),
        run.stage_spans)
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_name), "idle_gaps": top(idle)}

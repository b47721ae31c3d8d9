"""STARK v1 prover (column commitments + DEEP coset LDE + FRI + openings).

Transcript schedule is byte-identical to crates/sezkp-stark/src/v1/prover.rs:
  manifest_root, n, tau -> col roots -> alphas -> masks -> ood point ->
  fri layer roots (root0 then betas then folded roots) -> AIR row queries ->
  FRI queries.

Counterpart of sezkp_tpu/stark/v1/prover.py, with both of its routes to the
same proof bytes:

- the **device-resident route**, from ``device_cols_min`` rows up (2^13, the
  JAX package's threshold): only the raw movement logs go up; the columns are
  derived on the device (columns_device.DeviceColumns), hashed and committed
  there from the resident matrix, composed there (compose_device), LDE'd
  (ops/ntt_torch.deep_coset_lde) and FRI'd (fri_device.DeviceFri) there, and
  the openings gather their values there;
- the **host-columns route** below that: the trace columns, the composition
  and the ZK masks are built on the host with numpy, and the commitments,
  the LDE and FRI take the device from their own size thresholds up.

``streaming=True`` (StarkV1.prove_streaming) takes the host-columns route at
every size and commits the columns with the O(chunk)-memory
``StreamingColumnEngine`` (host hashing, chunk recomputed on open), as the
JAX package does; the composition still reads the whole host columns.

`device=None` means the CUDA card and raises when there is none; the CPU is
used only when the caller passes device="cpu". Routes and memory policy are
plain keyword arguments (below). The proof bytes depend on none of them, nor
on the device.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ...core.types import BlockSummary
from ...crypto.transcript import Blake3Transcript
from ...ops import goldilocks as G
from ...ops import goldilocks_torch as FT
from ...ops import ntt as ntt_host
from ...ops import ntt_torch
from ...ops._kernels import resolve_device
from ...utils import tracing
from ...utils.tracing import LAUNCH, span
from . import params
from .air import Alphas, compose_all_rows
from .columns import TraceColumns
from .columns_device import COMPOSE_SCAN_MIN_LOG2, DeviceColumns, compose_device
from .fri import fri_commit, fri_open_query, layer_tree
from .fri_device import FRI_CHUNKED_MIN_LOG2, DeviceFri
from .masking import (
    DEFAULT_MASK_DEG,
    DEFAULT_N_MASKS,
    derive_mask_coeffs,
    eval_masks_sum_at_points,
)
from .openings import CV_BUDGET_BYTES, DEVICE_HASH_MIN, ColumnEngine, StreamingColumnEngine
from .proof import FriQuery, PerTapeOpen, ProofV1, RowOpenings

# Rows from which the whole prove is device-resident (columns derived there).
DEVICE_COLS_MIN = 1 << 13
# On the host-columns route: base-domain size (log2) from which the DEEP LDE
# runs on the device, and LDE-domain size (log2) from which FRI does.
LDE_MIN_LOG2 = 15
FRI_MIN_LOG2 = 14
# The [C, n] column matrix (8 * C * n bytes) is dropped after the composition
# and the opened chunks are derived anew from the raw logs, from this size
# up. On the H100 (PERF.md section 7) the LDE's temporaries set the peak of
# the 2^23 and 2^24 proves with the matrix beside them: dropping it took the
# peak from 34.11 to 30.07 GB (T = 2^23, 3.96 GB matrix) and from 36.80 to
# 28.79 GB (2^24, 7.92 GB) for no wall time outside the spread between runs;
# at 2^22 (1.98 GB, kept) a release did not move the peak, which falls
# before it.
RELEASE_PLANES_BYTES = 2 << 30


def _next_wrap(idx: int, n: int) -> int:
    if n == 0:
        return 0
    return idx + 1 if idx + 1 < n else 0


def _nudge_off_coset(z: int, shift: int, lde_k_log2: int) -> int:
    p = int(G.P)
    shift_inv = G.inv(shift)
    def on_coset(zz: int) -> bool:
        t = zz * shift_inv % p
        for _ in range(lde_k_log2):
            t = t * t % p
        return t == 1
    while on_coset(z):
        z = (z + 1) % p
    return z


def _deep_lde_host(base_vals: np.ndarray, blow_log2: int, shift: int, z: int) -> np.ndarray:
    n = base_vals.shape[0]
    base_log2 = n.bit_length() - 1
    coeffs = ntt_host.interpolate_from_evals(base_vals)
    y = ntt_host.evaluate_on_coset_pow2(coeffs, base_log2 + blow_log2, shift)
    lde_n = 1 << (base_log2 + blow_log2)
    xs = G.mul(
        np.uint64(shift), ntt_host.powers(G.primitive_root_2exp(base_log2 + blow_log2), lde_n)
    )
    denom = G.sub(xs, np.uint64(z))
    return G.mul(y, G.inv_array(denom))


def _release_planes_if_large(dc: DeviceColumns, release_planes_bytes: int) -> None:
    """Drop the [C, n] device column matrix when it reaches the budget (one
    rule for the release before the LDE and the one after the openings), and
    add its bytes to the recorded prove's counter `planes.released_bytes`."""
    size = 8 * len(dc.labels) * dc.n
    if dc.planes_resident and size >= release_planes_bytes:
        dc.release_planes()
        tracing.count("planes.released_bytes", size)


@tracing.records
def prove_v1(
    blocks: Sequence[BlockSummary],
    manifest_root: bytes,
    device=None,
    *,
    streaming: bool = False,
    device_cols_min: int = DEVICE_COLS_MIN,
    cv_budget_bytes: int = CV_BUDGET_BYTES,
    release_planes_bytes: int = RELEASE_PLANES_BYTES,
    compose_scan_min_log2: int = COMPOSE_SCAN_MIN_LOG2,
    device_hash_min: int = DEVICE_HASH_MIN,
    lde_min_log2: int = LDE_MIN_LOG2,
    fri_min_log2: int = FRI_MIN_LOG2,
    fri_chunked_min_log2: int = FRI_CHUNKED_MIN_LOG2,
    timings: Optional[dict] = None,
    engine=None,
    tc=None,
) -> ProofV1:
    """Produce a v1 proof on `device` (None = the CUDA card).

    `streaming=True` selects the O(chunk)-memory column engine on the
    host-columns route, whatever `device_cols_min` says: the same proof bytes
    (reference: StarkV1::prove_streaming, lib.rs:170-191).
    Otherwise, from `device_cols_min` rows up the prove is device-resident; its memory
    policy is `cv_budget_bytes` (leaf CVs resident up to this size, else
    roots only and recomputed openings), `release_planes_bytes` (the column
    matrix is dropped between composition and openings from this size up)
    and `compose_scan_min_log2` (composition slab by slab from this size up).
    Below `device_cols_min` the columns and the composition are host numpy
    and `device_hash_min`, `lde_min_log2`, `fri_min_log2` say from which sizes
    the commitments, the LDE and FRI take the device. On either route a
    device FRI takes its chunked tops-only mode from LDE domains of
    2^`fri_chunked_min_log2` up (fri_device.DeviceFri). `timings`, when a
    dict, receives wall seconds per stage (`fri_commit_chunked` in place of
    `fri_commit` when FRI took its chunked mode), and the prove's spans are
    recorded (utils/tracing.py: a span per stage, sub-spans inside) with the
    counters of the memory-bounded route: `commit.scan_segments` (segments
    of the roots-only column commitments), `compose.slabs` (slabs of the
    composition), `fri.chunk_tops_segments` (segments of the chunked FRI's
    layer hashing), `openings.rebuilt_chunks` (distinct (column, chunk) and
    (FRI layer, chunk) trees the openings rebuilt) and
    `planes.released_bytes` (bytes of the column matrix released); a
    counter the prove's route never reaches is not recorded.

    `engine` injects a column-commitment engine (the sharded one,
    parallel/engine.py) and takes the host-columns route; `tc` optionally
    supplies the host TraceColumns alongside it. An engine with
    `deep_lde_fri` (parallel/engine.ShardedProverEngine) also computes the
    composition, the LDE and FRI (stages `sharded_phase1`,
    `sharded_fri_commit`, `sharded_open`); the host composition and the LDE
    are then skipped."""
    device = resolve_device(device)
    n = sum(b.n_steps for b in blocks)
    tau = blocks[0].tau if blocks else 0
    assert n & (n - 1) == 0 and n > 0, "trace length must be a power of two"
    stages = tracing.Stages(timings, device)

    dc = None
    if engine is None and n >= device_cols_min and not streaming:
        dc = DeviceColumns(blocks, device)
        with span("device_columns.derive", LAUNCH):
            dc.planes  # derive now, so the stage below is charged for it
        stages.mark("device_columns")
    else:
        if tc is None:
            tc = TraceColumns.build(blocks)
        stages.mark("host_columns")

    tr = Blake3Transcript(params.DS_V1_DOMAIN)
    tr.absorb("manifest_root", manifest_root)
    tr.absorb_u64("n", n)
    tr.absorb_u64("tau", tau)

    # ---- column commitments (batched; streaming = chunked recompute) ----
    if engine is None and streaming:
        engine = StreamingColumnEngine(blocks, params.COL_CHUNK_LOG2)
    elif engine is None:
        engine = ColumnEngine(
            tc, params.COL_CHUNK_LOG2, device=device, device_hash_min=device_hash_min,
            dc=dc, cv_budget_bytes=cv_budget_bytes,
        )
    col_roots = engine.build_roots()
    with span("commit.transcript"):
        tr.absorb_u64(params.DS_N_COLS, len(col_roots))
        for cr in col_roots:
            tr.absorb(params.DS_COL_ROOT, cr.root)
    stages.mark("commit")

    # ---- alphas / masks / OOD point ----
    with span("device_compose.challenges" if dc is not None else "compose.challenges"):
        alphas = Alphas.from_list(params.derive_alphas(tr))
        mask_coeffs = derive_mask_coeffs(tr, DEFAULT_MASK_DEG, DEFAULT_N_MASKS)

        blow_log2 = params.BLOWUP.bit_length() - 1
        base_log2 = n.bit_length() - 1
        lde_k_log2 = base_log2 + blow_log2
        lde_n = 1 << lde_k_log2

        shift = 3
        z = params.derive_ood_point(tr)
        z = _nudge_off_coset(z, shift, lde_k_log2)

    # ---- base composition + ZK masks, then the DEEP coset LDE ----
    fri_eng = None
    lde_vals = None
    sharded = hasattr(engine, "deep_lde_fri")
    if sharded:
        # the sharded hot path: composition, LDE and FRI across the ranks of
        # the engine's world (parallel/prove_sharded.py)
        fri_eng = engine.deep_lde_fri(alphas, mask_coeffs, blow_log2, shift, z)
        stages.mark("sharded_phase1")
    elif dc is not None:
        base_dev = compose_device(dc, alphas, mask_coeffs, compose_scan_min_log2)
        _release_planes_if_large(dc, release_planes_bytes)
        stages.mark("device_compose")
        fri_eng = DeviceFri(ntt_torch.deep_coset_lde(base_dev, blow_log2, shift, z),
                            chunked_min_log2=fri_chunked_min_log2)
        del base_dev
    else:
        comp = compose_all_rows(tc, alphas)
        w_base_pows = ntt_host.powers(G.primitive_root_2exp(base_log2), n)
        base_vals = G.add(comp, eval_masks_sum_at_points(mask_coeffs, w_base_pows))
        stages.mark("host_compose")
        if base_log2 >= lde_min_log2:
            # one upload of the base evaluations; the LDE stays on the device
            lde_dev = ntt_torch.deep_coset_lde(FT.pack(base_vals, device), blow_log2, shift, z)
            fri_eng = DeviceFri(lde_dev, chunked_min_log2=fri_chunked_min_log2)
        else:
            lde_vals = _deep_lde_host(base_vals, blow_log2, shift, z)
            if lde_k_log2 >= fri_min_log2:
                fri_eng = DeviceFri(FT.pack(lde_vals, device),
                                    chunked_min_log2=fri_chunked_min_log2)
    if not sharded:
        stages.mark("lde")

    # ---- FRI commit: bind root0, betas, fold + bind roots ----
    if fri_eng is not None:
        root0 = fri_eng.commit_layer0()
        with span("fri_commit.transcript"):
            tr.absorb(params.DS_FRI_LAYER_ROOT, root0)
            betas = params.derive_betas_for_fri(tr, lde_k_log2)
        rest = fri_eng.commit_rest(betas)
        with span("fri_commit.transcript"):
            for r in rest:
                tr.absorb(params.DS_FRI_LAYER_ROOT, r)
        roots = [root0] + rest
        fri_final_value_le = fri_eng.final_value_le()
    else:
        roots, layers, betas = fri_commit(tr, lde_vals)
        trees = [layer_tree(layer) for layer in layers]
        fri_final_value_le = G.to_le_bytes(layers[-1][0]).tobytes()
    if sharded:
        stages.mark("sharded_fri_commit")
    else:
        stages.mark("fri_commit_chunked" if fri_eng is not None and fri_eng.chunked else "fri_commit")

    # ---- AIR query openings (batched: one device pass for all paths) --
    with span("air_openings.requests"):
        rows = params.derive_queries(tr, n, params.NUM_QUERIES)
        requests = []
        for row in rows:
            ip1 = _next_wrap(row, n)
            for r in range(tau):
                requests += [
                    (f"mv_{r}", row), (f"mv_{r}", ip1),
                    (f"wflag_{r}", row), (f"wsym_{r}", row),
                    (f"head_{r}", row), (f"head_{r}", ip1),
                    (f"winlen_{r}", row), (f"in_off_{r}", row), (f"out_off_{r}", row),
                ]
            requests += [("is_first", row), ("is_last", row), ("input_mv", row)]
    opened = iter(engine.open_batch(requests))

    with span("air_openings.assemble"):
        queries: List[RowOpenings] = []
        for row in rows:
            per_tape = [
                PerTapeOpen(
                    mv=next(opened), next_mv=next(opened), write_flag=next(opened),
                    write_sym=next(opened), head=next(opened), next_head=next(opened),
                    win_len=next(opened), in_off=next(opened), out_off=next(opened),
                )
                for _ in range(tau)
            ]
            queries.append(
                RowOpenings(
                    row=row,
                    per_tape=per_tape,
                    is_first=next(opened),
                    is_last=next(opened),
                    input_mv=next(opened),
                )
            )
    if dc is not None:
        # AIR openings done; free the matrix before the FRI gathers
        _release_planes_if_large(dc, release_planes_bytes)
    stages.mark("air_openings")

    # ---- FRI queries ----
    with span("fri_openings.plan"):
        fri_rows = params.derive_queries(tr, lde_n, params.NUM_QUERIES)
    if fri_eng is not None:
        fri_queries: List[FriQuery] = fri_eng.open_queries(fri_rows)
    else:
        fri_queries = [fri_open_query(layers, trees, idx0) for idx0 in fri_rows]
    stages.mark("sharded_open" if sharded else "fri_openings")

    return ProofV1(
        domain_n=lde_n,
        tau=tau,
        col_roots=col_roots,
        queries=queries,
        fri_roots=roots,
        fri_queries=fri_queries,
        fri_final_value_le=fri_final_value_le,
        manifest_root=manifest_root,
    )

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sezkp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, as below
    python3 chip_smoke.py --phases env,kernels  # a subset, while developing

Phases (any failure ends the run with a non-zero exit code):

  env           card name and power limit, versions; builds the native host
                library (g++) and the CUDA kernels (nvcc) from the sources in
                this checkout.
  kernels       every hand-written kernel against its plain PyTorch version
                on the card, exact equality (tolerance 0: integer code), at
                reduced and at main-path shapes; kernel, plain and bound times.
                K5/K6 at every n = 2^1 .. 2^13 both ways, and the whole
                transforms there against the host oracle. K2-K4 also at
                three-factor shapes that the port's own factorisation never
                picks (a last factor of 8 and of 32, a full-size phase-A
                table). K7 at twelve message lengths from 1 to 1024 bytes and
                batches from 1 to 1000003 messages, against its plain version
                and against the host hasher. K8-K11 (the digit form of the NTT
                phases on the tensor cores) at reduced shapes and at the
                probes' shapes: K8 also against torch._int_mm, K10 with
                elements in against K2 on the same input, the folded forward
                NTT (K2, K3, K11) against forward_ntt at 2^20 and 2^23.
  prove         T = 2^20, b = 512, tau = 8 on the device-resident route:
                generate_trace -> partition_trace -> commit_blocks ->
                StarkV1.prove (on the card) -> StarkV1.verify; a tampered
                proof is rejected; a second prove is byte-identical; the
                launch counts of K1-K4 over the prove are > 0; wall time per
                stage and peak device memory. Then one prove on the
                host-columns route, whose bytes must be the same.
  parity-small  device-resident route: the proof made on the card equals,
                byte for byte, the proof made with device="cpu" at T = 2^13
                (where K5 and K6 must have launched once each) and T = 2^15;
                at T = 2^16 the proves with zero memory budgets (roots-scan
                commit, recomputed and range-derived openings, slab-wise
                composition) equal the resident prove.
  fold          the fold line at T = 2^22, b = 64, tau = 2 (65536 blocks) and at
                T = 2^20, b = 512, tau = 8 (2048 blocks): FoldBackend.prove in
                balanced mode as a user calls it (batches from the default
                threshold up hashed on the card through K7) and with every
                batch on the host (device_hash_min=0), twice each in turns,
                then with every batch on the card (device_hash_min=1); the
                (at 65536 blocks three proves: default, host, every batch);
                the proof bytes must be equal, verify
                accepts, two tampered proofs are rejected, K7's launch count is
                > 0 over the device-hashed prove and 0 over the host-hashed
                prove and over verify; wall and stage seconds of each. Then
                the streamed prove of the smaller input into a temporary
                .cborseq (verified, tampered copy rejected, same root).
  crossover     the table behind the fold line's device-hash threshold: the
                host's hash_many against hash_many_device end to end (upload,
                padding and transposition on the card, K7, download) and the
                device path's three parts, for four message lengths and eleven
                batch sizes from 2^4 to 2^18, each the median of five runs; and
                the batch size from which the card wins at every length.
  probes        the four probe mains of sezkp_tpu_torch/probes at full width
                (mxu_peak at its shapes; ntt_breakdown, twiddle_fold_ab and
                profile_ntt at k = 23, the last with a torch.profiler trace
                under chiprun_out/); each must find its equality check true;
                the launch counts of K8-K11 over them are > 0.
  cli           in a temporary directory, through sezkp_tpu_torch.cli.main with
                no --device: simulate T = 2^20, b = 512, tau = 8 -> commit ->
                verify-commit -> prove --backend stark -> verify; prove
                --backend fold -> verify; prove --backend fold --stream
                --fold-mode minram -> verify; a proof file with one flipped
                byte is rejected; the proof bytes in the files equal those of
                the in-process StarkV1.prove / FoldBackend.prove on the same
                blocks and root, and so do the launch counts of K1-K7.
  prove-large   only when asked for (--phases env,prove-large): T = 2^22
                (LDE 2^25, the largest size the port proves so far),
                device-resident route: two proves (byte-identical) + verify,
                stage seconds and peak device memory.
  sass          only when asked for (--phases env,sass): disassembles the
                built kernels and a one-primitive probe and prints the
                instruction counts, by issue pipe, that the operation bounds
                of the kernels phase rest on, with a sha256 of each kernel's
                instructions; the text goes to chiprun_out/sass/. With
                --sass-csrc DIR (the ops/csrc of another checkout) it builds
                those sources too and says which kernels are the same code.

Output: progress lines, then one JSON line {"kernels": [...]} with one entry
per kernel, then the card's name and power limit, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch

# Peaks of one H100 SXM (NVIDIA data sheet). The memory rate and the dense
# int8 tensor-core rate stand once, in sezkp_tpu_torch/probes/_common.py, and
# `_peaks()` reads them there. 67 TFLOP/s of float32 outside the tensor
# cores is 128 lanes x 2 (FMA) per SM-clock.
# 32-bit integer instructions issue on two pipes, the multiply-add pipe (the
# IMAD family) and the ALU (IADD3, LOP3, SHF, ISETP, SEL ...), each with half
# those lanes and no FMA doubling: a quarter of the float32 rate per pipe.
INT_PIPE_OPS_PER_S = 67e12 / 4
# Machine instructions (multiply-add pipe, ALU pipe) of the field primitives
# and of one BLAKE3 compression, counted in the disassembly of this source
# built with nvcc 12.9 for sm_90a (`--phases env,sass` prints them anew):
# gl::mul is 5 IMAD.WIDE.U32 + 8 more of the IMAD family and 21 ALU
# instructions; a compression is 224 adds (108 of them compiled to IMAD.IADD),
# 232 LOP3 and 224 SHF. Indexing, loads and stores are not counted.
GL_MUL_OPS, GL_ADD_OPS, GL_SUB_OPS = (13, 21), (3, 11), (1, 7)
B3_OPS = (108, 572)


def _peaks():
    """(HBM bytes per second, dense int8 tensor-core operations per second)."""
    from sezkp_tpu_torch.probes._common import HBM_BYTES_PER_S, INT8_PEAK_OPS

    return HBM_BYTES_PER_S, INT8_PEAK_OPS


def ops_ms(n: int, per_item) -> float:
    """Least milliseconds for n items of (multiply-add, ALU) instructions each:
    the two pipes issue side by side, so the fuller one bounds."""
    return n * max(per_item) / INT_PIPE_OPS_PER_S * 1e3


def max_abs_diff(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over the elements read as unsigned integers (exact)."""
    ne = got != want
    if not bool(ne.any()):
        return 0
    bits = np.uint64 if got.dtype == torch.int64 else np.uint32
    g = got[ne].cpu().numpy().view(bits).astype(np.uint64)
    w = want[ne].cpu().numpy().view(bits).astype(np.uint64)
    return int(np.where(g > w, g - w, w - g).max())

ALL_PHASES = ("env", "kernels", "prove", "parity-small", "fold", "crossover", "probes", "cli")
# run only when asked for: the largest prove, and the disassembly that the
# operation counts are read from
EXTRA_PHASES = ("prove-large", "sass")


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def time_cuda(fn, reps: int) -> float:
    """Milliseconds per call: CUDA events around `reps` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_cuda_graph(fn, reps: int) -> float:
    """Milliseconds per call on the device alone: `reps` calls captured into
    one CUDA graph and replayed, so the host's cost of making each launch
    (which exceeds the device time of a microsecond-sized kernel) drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_cuda(graph.replay, 5) / reps


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------- phases ----------------------------------


def phase_env(state) -> None:
    state["smi"] = nvidia_smi_line()
    log(f"[env] card: {state['smi']}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    # importing the host hasher builds the native library when it is missing
    from sezkp_tpu_torch.crypto import blake3 as b3
    from sezkp_tpu_torch.ops import _kernels

    b3.build_native()
    if not b3.HAVE_NATIVE:
        fail("native host library (g++) did not build or load")
    t1 = time.time()
    _kernels.lib()
    log(f"[env] set-up: native host lib {t1 - t0:.1f} s, CUDA kernels {_kernels.build_seconds:.1f} s")


def _field_rand(shape, gen, dev):
    """Random canonical field elements with the edge values 0 and p-1 planted."""
    from sezkp_tpu_torch.ops import goldilocks_torch as FT

    hi = torch.randint(0, 1 << 32, shape, generator=gen, device=dev, dtype=torch.int64)
    lo = torch.randint(0, 1 << 32, shape, generator=gen, device=dev, dtype=torch.int64)
    x = FT._canon((hi << 32) | lo)
    flat = x.view(-1)
    flat[0] = 0
    flat[1] = FT._i64(FT.P_INT - 1)
    flat[-1] = FT._i64(FT.P_INT - 1)
    return x


def _words_rand(n, gen, dev):
    """Random int32 [16, n] message words (any 32-bit pattern)."""
    w = torch.randint(0, 1 << 32, (16, n), generator=gen, device=dev, dtype=torch.int64)
    return w.to(torch.int32)


def phase_kernels(state) -> None:
    from sezkp_tpu_torch.ops import blake3_torch as BT
    from sezkp_tpu_torch.ops import goldilocks as G
    from sezkp_tpu_torch.ops import goldilocks_torch as FT
    from sezkp_tpu_torch.ops import ntt as ntt_host
    from sezkp_tpu_torch.ops import ntt_torch as NT

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    kern = {}

    # ---- K1 blake3_compress
    err = 0
    for n in (1 << 20, 1000003, 1):
        m16 = _words_rand(n, gen, dev)
        for block_len in (8, 27, 64):
            for out_words in (8, 16):
                got = BT.compress(m16, block_len, BT.LEAF_FLAGS, out_words)
                want = BT.compress_plain(m16, block_len, BT.LEAF_FLAGS, out_words)
                torch.cuda.synchronize()
                err = max(err, max_abs_diff(got, want))
                if err:
                    fail(f"K1 blake3_compress != plain at N={n} block_len={block_len} "
                         f"out_words={out_words}: max |difference| {err}")
    # main-path shape: the FRI layer-0 leaves of a T = 2^20 prove
    n = 1 << 23
    m16 = _words_rand(n, gen, dev)
    out = torch.empty((8, n), dtype=torch.int32, device=dev)
    got = BT.compress(m16, 8, BT.LEAF_FLAGS, 8, out=out)
    want = BT.compress_plain(m16, 8, BT.LEAF_FLAGS, 8)
    err = max_abs_diff(got, want)
    if err:
        fail(f"K1 blake3_compress != plain at N=2^23: max |difference| {err}")
    ms = time_cuda(lambda: BT.compress(m16, 8, BT.LEAF_FLAGS, 8, out=out), 20)
    plain_ms = time_cuda(lambda: BT.compress_plain(m16, 8, BT.LEAF_FLAGS, 8), 1)
    b_bytes = n * (64 + 32) / _peaks()[0] * 1e3
    b_ops = ops_ms(n, B3_OPS)
    kern["blake3_compress"] = dict(
        name="blake3_compress", route="cuda",
        source="sezkp_tpu_torch/ops/csrc/blake3_compress.cu",
        replaces="sezkp_tpu/ops/blake3_pallas.py:108",
        shape=f"int32 [16, 2^23] -> [8, 2^23], block_len 8",
        max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
        library_ms=None,
    )
    del m16, out, got, want
    log(f"[kernels] K1 blake3_compress == plain (N = 2^20, 1000003, 1, 2^23): {ms:.3f} ms at 2^23")

    # ---- K2-K4: the phases of n = 2^14, 2^15 (two-factor), 2^17, 2^18, 2^20 inverse, 2^23 forward
    def bound(n_el, m_log2, twiddles, table_el):
        """A phase reads and writes each element once (16 B) and its tables
        once; an element takes m_log2 / 2 butterflies (mul, add, sub) and
        `twiddles` further multiplies."""
        b_bytes = (16 * n_el + 8 * table_el) / _peaks()[0] * 1e3
        per_el = tuple(m_log2 * (mu + ad + su) / 2 + twiddles * mu
                       for mu, ad, su in zip(GL_MUL_OPS, GL_ADD_OPS, GL_SUB_OPS))
        b_ops = ops_ms(n_el, per_el)
        return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")

    errs = {"ntt_phase_axis": 0, "ntt_phase_batched": 0, "ntt_phase_last": 0}

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        errs[name] = max(errs[name], max_abs_diff(got, want))
        if errs[name]:
            fail(f"{name} != plain at {what}: max |difference| {errs[name]}")

    for n_log2, inverse in ((14, False), (14, True), (15, False), (15, True), (17, False), (17, True),
                            (18, False), (18, True), (20, True), (23, False)):
        n = 1 << n_log2
        logs = NT._factor_logs(n_log2)
        inv_n = G.inv(n) if inverse else 1
        a = _field_rand((n,), gen, dev)
        what = f"n=2^{n_log2} inverse={inverse}"
        main = (n_log2, inverse) in ((20, True), (23, False))
        if len(logs) == 2:
            l1, l2 = logs
            m1, m2 = 1 << l1, 1 << l2
            tw = NT._twiddle_matrix(l1, l2, inverse, dev)
            x0 = a.reshape(m1, m2)
            x1 = NT.phase_axis(x0, 0, inverse, tw=tw)
            hold("ntt_phase_axis", x1, NT.phase_axis_plain(x0, 0, inverse, tw=tw), what + " axis 0")
            x2 = NT.phase_axis(x1, 1, inverse, scale=inv_n)
            hold("ntt_phase_axis", x2, NT.phase_axis_plain(x1, 1, inverse, scale=inv_n), what + " axis 1")
            res = x2.T.reshape(n)
        else:
            l1, l2, l3 = logs
            m1, m2, m3 = 1 << l1, 1 << l2, 1 << l3
            ta, tb = NT._t_outer(l1, l2, l3, inverse, dev)
            tm = NT._t_mid(l2, l3, inverse, dev)
            x0 = a.reshape(m1, m2 * m3)
            x1 = NT.phase_axis(x0, 0, inverse, tw=tb, tw_period=m3)
            p1 = NT.phase_axis_plain(x0, 0, inverse, tw=tb, tw_period=m3)
            hold("ntt_phase_axis", x1, p1, what)
            x1 = x1.reshape(m1, m2, m3)
            x2 = NT.phase_batched(x1, inverse, ta=ta, t=tm)
            p2 = NT.phase_batched_plain(x1, inverse, ta=ta, t=tm)
            hold("ntt_phase_batched", x2, p2, what)
            x3 = NT.phase_last(x2, inverse, scale=inv_n)
            p3 = NT.phase_last_plain(x2, inverse, scale=inv_n)
            hold("ntt_phase_last", x3, p3, what)
            res = x3.reshape(n)
            if main and n_log2 == 23:
                # times at the largest main-path shape (the coset NTT of a T = 2^20 prove)
                for name, fn, plain, shp, mlog, ntw, tab in (
                    ("ntt_phase_axis",
                     lambda: NT.phase_axis(x0, 0, inverse, tw=tb, tw_period=m3),
                     lambda: NT.phase_axis_plain(x0, 0, inverse, tw=tb, tw_period=m3),
                     f"int64 [{m1}, {m2 * m3}] axis 0, periodic twiddle [{m1}, {m3}]",
                     l1, 1, m1 * m3 + m1 // 2),
                    ("ntt_phase_batched",
                     lambda: NT.phase_batched(x1, inverse, ta=ta, t=tm),
                     lambda: NT.phase_batched_plain(x1, inverse, ta=ta, t=tm),
                     f"int64 [{m1}, {m2}, {m3}], ta [{m1}, {m2}], t [{m2}, {m3}]",
                     l2, 2, m1 * m2 + m2 * m3 + m2 // 2),
                    ("ntt_phase_last",
                     lambda: NT.phase_last(x2, inverse, scale=inv_n),
                     lambda: NT.phase_last_plain(x2, inverse, scale=inv_n),
                     f"int64 [{m1}, {m2}, {m3}] -> [{m3}, {m2}, {m1}]",
                     l3, 0, m3 // 2),
                ):
                    ms = time_cuda(fn, 20)
                    plain_ms = time_cuda(plain, 1)
                    bnd, by = bound(n, mlog, ntw, tab)
                    kern[name] = dict(
                        name=name, route="cuda", source="sezkp_tpu_torch/ops/csrc/ntt_phases.cu",
                        shape=shp, ms=ms, plain_ms=plain_ms, bound_ms=bnd, bound_by=by,
                        library_ms=None,
                    )
        # whole transform against the host oracle at the sizes numpy does quickly
        if n_log2 <= 18:
            ref = ntt_host.inverse_ntt(_to_u64(a)) if inverse else ntt_host.forward_ntt(_to_u64(a))
            if not np.array_equal(_to_u64(res), ref):
                fail(f"NTT != host oracle at {what}")
        log(f"[kernels] NTT phases == plain at {what} (factors {logs})")
        del a, res

    kern["ntt_phase_axis"]["replaces"] = "sezkp_tpu/ops/ntt_mxu.py:374"
    kern["ntt_phase_batched"]["replaces"] = "sezkp_tpu/ops/ntt_mxu.py:475"
    kern["ntt_phase_last"]["replaces"] = "sezkp_tpu/ops/ntt_mxu.py:540"
    # ---- K5/K6: the two phases of every n = 2^1 .. 2^13, both ways
    errs.update(ntt_small_cols=0, ntt_small_rows=0)
    for n_log2 in range(1, NT.MIN_LOG2):
        for inverse in (False, True):
            n = 1 << n_log2
            l1 = min(10, n_log2 // 2)
            l2 = n_log2 - l1
            inv_n = G.inv(n) if inverse else 1
            a = _field_rand((n,), gen, dev)
            what = f"n=2^{n_log2} inverse={inverse}"
            tw = NT._twiddle_matrix(l1, l2, inverse, dev)
            x0 = a.reshape(1 << l1, 1 << l2)
            x1 = NT.small_cols(x0, inverse, tw)
            hold("ntt_small_cols", x1, NT.small_cols_plain(x0, inverse, tw), what)
            x2 = NT.small_rows(x1, inverse, scale=inv_n)
            hold("ntt_small_rows", x2, NT.small_rows_plain(x1, inverse, scale=inv_n), what)
            whole = NT.inverse_ntt(a) if inverse else NT.forward_ntt(a)
            ref = ntt_host.inverse_ntt(_to_u64(a)) if inverse else ntt_host.forward_ntt(_to_u64(a))
            if not (np.array_equal(_to_u64(whole), ref) and np.array_equal(_to_u64(x2).reshape(n), ref)):
                fail(f"small-n NTT != host oracle at {what}")
            if n_log2 == NT.MIN_LOG2 - 1 and inverse:
                # times at the main-path shape: the base inverse NTT of a T = 2^13 prove
                for name, fn, plain, shp, mlog, tab in (
                    ("ntt_small_cols",
                     lambda: NT.small_cols(x0, inverse, tw),
                     lambda: NT.small_cols_plain(x0, inverse, tw),
                     f"int64 [{1 << l1}, {1 << l2}] columns, twiddle [{1 << l1}, {1 << l2}]",
                     l1, n + (1 << l1) // 2),
                    ("ntt_small_rows",
                     lambda: NT.small_rows(x1, inverse, scale=inv_n),
                     lambda: NT.small_rows_plain(x1, inverse, scale=inv_n),
                     f"int64 [{1 << l1}, {1 << l2}] rows -> [{1 << l2}, {1 << l1}], scale n^-1",
                     l2, (1 << l2) // 2),
                ):
                    ms = time_cuda(fn, 200)
                    graph_ms = time_cuda_graph(fn, 200)
                    plain_ms = time_cuda(plain, 5)
                    bnd, by = bound(n, mlog, 1, tab)
                    # ms: launches made one by one from Python, as the prover
                    # makes them; graph_ms: the same launches replayed from a
                    # CUDA graph, the device's share of that time
                    kern[name] = dict(
                        name=name, route="cuda", source="sezkp_tpu_torch/ops/csrc/ntt_small.cu",
                        shape=shp, ms=ms, graph_ms=graph_ms, plain_ms=plain_ms, bound_ms=bnd,
                        bound_by=by, library_ms=None,
                    )
    kern["ntt_small_cols"]["replaces"] = "sezkp_tpu/ops/ntt_pallas.py:162"
    kern["ntt_small_rows"]["replaces"] = "sezkp_tpu/ops/ntt_pallas.py:177"
    for name in ("ntt_small_cols", "ntt_small_rows"):
        kern[name]["max_abs_err"] = errs[name]
    if NT.forward_ntt(torch.zeros(1, dtype=torch.int64, device=dev)).shape != (1,):
        fail("forward_ntt of one point")
    log("[kernels] K5/K6 == plain, and forward/inverse NTT == host oracle, at every n = 2^1 .. 2^13")

    # ---- K2-K4 at three-factor shapes outside the port's own factorisation:
    # a last factor below 128 (the JAX package's transposed-contraction
    # branch), and phase A with one full-size table in place of the periodic
    # one and the middle phase's ta
    for (l1, l2, l3), inverse in (((7, 6, 3), False), ((7, 6, 3), True),
                                  ((6, 7, 5), False), ((6, 7, 5), True)):
        n_log2 = l1 + l2 + l3
        n = 1 << n_log2
        m1, m2, m3 = 1 << l1, 1 << l2, 1 << l3
        inv_n = G.inv(n) if inverse else 1
        a = _field_rand((n,), gen, dev)
        ref = ntt_host.inverse_ntt(_to_u64(a)) if inverse else ntt_host.forward_ntt(_to_u64(a))
        ta, tb = NT._t_outer(l1, l2, l3, inverse, dev)
        tm = NT._t_mid(l2, l3, inverse, dev)
        full = FT.mul(ta[:, :, None], tb[:, None, :]).reshape(m1, m2 * m3).contiguous()
        x0 = a.reshape(m1, m2 * m3)
        for what, tw, period, ta_mid in (("periodic table", tb, m3, ta), ("full-size table", full, None, None)):
            what = f"factors ({m1}, {m2}, {m3}) inverse={inverse}, {what}"
            x1 = NT.phase_axis(x0, 0, inverse, tw=tw, tw_period=period)
            hold("ntt_phase_axis", x1, NT.phase_axis_plain(x0, 0, inverse, tw=tw, tw_period=period), what)
            x1 = x1.reshape(m1, m2, m3)
            x2 = NT.phase_batched(x1, inverse, ta=ta_mid, t=tm)
            hold("ntt_phase_batched", x2, NT.phase_batched_plain(x1, inverse, ta=ta_mid, t=tm), what)
            x3 = NT.phase_last(x2, inverse, scale=inv_n)
            hold("ntt_phase_last", x3, NT.phase_last_plain(x2, inverse, scale=inv_n), what)
            if not np.array_equal(_to_u64(x3).reshape(n), ref):
                fail(f"three-phase NTT != host oracle at {what}")
        log(f"[kernels] K2-K4 == plain and == host oracle at factors ({m1}, {m2}, {m3}) "
            f"inverse={inverse}, periodic and full-size phase-A table")
    for name in ("ntt_phase_axis", "ntt_phase_batched", "ntt_phase_last"):
        kern[name]["max_abs_err"] = errs[name]

    # ---- K7 blake3_chain
    from sezkp_tpu_torch.crypto import blake3 as host_b3

    rng = np.random.default_rng(77)
    err7 = 0

    def chain_case(n, length):
        """K7 on n random messages of `length` bytes == plain version == host hasher."""
        nonlocal err7
        msgs = rng.integers(0, 256, (n, length), dtype=np.uint8)
        planes = BT.messages_to_planes(msgs, dev)
        got = BT.hash_many_words(planes, length)
        want = BT.hash_many_words_plain(planes, length)
        torch.cuda.synchronize()
        err7 = max(err7, max_abs_diff(got, want))
        if err7:
            fail(f"K7 blake3_chain != plain at N={n} L={length}: max |difference| {err7}")
        if not np.array_equal(BT.cv_planes_to_bytes(got), host_b3.hash_many(msgs)):
            fail(f"K7 blake3_chain != host hash_many at N={n} L={length}")
        return planes

    lengths = (1, 55, 63, 64, 65, 124, 128, 129, 320, 813, 1023, 1024)
    for length in lengths:
        for n in (1, 29):
            chain_case(n, length)
    chain_case(1000003, 320)
    timed = {}
    # a boundary digest at tau = 2 and the leaf MAC transcript at 65536 blocks,
    # and the fold/merge transcript at the top level of 2048 blocks
    for length, n in ((813, 1 << 16), (320, 1 << 16), (677, 1 << 11)):
        planes = chain_case(n, length)
        nblocks = planes.shape[0] // 16
        out = torch.empty((8, n), dtype=torch.int32, device=dev)
        b_bytes = n * (64 * nblocks + 32) / _peaks()[0] * 1e3
        b_ops = ops_ms(n * nblocks, B3_OPS)
        # ms: launches made one by one from Python, as the prover makes them;
        # graph_ms: the same launches replayed from a CUDA graph
        timed[length] = dict(
            shape=f"int32 [{16 * nblocks}, {n}] -> [8, {n}], {length}-byte messages ({nblocks} blocks)",
            ms=time_cuda(lambda: BT.hash_many_words(planes, length, out=out), 200),
            graph_ms=time_cuda_graph(lambda: BT.hash_many_words(planes, length, out=out), 200),
            plain_ms=time_cuda(lambda: BT.hash_many_words_plain(planes, length), 3),
            bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
        )
    kern["blake3_chain"] = dict(
        name="blake3_chain", route="cuda",
        source="sezkp_tpu_torch/ops/csrc/blake3_chain.cu",
        replaces="sezkp_tpu/ops/blake3_pallas.py:219",
        max_abs_err=err7, **timed[813], library_ms=None, at_320_bytes=timed[320],
        at_2048_messages_of_677_bytes=timed[677],
    )
    log(f"[kernels] K7 blake3_chain == plain == host hash_many at L in {lengths}, N in (1, 29), "
        f"N = 1000003 at L = 320, N = 2^16 at L = 813 and 320, N = 2^11 at L = 677; "
        f"{timed[813]['ms']:.4f} ms issued from Python, {timed[813]['graph_ms']:.4f} ms "
        f"replayed, at [208, 2^16]; {timed[677]['ms']:.4f} and {timed[677]['graph_ms']:.4f} at [176, 2^11]")

    # whole forward/inverse round trip at 2^23
    a = _field_rand((1 << 23,), gen, dev)
    back = NT.inverse_ntt(NT.forward_ntt(a))
    torch.cuda.synchronize()
    if not torch.equal(back, a):
        fail("inverse_ntt(forward_ntt(x)) != x at n = 2^23")
    log("[kernels] forward/inverse round trip at 2^23 ok")

    # what the wrappers must refuse on the card, where no plain version stands in
    def refuses(exc, what, fn):
        try:
            fn()
        except exc:
            return
        fail(f"{what}: expected {exc.__name__}")

    small = a[: 1 << 10].clone()
    if not np.array_equal(_to_u64(NT.forward_ntt(small)), ntt_host.forward_ntt(_to_u64(small))):
        fail("forward_ntt of n = 2^10 on the card != host oracle")
    refuses(ValueError, "compress of int64 words",
            lambda: BT.compress(torch.zeros((16, 8), dtype=torch.int64, device=dev), 64, BT.LEAF_FLAGS))
    refuses(ValueError, "phase_axis of a non-contiguous view",
            lambda: NT.phase_axis(torch.zeros((8, 8), dtype=torch.int64, device=dev).T, 0, False))
    refuses(ValueError, "small_cols of a 1-D tensor",
            lambda: NT.small_cols(small, False, small))
    zeros = torch.zeros((32, 8), dtype=torch.int32, device=dev)
    refuses(ValueError, "hash_many_words of 0-byte messages",
            lambda: BT.hash_many_words(zeros[:16], 0))
    refuses(ValueError, "hash_many_words of 1025-byte messages",
            lambda: BT.hash_many_words(torch.zeros((272, 8), dtype=torch.int32, device=dev), 1025))
    refuses(ValueError, "hash_many_words of 32 planes for one block",
            lambda: BT.hash_many_words(zeros, 64))
    refuses(ValueError, "hash_many_words of a non-contiguous view",
            lambda: BT.hash_many_words(zeros.t().contiguous().t()[:16], 64))
    log("[kernels] n = 2^10 on the card == host oracle; the wrappers refuse a wrong dtype, "
        "a wrong rank, non-contiguous input, and K7 a length outside 1..1024 and a wrong plane count")

    _kernels_digit_form(kern, gen, dev)

    # the plain tensor steps of the DEEP glue and the FRI fold, which no
    # kernel covers (they are outside any kernel in the JAX package too)
    half = a.shape[0] // 2
    glue = {
        "pow_p_minus_2": time_cuda(lambda: FT.pow_p_minus_2(a), 1),
        "mul": time_cuda(lambda: FT.mul(a, back), 5),
        "fri_fold": time_cuda(
            lambda: FT.add(a[:half], FT.mul(FT.scalar(12345, a), a[half:])), 5),
    }
    state["glue_ms"] = glue
    log("[kernels] plain tensor glue at 2^23 elements (ms): "
        + json.dumps({k: round(v, 3) for k, v in glue.items()}))
    state["kernels"] = kern


def _bound(nbytes: float, int8_ops: float):
    """(bound ms, what sets it) of a tensor-core kernel: its bytes over the
    memory rate against its int8 operations over the dense tensor-core rate."""
    hbm, int8_peak = _peaks()
    b_bytes = nbytes / hbm * 1e3
    b_ops = int8_ops / int8_peak * 1e3
    return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")


def _kernels_digit_form(kern, gen, dev) -> None:
    """K8-K11 against their plain versions (exact), K8 against torch._int_mm,
    K10 and the folded transform against the butterfly kernels; times at the
    probes' shapes (one phase of n = 2^23: m = 256, other = 32768; K8 at the
    2^24 phase of the probe script, m = 256 and 8 x 65536 columns)."""
    from sezkp_tpu_torch.ops import goldilocks_torch as FT
    from sezkp_tpu_torch.ops import ntt_digits_torch as ND
    from sezkp_tpu_torch.ops import ntt_torch as NT
    from sezkp_tpu_torch.probes._common import int_mm_sum as _int_mm_sum
    from sezkp_tpu_torch.probes._common import rand_i8 as _rand_i8

    errs = {"i8_gemm": 0, "gl_digits": 0, "digit_dft": 0, "digit_dft_last": 0}

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{name} at {what}: {got.dtype} {tuple(got.shape)} against {want.dtype} {tuple(want.shape)}")
        if got.dtype == torch.int8:
            got, want = got.to(torch.int32), want.to(torch.int32)
        errs[name] = max(errs[name], max_abs_diff(got, want))
        if errs[name]:
            fail(f"{name} != its reference at {what}: max |difference| {errs[name]}")

    def edge_field(shape):
        x = _field_rand(shape, gen, dev)
        x.view(-1)[2] = FT._i64(ND.MAX_BAL)
        x.view(-1)[3] = FT._i64(ND.MAX_BAL + 1)
        return x

    # ---- K8 i8_gemm
    for M, K, N, nrep in ((64, 64, 64, 1), (128, 192, 320, 3), (256, 256, 8 * 4096, 8), (1024, 1024, 4096, 1)):
        w, x = _rand_i8((nrep * M, K), M + N, dev), _rand_i8((K, N), M + N + 1, dev)
        for epilogue in ("int32", "and127"):
            want = ND.i8_gemm_plain(w, x, nrep, epilogue)
            for fuse in (False, True):
                hold("i8_gemm", ND.i8_gemm(w, x, nrep, epilogue, fuse), want,
                     f"M={M} K={K} N={N} nrep={nrep} {epilogue} fuse={fuse}")
        hold("i8_gemm", ND.i8_gemm(w, x, nrep), _int_mm_sum(w, x, nrep), f"M={M} K={K} N={N} nrep={nrep} (torch._int_mm)")
    # all -128: the sum passes 2^31 and must wrap, not saturate
    w = torch.full((64 * 128, 1024), -128, dtype=torch.int8, device=dev)
    x = torch.full((1024, 64), -128, dtype=torch.int8, device=dev)
    hold("i8_gemm", ND.i8_gemm(w, x, 128), ND.i8_gemm_plain(w, x, 128), "the int32 wrap (sum = 2^31)")
    if int(ND.i8_gemm(w, x, 128)[0, 0]) != -(1 << 31):
        fail("i8_gemm: 2^31 did not wrap to -2^31")
    m, nd, other = 256, ND.NDIG, 65536
    w, x = _rand_i8((nd * m, m), 1, dev), _rand_i8((m, nd * other), 2, dev)
    got = ND.i8_gemm(w, x, nd)
    hold("i8_gemm", got, ND.i8_gemm_plain(w, x, nd), "the probe's shape")
    hold("i8_gemm", got, _int_mm_sum(w, x, nd), "the probe's shape (torch._int_mm)")
    hold("i8_gemm", ND.i8_gemm(w, x, nd, "int32", True), got, "the probe's shape, fused")
    del got
    macs = nd * m * m * nd * other
    bnd, by = _bound(w.numel() + x.numel() + 4 * m * nd * other, 2 * macs)
    kern["i8_gemm"] = dict(
        name="i8_gemm", route="cuda", source="sezkp_tpu_torch/ops/csrc/i8_gemm.cu",
        replaces="scripts/exp_mxu_peak.py:76", also_replaces=["scripts/exp_mxu_peak.py:105", "scripts/exp_mxu_peak.py:128"],
        shape=f"int8 [{nd}*{m}, {m}] @ int8 [{m}, {nd}*{other}] -> int32 [{m}, {nd}*{other}], {nd} products summed",
        ms=time_cuda(lambda: ND.i8_gemm(w, x, nd), 10),
        fused_ms=time_cuda(lambda: ND.i8_gemm(w, x, nd, "int32", True), 10),
        plain_ms=time_cuda(lambda: ND.i8_gemm_plain(w, x, nd), 1),
        bound_ms=bnd, bound_by=by,
        library_ms=time_cuda(lambda: _int_mm_sum(w, x, nd), 10),
    )
    del w, x
    # the large square products of the probe, at 2^20 columns: both epilogues
    # against the plain version on the same inputs (whole, not a slab of columns)
    big = {}
    for mm in (1024, 512):
        w, x = _rand_i8((mm, mm), 5 + mm, dev), _rand_i8((mm, 1 << 20), 6 + mm, dev)
        what = f"[{mm}, {mm}] @ [{mm}, 2^20]"
        for epilogue in ("int32", "and127"):
            hold("i8_gemm", ND.i8_gemm(w, x, 1, epilogue), ND.i8_gemm_plain(w, x, 1, epilogue), f"{what} {epilogue}")
        hold("i8_gemm", ND.i8_gemm(w, x), torch._int_mm(w, x), what + " (torch._int_mm)")
        # the int32 store writes 4 bytes per output, the `& 127` store one
        ops = 2 * mm * mm * (1 << 20)
        bnd, by = _bound(w.numel() + x.numel() + 4 * mm * (1 << 20), ops)
        bnd8, by8 = _bound(w.numel() + x.numel() + mm * (1 << 20), ops)
        big[f"at_{mm}x{mm}x2^20"] = dict(
            ms=time_cuda(lambda: ND.i8_gemm(w, x), 5), bound_ms=bnd, bound_by=by,
            and127_ms=time_cuda(lambda: ND.i8_gemm(w, x, 1, "and127"), 5), and127_bound_ms=bnd8, and127_bound_by=by8,
            plain_ms=time_cuda(lambda: ND.i8_gemm_plain(w, x), 1),
            library_ms=time_cuda(lambda: torch._int_mm(w, x), 5))
        del w, x
    kern["i8_gemm"].update(big)
    torch.cuda.empty_cache()
    log(f"[kernels] K8 i8_gemm == plain == torch._int_mm (both epilogues, both loop orders, the int32 wrap, the whole of [mm, mm] @ [mm, 2^20] at mm = 1024 and 512): "
        f"{kern['i8_gemm']['ms']:.3f} ms ({kern['i8_gemm']['fused_ms']:.3f} fused) against "
        f"{kern['i8_gemm']['library_ms']:.3f} ms of torch._int_mm at the probe's shape")

    # ---- K9 gl_digits
    for m, other in ((32, 32), (64, 160), (1024, 96), (256, 32768)):
        a = edge_field((m, other))
        planes = ND.digits_plain(a)
        hold("gl_digits", ND.gl_digits(a), ND.stack_kmajor(planes), f"[{m}, {other}] k-major")
        for tile in (32, other):
            hold("gl_digits", ND.gl_digits(a, tile), ND.stack_tiled(planes, tile), f"[{m}, {other}] tile {tile}")
    m, other = 256, 32768
    n = m * other
    bnd, by = _bound(16 * n, 0)
    kern["gl_digits"] = dict(
        name="gl_digits", route="cuda", source="sezkp_tpu_torch/ops/csrc/gl_digits.cu",
        replaces="scripts/exp_ntt_breakdown.py:129",
        shape=f"int64 [{m}, {other}] -> int8 [8, {other}, {m}] (k-major)",
        ms=time_cuda(lambda: ND.gl_digits(a), 20), tiled_512_ms=time_cuda(lambda: ND.gl_digits(a, 512), 20),
        plain_ms=time_cuda(lambda: ND.stack_kmajor(ND.digits_plain(a)), 2),
        bound_ms=bnd, bound_by=by, library_ms=None,
    )
    log(f"[kernels] K9 gl_digits == plain in both layouts: {kern['gl_digits']['ms']:.3f} ms at [256, 32768]")

    # ---- K10 digit_dft: against the plain version, and elements-in against K2
    for m_log2, other, inverse in ((5, 32, False), (6, 48, True), (7, 128, False), (9, 64, True), (10, 32, False),
                                   (8, 32768, False)):
        m = 1 << m_log2
        a = edge_field((m, other))
        w = ND.w_digits(m_log2, inverse, 1, dev)
        what = f"m={m} other={other} inverse={inverse}"
        stack = ND.stack_kmajor(ND.digits_plain(a))
        want = ND.digit_dft_plain(stack, w, "recombine")
        hold("digit_dft", ND.digit_dft(stack, w, "recombine"), want, what + " stack in")
        hold("digit_dft", ND.digit_dft(a, w, "recombine", elements=True), want, what + " elements in")
        hold("digit_dft", ND.digit_dft(a, w, "recombine", elements=True), NT.phase_axis(a, 0, inverse), what + " (K2)")
        hold("digit_dft", ND.digit_dft(stack, w, "sum"), ND.digit_dft_plain(stack, w, "sum"), what + " sum")
    x8 = _rand_i8((ND.NDIG, other, m), 3, dev)
    hold("digit_dft", ND.digit_dft(x8, w, "sum"), ND.digit_dft_plain(x8, w, "sum"), "random digit stack, sum")
    hold("digit_dft", ND.digit_dft(x8, w, "recombine"), ND.digit_dft_plain(x8, w, "recombine"),
         "random digit stack, recombine")
    n = m * other
    macs = ND.NDIG * ND.NDIG * m * n
    bnd, by = _bound(8 * n + w.numel() + 8 * n, 2 * macs)
    kern["digit_dft"] = dict(
        name="digit_dft", route="cuda", source="sezkp_tpu_torch/ops/csrc/digit_dft.cu",
        replaces="scripts/exp_ntt_breakdown.py:112", also_replaces=["scripts/exp_ntt_breakdown.py:92"],
        shape=f"int8 digit stack [8, {other}, {m}] x table int8 [8*{m}, {m}] -> int64 [{m}, {other}], recombined",
        ms=time_cuda(lambda: ND.digit_dft(x8, w, "recombine"), 10),
        sum_ms=time_cuda(lambda: ND.digit_dft(x8, w, "sum"), 10),
        elements_in_ms=time_cuda(lambda: ND.digit_dft(a, w, "recombine", elements=True), 10),
        k2_same_input_ms=time_cuda(lambda: NT.phase_axis(a, 0, False), 10),
        plain_ms=time_cuda(lambda: ND.digit_dft_plain(x8, w, "recombine"), 1),
        bound_ms=bnd, bound_by=by, library_ms=None,
    )
    del x8, stack, want
    log(f"[kernels] K10 digit_dft == plain (stack in, elements in, both epilogues) == K2: "
        f"{kern['digit_dft']['ms']:.3f} ms against K2's {kern['digit_dft']['k2_same_input_ms']:.3f} ms at [256, 32768]")

    # ---- K11 digit_dft_last and the folded transform
    for (l2, l3, cols), inverse, scale in (((2, 5, 64), False, 1), ((3, 7, 16), True, 977), ((8, 8, 128), False, 1)):
        m2, mc = 1 << l2, 1 << l3
        x = edge_field((cols, m2 * mc))
        wf = ND.folded_table(l2, l3, inverse, scale, dev)
        want = ND.digit_dft_last_plain(x, wf)
        hold("digit_dft_last", ND.digit_dft_last(x, wf), want, f"m2={m2} mc={mc} cols={cols}")
        # the table built on the card (field products, K9) against the plain digits of the same products
        cpu_table = ND.folded_table(l2, l3, inverse, scale, "cpu") if m2 * mc * mc <= 1 << 20 else None
        if cpu_table is not None and not torch.equal(wf.cpu(), cpu_table):
            fail("folded_table on the card != folded_table on the CPU")
    n = cols * m2 * mc
    bnd, by = _bound(8 * n + wf.numel() + 8 * n, 2 * ND.NDIG * ND.NDIG * mc * n)
    kern["digit_dft_last"] = dict(
        name="digit_dft_last", route="cuda", source="sezkp_tpu_torch/ops/csrc/digit_dft.cu",
        replaces="scripts/ntt_twiddle_fold_ab.py:101",
        shape=f"int64 [{cols}, {m2}*{mc}] x folded table int8 [{m2}, {mc}, 8, {mc}] -> int64 [{mc}, {m2}*{cols}]",
        ms=time_cuda(lambda: ND.digit_dft_last(x, wf), 10),
        plain_ms=time_cuda(lambda: ND.digit_dft_last_plain(x, wf), 1),
        bound_ms=bnd, bound_by=by, library_ms=None,
    )
    del x, wf, want
    for n_log2 in (18, 20, 23):
        a = edge_field((1 << n_log2,))
        hold("digit_dft_last", ND.forward_ntt_folded(a), NT.forward_ntt(a), f"forward_ntt_folded at 2^{n_log2}")
    kern["digit_dft_last"]["folded_forward_2^23_ms"] = time_cuda(lambda: ND.forward_ntt_folded(a), 10)
    kern["digit_dft_last"]["forward_2^23_ms"] = time_cuda(lambda: NT.forward_ntt(a), 10)
    log(f"[kernels] K11 digit_dft_last == plain; forward_ntt_folded == forward_ntt at 2^18, 2^20, 2^23: "
        f"{kern['digit_dft_last']['ms']:.3f} ms; whole transform {kern['digit_dft_last']['folded_forward_2^23_ms']:.3f} ms "
        f"folded against {kern['digit_dft_last']['forward_2^23_ms']:.3f} ms")
    for name, e in errs.items():
        kern[name]["max_abs_err"] = e

    def refuses(what, fn):
        try:
            fn()
        except (ValueError, RuntimeError):
            return
        fail(f"{what}: expected a refusal")

    z8 = torch.zeros((64, 64), dtype=torch.int8, device=dev)
    z64 = torch.zeros((64, 64), dtype=torch.int64, device=dev)
    refuses("i8_gemm of int64", lambda: ND.i8_gemm(z64, z64))
    refuses("i8_gemm of 48 columns", lambda: ND.i8_gemm(z8, z8[:, :48].contiguous()))
    refuses("gl_digits of 48 rows, k-major", lambda: ND.gl_digits(z64[:48].contiguous()))
    refuses("digit_dft with m = 16", lambda: ND.digit_dft(z64[:16].contiguous(), ND.w_digits(4, False, 1, dev), elements=True))
    refuses("digit_dft_last of a CPU table", lambda: ND.digit_dft_last(z64, torch.zeros((1, 64, 8, 64), dtype=torch.int8)))
    log("[kernels] K8-K11 refuse a wrong dtype, shapes the kernels do not take, and operands on two devices")
    # the digit tables (134 MB of folded table at 2^23) are no part of a prove:
    # drop them, so that the prove phase's peak device memory is the prove's
    ND._tables.clear()


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def _sass_functions(cuobjdump: str, binary: str):
    """(whole text, {function: [(address, opcode, operands), ...]}) of a cubin or library."""
    text = subprocess.run([cuobjdump, "-sass", binary], capture_output=True, text=True, check=True).stdout
    funcs = {}
    for chunk in text.split("Function : ")[1:]:
        # an anonymous namespace's name carries a hash of the file's path: dropped
        name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_", "_GLOBAL__N_", chunk.split()[0])
        funcs[name] = [(int(a, 16), op, rest) for a, op, rest in _SASS_LINE.findall(chunk)]
    return text, funcs


def _sass_sha(ins) -> str:
    """sha256 of a function's instructions (address, opcode, operands), as text."""
    return hashlib.sha256(repr(ins).encode()).hexdigest()


def _pipe(op: str) -> str:
    """The issue pipe of an integer instruction on sm_90: multiply-add family or ALU."""
    return "imad" if op.startswith(("IMAD", "UIMAD")) else "alu"


def phase_sass(state) -> None:
    """Count the machine instructions that the operation bounds rest on.

    1. Compiles ops/csrc/gl_probe.cu (one Goldilocks primitive per kernel),
       disassembles it and prints, for mul, add and sub, the instructions
       beyond those of the base probe, split by issue pipe.
    2. Disassembles the built kernel library: the whole `cuobjdump -sass`
       text goes to chiprun_out/sass/kernels.sass, and the opcode histogram
       of every kernel and of every loop in it (a backward branch and the
       instructions it spans) to chiprun_out/sass/loops.txt."""
    from sezkp_tpu_torch.ops import _kernels

    nvcc = _kernels._find_nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    os.makedirs("chiprun_out/sass", exist_ok=True)
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True).stdout.strip().splitlines()[-2:]
    log("[sass] " + " | ".join(ver))

    cubin = os.path.join(_kernels._BUILD_DIR, "gl_probe.cubin")
    subprocess.run([nvcc, *_kernels._NVCC_FLAGS[:-2], "-I", _kernels._CSRC, "-cubin",
                    os.path.join(_kernels._CSRC, "gl_probe.cu"), "-o", cubin],
                   capture_output=True, text=True, check=True)
    text, probes = _sass_functions(cuobjdump, cubin)
    with open("chiprun_out/sass/gl_probe.sass", "w") as f:
        f.write(text)
    base = Counter(op for _, op, _ in probes["probe_base"])
    counts = {}
    for prim in ("mul", "add", "sub"):
        extra = Counter(op for _, op, _ in probes["probe_" + prim])
        extra.subtract(base)
        extra["LOP3.LUT"] += base["LOP3.LUT"]  # the base's own xor is not indexing
        extra = {op: c for op, c in extra.items() if c and op not in ("NOP", "BRA")}
        pipes = Counter()
        for op, c in extra.items():
            pipes[_pipe(op)] += c
        counts[prim] = dict(pipes)
        log(f"[sass] gl::{prim}: {json.dumps(dict(pipes))} from {json.dumps(extra)}")
    log("[sass] primitive counts: " + json.dumps(counts))

    text, funcs = _sass_functions(cuobjdump, _kernels.build())
    with open("chiprun_out/sass/kernels.sass", "w") as f:
        f.write(text)
    out = ["# " + " | ".join(ver)]
    for name, ins in funcs.items():
        hist = Counter(op for _, op, _ in ins)
        pipes = Counter(_pipe(op) for _, op, _ in ins)
        out.append(f"== {name}: {len(ins)} instructions, imad-family {pipes['imad']}, "
                   f"sha256 {_sass_sha(ins)}")
        out.append("   all: " + json.dumps(hist.most_common()))
        for addr, op, rest in ins:
            m = re.search(r"0x([0-9a-f]+)\s*$", rest.strip())
            if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                body = [o for a, o, _ in ins if lo <= a <= addr]
                out.append(f"   loop 0x{lo:04x}..0x{addr:04x}: {len(body)} instructions "
                           + json.dumps(Counter(body).most_common()))
    with open("chiprun_out/sass/loops.txt", "w") as f:
        f.write("\n".join(out) + "\n")
    for line in out:
        if line.startswith("=="):
            log("[sass] " + line)
    log("[sass] full text and loop histograms under chiprun_out/sass/")

    # the same kernels built from another checkout's sources (--sass-csrc):
    # which functions compile to the same machine code, instruction for instruction
    other = state.get("sass_csrc")
    if other:
        for src in _kernels._SOURCES:
            if not os.path.exists(os.path.join(other, src)):
                log(f"[sass] {other} has no {src}")
                continue
            cubin = os.path.join(_kernels._BUILD_DIR, f"other_{src}.cubin")
            subprocess.run([nvcc, *_kernels._NVCC_FLAGS[:-2], "-I", other, "-cubin",
                            os.path.join(other, src), "-o", cubin],
                           capture_output=True, text=True, check=True)
            for name, ins in _sass_functions(cuobjdump, cubin)[1].items():
                same = name in funcs and _sass_sha(ins) == _sass_sha(funcs[name])
                log(f"[sass] {other}/{src} {name}: {len(ins)} instructions, sha256 {_sass_sha(ins)}: "
                    + ("identical to this checkout's" if same else
                       "DIFFERS from this checkout's" if name in funcs else "not in this checkout"))


def _to_u64(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy().view(np.uint64)


def _probe_wrappers():
    from sezkp_tpu_torch.ops import ntt_digits_torch as ND

    return {"i8_gemm": ND.i8_gemm, "gl_digits": ND.gl_digits, "digit_dft": ND.digit_dft,
            "digit_dft_last": ND.digit_dft_last}


def _wrappers():
    from sezkp_tpu_torch.ops import blake3_torch as BT
    from sezkp_tpu_torch.ops import ntt_torch as NT

    return {
        "blake3_compress": BT.compress,
        "blake3_chain": BT.hash_many_words,
        "ntt_phase_axis": NT.phase_axis,
        "ntt_phase_batched": NT.phase_batched,
        "ntt_phase_last": NT.phase_last,
        "ntt_small_cols": NT.small_cols,
        "ntt_small_rows": NT.small_rows,
    }


def _make_input(t: int, b: int, tau: int):
    from sezkp_tpu_torch.commit.merkle import commit_blocks
    from sezkp_tpu_torch.trace.generator import generate_trace
    from sezkp_tpu_torch.trace.partition import partition_trace

    t0 = time.time()
    blocks = partition_trace(generate_trace(t, tau), b)
    man = commit_blocks(blocks)
    return blocks, man, time.time() - t0


def _tamper(art, pos=None):
    """The artifact with one bit flipped at byte `pos` (default: the middle)."""
    from sezkp_tpu_torch.core.artifact import ProofArtifact

    pb = bytearray(art.proof_bytes)
    pb[len(pb) // 2 if pos is None else pos] ^= 0x01
    return ProofArtifact(
        backend=art.backend, manifest_root=art.manifest_root, proof_bytes=bytes(pb), meta=art.meta
    )


HOST_COLUMNS = dict(device_cols_min=1 << 62)  # the other route: columns and composition in numpy
HOST_HASHED = dict(device_hash_min=0)  # the fold prove with every batch on the host hasher


def _counted_prove(blocks, root, **options):
    """One prove with every kernel's launch count set to 0 just before and
    read just after: (artifact, wall s, stage s, launches, peak bytes)."""
    from sezkp_tpu_torch.stark.backends import StarkV1

    wrappers = _wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    timings = {}
    t0 = time.time()
    art = StarkV1.prove(blocks, root, timings=timings, **options)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    return art, wall, timings, launches, torch.cuda.max_memory_allocated()


def _stages(timings) -> str:
    return json.dumps({k: round(v, 3) for k, v in timings.items()})


def _sha(art) -> str:
    return hashlib.sha256(art.proof_bytes).hexdigest()


def phase_prove(state) -> None:
    from sezkp_tpu_torch.stark.backends import StarkV1

    t_log2, b, tau = 20, 512, 8
    blocks, man, t_in = _make_input(1 << t_log2, b, tau)
    log(f"[prove] T = 2^{t_log2}, b = {b}, tau = {tau}: {len(blocks)} blocks, input made in {t_in:.1f} s")

    art, wall, timings, launches, peak = _counted_prove(blocks, man.root)
    state["launches"] = launches
    log(f"[prove] device-resident route, first prove wall {wall:.2f} s; stages (s): {_stages(timings)}")
    log(f"[prove] peak device memory {peak} bytes; proof {len(art.proof_bytes)} bytes; launches {json.dumps(launches)}")
    if "device_compose" not in timings:
        fail("the prove did not take the device-resident route")
    for k in ("blake3_compress", "ntt_phase_axis", "ntt_phase_batched", "ntt_phase_last"):
        if launches[k] <= 0:
            fail(f"kernel {k} was never launched by the prove")

    t0 = time.time()
    StarkV1.verify(art, blocks, man.root)
    log(f"[prove] verify OK in {time.time() - t0:.2f} s")

    try:
        StarkV1.verify(_tamper(art), blocks, man.root)
    except Exception as e:  # the verifier's rejection is what this step wants
        log(f"[prove] tampered proof rejected: {type(e).__name__}: {str(e)[:80]}")
    else:
        fail("tampered proof was accepted")

    art2, wall2, timings2, _, peak2 = _counted_prove(blocks, man.root)
    log(f"[prove] second prove (twiddle tables cached) wall {wall2:.2f} s; stages (s): {_stages(timings2)}")
    log(f"[prove] second prove peak device memory {peak2} bytes")
    log(f"[prove] sha256 {_sha(art)} / {_sha(art2)}")
    if art.proof_bytes != art2.proof_bytes:
        fail("two proves of the same input differ")

    del art2
    art3, wall3, timings3, launches3, peak3 = _counted_prove(blocks, man.root, **HOST_COLUMNS)
    log(f"[prove] host-columns route, one prove wall {wall3:.2f} s; stages (s): {_stages(timings3)}")
    log(f"[prove] host-columns route peak device memory {peak3} bytes; launches {json.dumps(launches3)}; "
        f"sha256 {_sha(art3)}")
    if "host_compose" not in timings3:
        fail("device_cols_min above n did not select the host-columns route")
    if art3.proof_bytes != art.proof_bytes:
        fail("the host-columns route and the device-resident route give different proofs")


def phase_parity_small(state) -> None:
    from sezkp_tpu_torch.stark.backends import StarkV1

    for t_log2 in (13, 15):
        blocks, man, _ = _make_input(1 << t_log2, 512, 8)
        on_card, _, timings, launches, _ = _counted_prove(blocks, man.root)
        if "device_compose" not in timings:
            fail(f"T = 2^{t_log2}: the prove did not take the device-resident route")
        on_cpu = StarkV1.prove(blocks, man.root, device="cpu")
        if on_card.proof_bytes != on_cpu.proof_bytes:
            fail(f"T = 2^{t_log2}: the proof made on the card differs from the proof made on the CPU")
        StarkV1.verify(on_card, blocks, man.root)
        log(f"[parity-small] T = 2^{t_log2}: card and CPU proofs byte-identical "
            f"(sha256 {_sha(on_card)}); launches {json.dumps(launches)}")
        if t_log2 == 13:
            state["launches_small"] = launches
            if launches["ntt_small_cols"] != 1 or launches["ntt_small_rows"] != 1:
                fail("T = 2^13: K5 and K6 must launch once each (the base inverse NTT)")

    blocks, man, _ = _make_input(1 << 16, 512, 8)
    resident, _, _, _, peak = _counted_prove(blocks, man.root)
    for what, options in (
        ("roots-scan commit, range-derived openings, slab-wise composition",
         dict(cv_budget_bytes=0, release_planes_bytes=0, compose_scan_min_log2=0)),
        ("roots-scan commit, openings recomputed from the resident matrix",
         dict(cv_budget_bytes=0)),
    ):
        lean, _, _, _, peak_lean = _counted_prove(blocks, man.root, **options)
        if lean.proof_bytes != resident.proof_bytes:
            fail(f"T = 2^16: the prove with {what} differs from the resident prove")
        log(f"[parity-small] T = 2^16: {what}: byte-identical to the resident prove "
            f"(peak device memory {peak_lean} against {peak} bytes)")


def _counted_fold_prove(blocks, root, **options):
    """One balanced FoldBackend.prove with every kernel's launch count set to 0
    just before and read just after: (artifact, wall s, stage s, launches)."""
    from sezkp_tpu_torch.stark.backends import FoldBackend

    wrappers = _wrappers()
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    timings = {}
    t0 = time.time()
    art = FoldBackend.prove(blocks, root, timings=timings, **options)
    torch.cuda.synchronize()
    wall = time.time() - t0
    return art, wall, timings, {k: w.launches for k, w in wrappers.items()}


def _median_ms(fn, reps: int = 5) -> float:
    """Median host-clock milliseconds of fn() (which ends synchronised), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[reps // 2] * 1e3


CROSSOVER_N_LOG2 = (4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18)


def phase_crossover(state) -> None:
    """Host hash_many against hash_many_device end to end (upload, pad and
    transpose on the card, K7, download) and the device path's three parts, each the
    median of five runs on the host's clock."""
    from sezkp_tpu_torch.crypto import blake3 as host_b3
    from sezkp_tpu_torch.ops import blake3_torch as BT

    dev = torch.device("cuda")
    rng = np.random.default_rng(99)
    rows = []
    for length in (71, 124, 320, 813):
        for n_log2 in CROSSOVER_N_LOG2:
            msgs = rng.integers(0, 256, (1 << n_log2, length), dtype=np.uint8)
            if not np.array_equal(BT.hash_many_device(msgs), host_b3.hash_many(msgs)):
                fail(f"hash_many_device != host hash_many at L={length} N=2^{n_log2}")

            def upload():
                planes = BT.messages_to_planes(msgs, dev)
                torch.cuda.synchronize()
                return planes

            planes = upload()
            out = torch.empty((8, 1 << n_log2), dtype=torch.int32, device=dev)

            def kernel():
                BT.hash_many_words(planes, length, out=out)
                torch.cuda.synchronize()

            row = dict(
                L=length, N_log2=n_log2,
                host_ms=_median_ms(lambda: host_b3.hash_many(msgs)),
                device_ms=_median_ms(lambda: BT.hash_many_device(msgs)),
                upload_pad_transpose_ms=_median_ms(upload),
                kernel_sync_ms=_median_ms(kernel),
                download_ms=_median_ms(lambda: BT.cv_planes_to_bytes(out)),
            )
            rows.append(row)
            log("[crossover] " + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                                                  for k, v in row.items()}))
    # the smallest batch size from which the card won at every length and at
    # every larger size measured: what fold/devhash.DEVICE_HASH_MIN rests on
    wins = {n: all(r["device_ms"] < r["host_ms"] for r in rows if r["N_log2"] == n)
            for n in CROSSOVER_N_LOG2}
    from_log2 = next((n for i, n in enumerate(CROSSOVER_N_LOG2)
                      if all(wins[m] for m in CROSSOVER_N_LOG2[i:])), None)
    from sezkp_tpu_torch.fold.devhash import DEVICE_HASH_MIN

    log(f"[crossover] the card wins at every length at N = 2^k for k in "
        f"{[n for n in CROSSOVER_N_LOG2 if wins[n]]}; at every length and every larger size from "
        f"N = {None if from_log2 is None else 1 << from_log2}; DEVICE_HASH_MIN is {DEVICE_HASH_MIN}")
    state["crossover"] = rows


def phase_fold(state) -> None:
    import tempfile

    from sezkp_tpu_torch.core.prover import StreamingProver
    from sezkp_tpu_torch.fold.verify import verify_stream
    from sezkp_tpu_torch.stark.backends import FoldBackend
    from sezkp_tpu_torch.utils import cbor

    log(f"[fold] CBOR codec: {'native extension' if cbor.native() is not None else 'pure Python'}")
    wrappers = _wrappers()
    state["launches_fold"] = {}
    for t_log2, b, tau in ((22, 64, 2), (20, 512, 8)):
        what = f"T = 2^{t_log2}, b = {b}, tau = {tau}"
        blocks, man, t_in = _make_input(1 << t_log2, b, tau)
        log(f"[fold] {what}: {len(blocks)} blocks, input made in {t_in:.1f} s")
        arts = []
        # in turns on one card: the call as a user makes it (the card, from
        # the default threshold up), host, host, default, and every batch on the card
        # at 65536 blocks once each: default, host, every batch on the card
        turns = (({}, HOST_HASHED, dict(device_hash_min=1)) if len(blocks) > 2048 else
                 ({}, HOST_HASHED, HOST_HASHED, {}, dict(device_hash_min=1)))
        for options in turns:
            art, wall, timings, launches = _counted_fold_prove(blocks, man.root, **options)
            where = ("host (device_hash_min=0)" if options is HOST_HASHED else
                     "card (K7), every batch (device_hash_min=1)" if options else
                     "card (K7), default call")
            log(f"[fold] {what}: balanced prove, MAC batches hashed on the {where}: wall {wall:.2f} s; "
                f"stages {_stages(timings)}; host assembly {timings['pipeline'] - timings['hash']:.3f} s; "
                f"K7 launches {launches['blake3_chain']}; sha256 {_sha(art)}")
            if options is not HOST_HASHED and launches["blake3_chain"] <= 0:
                fail(f"{what}: the device-hashed prove never launched K7")
            if options is HOST_HASHED and launches["blake3_chain"] != 0:
                fail(f"{what}: the host-hashed prove launched K7")
            if not arts:
                # the count reported for this path is the first default prove's
                state["launches_fold"][what] = launches["blake3_chain"]
            arts.append(art)
        if any(a.proof_bytes != arts[0].proof_bytes for a in arts):
            fail(f"{what}: device-hashed and host-hashed proofs differ")
        if arts[0].manifest_root != man.root:
            fail(f"{what}: the fold root is not the manifest root")
        log(f"[fold] {what}: {len(arts)} proofs byte-identical, {len(arts[0].proof_bytes)} bytes")

        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        FoldBackend.verify(arts[0], [], man.root)
        log(f"[fold] {what}: verify OK in {time.time() - t0:.2f} s; "
            f"K7 launches during verify {wrappers['blake3_chain'].launches}")
        if wrappers["blake3_chain"].launches != 0:
            fail(f"{what}: the verifier launched K7")
        # one flipped bit in the middle of the bundle, and one in the root
        # commitment that follows it in the envelope
        for where, pos in (("the bundle", None), ("the envelope's root", -60)):
            try:
                FoldBackend.verify(_tamper(arts[0], pos), [], man.root)
            except Exception as e:  # the verifier's rejection is what this step wants
                log(f"[fold] {what}: proof tampered in {where} rejected: "
                    f"{type(e).__name__}: {str(e)[:80]}")
            else:
                fail(f"{what}: a proof tampered in {where} was accepted")
        del arts[1:]

    # the streamed path, at the smaller input (the last one made above)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "proof.cborseq")
        os.environ["SEZKP_PROOF_STREAM_PATH"] = path
        for w in wrappers.values():
            w.launches = 0
        try:
            sp = StreamingProver(FoldBackend)
            t0 = time.time()
            streamed = sp.prove_stream_iter(iter(blocks), man.root)
            t1 = time.time()
            sp.verify_stream_iter(streamed, iter(blocks), man.root)
            t2 = time.time()
        finally:
            del os.environ["SEZKP_PROOF_STREAM_PATH"]
        with open(path, "rb") as f:
            data = bytearray(f.read())
    if streamed.manifest_root != arts[0].manifest_root:
        fail("the streamed prove's root differs from the batched prove's")
    if wrappers["blake3_chain"].launches != 0:
        fail("the streamed path launched K7")
    data[len(data) // 2] ^= 0x01
    try:
        verify_stream(bytes(data))
    except Exception as e:  # the verifier's rejection is what this step wants
        log(f"[fold] tampered stream rejected: {type(e).__name__}: {str(e)[:80]}")
    else:
        fail("tampered stream was accepted")
    log(f"[fold] {what}: streamed prove {t1 - t0:.2f} s into a {len(data)}-byte .cborseq, "
        f"verify_stream OK in {t2 - t1:.2f} s, root equals the batched prove's; no K7 launch")


def phase_probes(state) -> None:
    """The four probe mains as a user runs them, on the card at full width.
    Every kernel's launch count is set to 0 just before and read just after."""
    from sezkp_tpu_torch.probes import mxu_peak, ntt_breakdown, profile_ntt, twiddle_fold_ab

    wrappers = {**_wrappers(), **_probe_wrappers()}
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    trace_dir = os.path.join("chiprun_out", "trace_ntt")
    for name, main, argv in (
        ("mxu_peak", mxu_peak.main, []),
        ("ntt_breakdown", ntt_breakdown.main, ["--k", "23", "--tile", "512"]),
        ("twiddle_fold_ab", twiddle_fold_ab.main, ["--k", "23"]),
        ("profile_ntt", profile_ntt.main, ["--k", "23", "--trace", trace_dir]),
    ):
        log(f"[probes] python -m sezkp_tpu_torch.probes.{name} {' '.join(argv)}")
        t0 = time.time()
        rc = main(argv)
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"probe {name} exited with {rc}")
        log(f"[probes] {name} ok in {time.time() - t0:.1f} s")
        torch.cuda.empty_cache()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"[probes] launches {json.dumps(launches)}")
    for k in _probe_wrappers():
        if launches[k] <= 0:
            fail(f"kernel {k} was never launched by the probes")
    state["launches_probes"] = launches


def phase_cli(state) -> None:
    """The command line end to end, as `python -m sezkp_tpu_torch` runs it (no
    --device: the card), against the in-process backends on the same input."""
    import tempfile

    from sezkp_tpu_torch import cli
    from sezkp_tpu_torch.commit.merkle import read_manifest_auto
    from sezkp_tpu_torch.core import io as core_io
    from sezkp_tpu_torch.stark.backends import FoldBackend

    wrappers = _wrappers()

    def run(argv, want_launches=None):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        if rc not in (0, None):
            fail(f"cli {' '.join(argv[:3])} returned {rc}")
        launches = {k: w.launches for k, w in wrappers.items()}
        log(f"[cli] {' '.join(argv[:3])}: {time.time() - t0:.2f} s; launches {json.dumps(launches)}")
        return launches

    def rejected(argv, what):
        # a verifier rejects with ValueError (the CBOR decoder's and
        # ReplayError are ValueErrors) or AssertionError, and a flipped byte
        # that changes a field's type or key fails in the decoding of the
        # artifact (TypeError, KeyError, IndexError). A missing file
        # (OSError), a CUDA fault or any other crash is no rejection and
        # ends the run
        if not os.path.isfile(argv[-1]):
            fail(f"{what}: {argv[-1]} was not written")
        try:
            cli.main(argv)
        except (ValueError, AssertionError, TypeError, KeyError, IndexError) as e:
            log(f"[cli] {what} rejected: {type(e).__name__}: {str(e)[:80]}")
        else:
            fail(f"{what} was accepted")

    def flipped(path, out):
        with open(path, "rb") as f:
            data = bytearray(f.read())
        data[len(data) // 2] ^= 0x40
        with open(out, "wb") as f:
            f.write(bytes(data))

    with tempfile.TemporaryDirectory() as tmp:
        j = lambda name: os.path.join(tmp, name)
        blocks_p, man_p = j("blocks.cbor"), j("manifest.cbor")
        common = ["--blocks", blocks_p, "--manifest", man_p]
        # after the STARK prove and verify have checked the blocks file against
        # the manifest, the later commands skip that pass over the file
        assumed = [*common, "--assume-committed"]
        run(["simulate", "--t", str(1 << 20), "--b", "512", "--tau", "8", "--out-blocks", blocks_p])
        run(["commit", "--blocks", blocks_p, "--out", man_p])
        run(["verify-commit", "--blocks", blocks_p, "--manifest", man_p])

        stark_launches = run(["prove", "--backend", "stark", *common, "--out", j("stark.cbor")])
        run(["verify", "--backend", "stark", *common, "--proof", j("stark.cbor")])
        flipped(j("stark.cbor"), j("stark_bad.cbor"))
        rejected(["verify", "--backend", "stark", *assumed, "--proof", j("stark_bad.cbor")], "a flipped STARK proof file")

        fold_launches = run(["prove", "--backend", "fold", *assumed, "--out", j("fold.cbor")])
        run(["verify", "--backend", "fold", *assumed, "--proof", j("fold.cbor")])
        flipped(j("fold.cbor"), j("fold_bad.cbor"))
        rejected(["verify", "--backend", "fold", *assumed, "--proof", j("fold_bad.cbor")], "a flipped fold proof file")

        stream_launches = run(["prove", "--backend", "fold", "--stream", "--fold-mode", "minram", *assumed,
                               "--out", j("stream.cbor")])
        run(["verify", "--backend", "fold", *assumed, "--proof", j("stream.cbor")])
        flipped(j("stream.cborseq"), j("stream.cborseq"))
        rejected(["verify", "--backend", "fold", *assumed, "--proof", j("stream.cbor")], "a flipped .cborseq stream")
        if any(stream_launches.values()):
            fail("the streamed minram prove launched a kernel")

        # the same blocks and root through the backends in this process
        blocks = core_io.read_block_summaries_auto(blocks_p)
        root = read_manifest_auto(man_p).root
        stark_file = core_io.read_proof_auto(j("stark.cbor"))
        fold_file = core_io.read_proof_auto(j("fold.cbor"))
    # the CLI set the fold mode for its last prove; the in-process prove is the balanced one
    from sezkp_tpu_torch.utils.config import ENV_KEYS

    for key in ENV_KEYS.values():
        os.environ.pop(key, None)
    art, _, _, launches, _ = _counted_prove(blocks, root)
    if art.proof_bytes != stark_file.proof_bytes:
        fail("the STARK proof in the file differs from the in-process StarkV1.prove")
    if launches != stark_launches:
        fail(f"launch counts of the CLI's STARK prove {stark_launches} differ from the in-process prove's {launches}")
    log(f"[cli] STARK proof file == in-process StarkV1.prove, sha256 {_sha(art)}; same launch counts")
    fart, _, _, flaunches = _counted_fold_prove(blocks, root)
    if fart.proof_bytes != fold_file.proof_bytes:
        fail("the fold proof in the file differs from the in-process FoldBackend.prove")
    if flaunches != fold_launches:
        fail(f"launch counts of the CLI's fold prove {fold_launches} differ from the in-process prove's {flaunches}")
    FoldBackend.verify(fold_file, [], root)
    log(f"[cli] fold proof file == in-process FoldBackend.prove, sha256 {_sha(fart)}; same launch counts "
        f"(K7 {flaunches['blake3_chain']})")
    state["launches_cli"] = {"stark": stark_launches, "fold": fold_launches}


def phase_prove_large(state) -> None:
    from sezkp_tpu_torch.stark.backends import StarkV1

    blocks, man, t_in = _make_input(1 << 22, 512, 8)
    log(f"[prove-large] T = 2^22, b = 512, tau = 8: {len(blocks)} blocks, input made in {t_in:.1f} s")
    art, wall, timings, launches, peak = _counted_prove(blocks, man.root)
    log(f"[prove-large] device-resident route, first prove wall {wall:.2f} s; stages (s): {_stages(timings)}")
    log(f"[prove-large] peak device memory {peak} bytes; proof {len(art.proof_bytes)} bytes; "
        f"launches {json.dumps(launches)}")
    art2, wall2, timings2, _, peak2 = _counted_prove(blocks, man.root)
    log(f"[prove-large] second prove (tables cached) wall {wall2:.2f} s; stages (s): {_stages(timings2)}; "
        f"peak device memory {peak2} bytes")
    if art2.proof_bytes != art.proof_bytes:
        fail("two proves of the same input differ")
    del art2
    t0 = time.time()
    StarkV1.verify(art, blocks, man.root)
    log(f"[prove-large] verify OK in {time.time() - t0:.2f} s")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of: " + ", ".join(ALL_PHASES + EXTRA_PHASES))
    ap.add_argument("--sass-csrc", default=None,
                    help="sass phase: the ops/csrc directory of another checkout to compare with")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES + EXTRA_PHASES:
            fail(f"unknown phase {p}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card only",
              file=sys.stderr)
        sys.exit(2)

    state = {"sass_csrc": args.sass_csrc}
    t_start = time.time()
    run = {"env": phase_env, "kernels": phase_kernels, "prove": phase_prove,
           "parity-small": phase_parity_small, "fold": phase_fold,
           "crossover": phase_crossover, "probes": phase_probes, "cli": phase_cli,
           "prove-large": phase_prove_large,
           "sass": phase_sass}
    if "env" not in phases:
        state["smi"] = nvidia_smi_line()
    for p in phases:
        t0 = time.time()
        run[p](state)
        log(f"[{p}] done in {time.time() - t0:.1f} s")

    kernels = []
    for name, k in state.get("kernels", {}).items():
        k = dict(k)
        # K1-K4: the count over the T = 2^20 STARK prove; K5/K6, which only a
        # base domain below 2^14 reaches: the count over the T = 2^13 prove;
        # K7: the count over the first default fold prove (65536
        # blocks), with the count per fold input beside it; K8-K11: the count
        # over the probes phase. Null when that phase was not asked for.
        if name in _probe_wrappers():
            k["launches"] = state["launches_probes"][name] if "launches_probes" in state else None
        elif name == "blake3_chain":
            per_input = state.get("launches_fold")
            k["launches"] = next(iter(per_input.values())) if per_input else None
            k["launches_by_input"] = per_input
        else:
            counted = "launches_small" if name.startswith("ntt_small") else "launches"
            k["launches"] = state[counted][name] if counted in state else None
        kernels.append(k)
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

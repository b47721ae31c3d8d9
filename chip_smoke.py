#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sezkp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, as below
    python3 chip_smoke.py --phases env,kernels  # a subset, while developing

Phases (any failure ends the run with a non-zero exit code):

  env           card name and power limit, versions; builds the native host
                library (g++) and the CUDA kernels (nvcc) from the sources in
                this checkout; ptxas's registers, spills and shared memory of
                K4, K5, K8-K11 and K12.
  kernels       every hand-written kernel against its plain PyTorch version
                on the card, exact equality (tolerance 0: integer code), at
                reduced and at main-path shapes; kernel, plain and bound times.
                K5 (one cluster launch a transform) at every n = 2^1 .. 2^13
                both ways, against its plain version and the host oracle,
                with the launch floor (an empty launch, one CTA and one
                cluster) timed beside it; K2-K4 at every
                m = 2^1 .. 2^10 both ways (K4 also with m1 = 3, below a
                block's vectors, and 37, odd and over several blocks). K2-K4 also at
                three-factor shapes that the port's own factorisation never
                picks (a last factor of 8 and of 32, a full-size phase-A
                table). K7 at twelve message lengths from 1 to 1024 bytes and
                batches from 1 to 1000003 messages, against its plain version
                and against the host hasher. K8-K11 (the digit form of the NTT
                phases on the tensor cores) at reduced shapes and at the
                probes' shapes: K8 also against torch._int_mm, K10 in all
                four (source, epilogue) combinations at seven shapes (m = 1024
                with 48 columns among them), with operands 8 bytes off a
                16-byte boundary and against an all -128 table, with elements
                in against K2 on the same input, the folded forward
                NTT (K2, K3, K11) against forward_ntt at 2^18, 2^20 and 2^23;
                K8 also at M, K, N that are multiples of 64 but not of its
                256 x 128 tile and 128-byte k chunk; K11 also at the edges of
                its tiles (one and three slices, 48 rows, last factors 32 and
                1024, an X 8 bytes off a 16-byte boundary); K10 and K11 timed
                issued and replayed from a CUDA graph. K12 (the DEEP divide)
                at 2^13 + 3 random points, over the LDE's coset at 2^20 and
                2^23 and at 2^27 points, z off the coset and on it, one
                launch a call; timed at 2^23 and 2^27. K13 (the chunk roots
                of whole columns) at the shapes of a prove (the 59 columns of
                T = 2^20 with their leaf CVs, of T = 2^24 roots only, a FRI
                layer of 2^27) against its plain version, the eager
                composition on K1, and at both chunk depths it takes, with a
                row selection and rows 8 bytes off a 16-byte boundary,
                against its schedule in tensor code; timed beside its bound,
                the plain tensor code and the eager composition.
  prove         T = 2^20, b = 512, tau = 8 on the device-resident route:
                generate_trace -> partition_trace -> commit_blocks ->
                StarkV1.prove (on the card) -> StarkV1.verify; a tampered
                proof is rejected; a second prove is byte-identical; the
                launch counts of K1-K4 over the prove are > 0, K12's is
                1 and K13's one for the columns' commitment and one for
                each chunked FRI layer; wall time per
                stage and peak device memory. Then one prove on the
                host-columns route, whose bytes must be the same, and one
                with the chunked tops-only FRI forced
                (fri_chunked_min_log2=23, the LDE's size), whose sha256 must
                be the known one.
  parity-small  device-resident route: the proof made on the card equals,
                byte for byte, the proof made with device="cpu" at T = 2^13
                (where K5 must have launched exactly once) and T = 2^15, and
                so do StarkV1.prove_streaming on the card and on the CPU;
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
                --backend stark --stream -> verify (the two proves in a child
                process each: stages, K1-K4 launches, peak device memory and
                peak host RSS, sampled); prove
                --backend fold -> verify; prove --backend fold --stream
                --fold-mode minram -> verify; a proof file with one flipped
                byte is rejected; the proof bytes in the files equal those of
                the in-process StarkV1.prove / FoldBackend.prove on the same
                blocks and root, and so do the launch counts of K1-K7; the
                streamed STARK proof has the resident proof's sha256.
  sharded       parallel/ on torch.distributed, each rank a child process of
                this script (--rank-child) with the SEZKP_* variables set:
                worlds of 1 rank (NCCL), 2 and 4 ranks sharing the card
                (gloo; their times are correctness runs, not scaling
                figures) and, where the host has several cards, one rank a
                card (NCCL). In each world, on every rank: the sharded NTT of
                2^26 points (n1 = n2 = 2^13) both ways equals the single-card
                forward_ntt / inverse_ntt (sha256 of the whole result), K2 and
                K3 launched, wall ms (median of 3) and the all-to-all's ms;
                the sharded Merkle root of 2^23 values equals the single-card
                and the host root; prove_v1_sharded(commitments_only=True)
                at T = 2^18, b = 512, tau = 8 equals the single-process
                prove, K1-K4 launched; the fully sharded prove_v1_sharded
                (the default) at T = 2^20, b = 512, tau = 8 has the known
                sha256 (the single-process proof verifies, a tampered copy
                is rejected), K1-K3 launched, its collective bytes by scope
                equal traffic.analytic_phase_bytes' terms; stage seconds and
                peak device memory of each prove. In one world (every card,
                NCCL, where there are several; else the world of one rank)
                the fully sharded prove at T = 2^23 (scripts/
                northstar_sharded.py's shape) equals rank 0's single-card
                StarkV1.prove of the same input, which has the known sha256.
                Beside them:
                commit_block_file_sharded of the input's 2048-block JSONL file
                at 1, 2, 3, 5 hosts equals commit_block_file, and the CLI's
                prove --backend stark as two ranks sharing the card
                (SEZKP_DIST_BACKEND=gloo) writes, on each rank, the
                single-process file.
  prove-large   T = 2^24, b = 512, tau = 8 (LDE 2^27) on the device-resident
                route: a prove on the default FRI threshold (the chunked
                tops-only FRI, which must be seen to run), verify, a
                tampered proof rejected, a prove with the resident FRI
                forced and one with the chunked FRI forced, all
                byte-identical; for each prove stage seconds, peak device
                memory, K1-K4 launches, proof bytes and sha256. Then FRI
                alone on the LDE's domain in both modes (wall, peak device
                memory above its input, equal roots and queries). Other sizes
                and proves on request: --large-t 22,23 --large-modes
                default,resident,chunked,release (release: the default with
                the column matrix dropped before the LDE).
  sass          only when asked for (--phases env,sass): disassembles the
                built kernels and a one-primitive probe and prints the
                instruction counts, by issue pipe, that the operation bounds
                of the kernels phase rest on, with a sha256 of each kernel's
                instructions, K4's instructions per element by pipe, K5's
                registers, spills and instruction mix at every n, and K8's,
                K10's and K11's registers, spills and shared memory, K12's
                instructions over its points, loops and registers; the
                text goes to chiprun_out/sass/. With
                --sass-csrc DIR (the ops/csrc of another checkout) it builds
                those sources too and says which kernels are the same code.

Output: progress lines, then one JSON line {"kernels": [...]} with one entry
per kernel, then the card's name and power limit, then as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import gzip
import hashlib
import json
import os
import re
import subprocess
import sys
import threading
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
# The bound of K2/K3's design rests on these (ntt_torch.pass_counts), counted
# the same way: gl::neg; gl::mul_pow2 with a constant exponent by shift range
# (s <= 32: no bits above 95; 32 < s < 64; s >= 64: no bits below 64);
# gl::bfly, (u + t, u - t); gl::mul_cc, the passes' general product.
GL_NEG_OPS = (0, 6)
GL_MULPOW2_OPS = {"lo": (4, 13), "mid": (6, 17), "hi": (7, 19)}
GL_BFLY_OPS = (2, 10)
GL_MULCC_OPS = (13, 18)


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

ALL_PHASES = ("env", "kernels", "prove", "parity-small", "fold", "crossover", "probes", "cli",
              "sharded", "prove-large")
# run only when asked for: the disassembly that the operation counts are read from
EXTRA_PHASES = ("sass",)


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
    # ptxas's registers, spills and shared memory of K4, K5, K8-K11, built beside the library
    ptxas = _ptxas_start(("ntt_last.cu", "ntt_small.cu", "i8_gemm.cu", "gl_digits.cu", "digit_dft.cu",
                          "digit_dft_last.cu", "deep_divide.cu", "blake3_chunk_roots.cu"))
    _kernels.lib()
    log(f"[env] set-up: native host lib {t1 - t0:.1f} s, CUDA kernels {_kernels.build_seconds:.1f} s")
    for func, usage in sorted(_ptxas_usage(ptxas)[1].items()):
        log(f"[env] ptxas {func}: {' | '.join(usage)}")


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


def _kernel_chunk_roots(kern, gen, dev) -> None:
    """K13 blake3_chunk_roots against its plain version (the eager
    composition on K1, which the prove ran before K13) on the same tensors at
    the shapes of a prove: the 59 columns of T = 2^20 with their leaf CVs
    (chunk 2^10), the 59 of T = 2^24 roots only, a FRI layer of 2^27 (chunk
    2^11, the empty prefix); and against its schedule in tensor code
    (chunk_roots_model) at both chunk depths it takes, with a row selection,
    with and without CVs, on rows 16-byte aligned and 8 bytes off. Timed
    beside its bound, the plain tensor code (at T = 2^20) and the eager
    composition."""
    from sezkp_tpu_torch.ops import blake3_torch as BT
    from sezkp_tpu_torch.stark.v1.columns import all_labels
    from sezkp_tpu_torch.stark.v1.openings import _label_prefix

    labels = [_label_prefix(lb) for lb in all_labels(8)]
    err = 0

    def compare(got, want, what):
        nonlocal err
        torch.cuda.synchronize()
        err = max(err, max_abs_diff(got, want))
        if err:
            fail(f"K13 blake3_chunk_roots != {what}: max |difference| {err}")

    def launch(vals, prefixes, depth, idx=None, cvs=None):
        before = BT.chunk_roots.launches
        roots = BT.chunk_roots(vals, prefixes, depth, idx, cvs=cvs)
        if BT.chunk_roots.launches != before + 1:
            fail("K13 blake3_chunk_roots: a call must launch once")
        return roots

    # both depths, a selection (a row twice), aligned rows and rows 8 B off
    aligned = _field_rand((8, 1 << 13), gen, dev)
    off = torch.empty((8, (1 << 13) + 1), dtype=torch.int64, device=dev)[:, 1:]
    off.copy_(aligned)
    pick = [labels[i] for i in (0, 3, 17, 58, 5)]  # prefix lengths 21, 19, 18, 16, 20
    idx = [7, 0, 3, 3, 6]
    for depth in BT.CHUNK_ROOTS_LOG2:
        want_cvs = torch.empty((5, 8, 1 << 13), dtype=torch.int32, device=dev)
        want = BT.chunk_roots_model(aligned, pick, depth, idx, cvs=want_cvs)
        for vals in (aligned, off):
            cvs = torch.empty_like(want_cvs)
            compare(launch(vals, pick, depth, idx, cvs=cvs), want, f"its model at depth {depth}")
            compare(cvs, want_cvs, f"its model's leaf CVs at depth {depth}")
            compare(launch(vals, pick, depth, idx), want, f"its model, roots only, at depth {depth}")
        compare(launch(aligned[:1], [b""], depth), BT.chunk_roots_model(aligned[:1], [b""], depth),
                f"its model with the empty prefix at depth {depth}")
    del aligned, off

    timed = {}
    for shape, (rows, n_log2, depth, with_cvs) in (
        ("t20", (59, 20, 10, True)), ("t24", (59, 24, 10, False)), ("fri27", (1, 27, 11, False)),
    ):
        n = 1 << n_log2
        vals = _field_rand((rows, n), gen, dev)
        prefixes = labels if rows == 59 else [b""]
        cvs = torch.empty((rows, 8, n), dtype=torch.int32, device=dev) if with_cvs else None
        want_cvs = torch.empty_like(cvs) if with_cvs else None
        got = launch(vals, prefixes, depth, cvs=cvs)
        want = BT.chunk_roots_plain(vals, prefixes, depth, cvs=want_cvs)
        compare(got, want, f"plain at {shape}")
        if with_cvs:
            compare(cvs, want_cvs, f"plain's leaf CVs at {shape}")
        # a leaf: its compression and (2^L - 1) / 2^L of a parent's; 8 B read
        # and, with the CVs, 32 B written
        leaves = rows * n
        b_ops = ops_ms(leaves, tuple((2 - 2.0 ** -depth) * o for o in B3_OPS))
        b_bytes = leaves * (8 + (32 if with_cvs else 0) + 32.0 / (1 << depth)) / _peaks()[0] * 1e3
        timed[shape] = dict(
            shape=f"int64 [{rows}, 2^{n_log2}] -> roots [{rows}, 8, 2^{n_log2 - depth}]"
                  + (f" + CVs [{rows}, 8, 2^{n_log2}]" if with_cvs else ""),
            ms=time_cuda(lambda: BT.chunk_roots(vals, prefixes, depth, cvs=cvs), 5),
            eager_ms=time_cuda(lambda: BT.chunk_roots_plain(vals, prefixes, depth, cvs=want_cvs), 1),
            plain_ms=time_cuda(lambda: BT.chunk_roots_model(vals, prefixes, depth, cvs=want_cvs), 1)
            if shape == "t20" else None,
            bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
            bytes_ms=b_bytes, operations_ms=b_ops)
        del vals, cvs, want_cvs, got, want
        torch.cuda.empty_cache()
    kern["blake3_chunk_roots"] = dict(
        name="blake3_chunk_roots", route="cuda", source="sezkp_tpu_torch/ops/csrc/blake3_chunk_roots.cu",
        replaces="none: the eager message assembly, K1 and level gathers (blake3_jax.columns_commit_* "
                 "under jit in the JAX package)",
        max_abs_err=err, **timed["t20"], library_ms=None, at_t24=timed["t24"], at_fri27=timed["fri27"])
    log(f"[kernels] K13 blake3_chunk_roots == its model at chunk depths {BT.CHUNK_ROOTS_LOG2} (aligned "
        "and 8 B off, a selection, with and without CVs, the empty prefix) and == plain at the prove's shapes: "
        + "; ".join(f"{k}: {t['ms']:.3f} ms (bound {t['bound_ms']:.3f}, {t['bound_by']}; eager "
                    f"{t['eager_ms']:.1f} ms)" for k, t in timed.items())
        + f"; plain tensor code {timed['t20']['plain_ms']:.1f} ms at t20")


def phase_kernels(state) -> None:
    from sezkp_tpu_torch.ops import _kernels
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
        """The radix-2 bound of K2-K4's first design (their bound_radix2_ms):
        a phase reads and writes each element once (16 B) and its tables
        once; an element takes m_log2 / 2 butterflies (mul, add, sub) and
        `twiddles` further multiplies."""
        b_bytes = (16 * n_el + 8 * table_el) / _peaks()[0] * 1e3
        per_el = tuple(m_log2 * (mu + ad + su) / 2 + twiddles * mu
                       for mu, ad, su in zip(GL_MUL_OPS, GL_ADD_OPS, GL_SUB_OPS))
        b_ops = ops_ms(n_el, per_el)
        return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")

    def design_ops(m_log2, inverse, **plan):
        """(multiply-add, ALU) instructions an element of a length-2^m_log2
        DFT in the register-pass design (ntt_torch.pass_counts with `plan`:
        general products gl::mul_cc, the butterflies gl::bfly, mul_pow2 by
        shift range, neg)."""
        c = NT.pass_counts(m_log2, inverse, **plan)
        return tuple(
            (c.get("mul", 0) * GL_MULCC_OPS[i] + c.get("bfly", 0) * GL_BFLY_OPS[i] + c.get("neg", 0) * GL_NEG_OPS[i]
             + sum(c.get("pow2_" + r, 0) * GL_MULPOW2_OPS[r][i] for r in GL_MULPOW2_OPS)) / (1 << m_log2)
            for i in (0, 1))

    def bound_design(n_el, m_log2, inverse, twiddles, table_el):
        """The bound of K2-K4's register-pass design: the same bytes; per
        element the operations of its pass schedule (design_ops) plus
        `twiddles` general products (the fused tables and the scale)."""
        b_bytes = (16 * n_el + 8 * table_el) / _peaks()[0] * 1e3
        per_el = tuple(o + twiddles * mc for o, mc in zip(design_ops(m_log2, inverse), GL_MULCC_OPS))
        b_ops = ops_ms(n_el, per_el)
        return max(b_bytes, b_ops), ("bytes" if b_bytes >= b_ops else "operations")

    errs = {"ntt_phase_axis": 0, "ntt_phase_batched": 0, "ntt_phase_last": 0}

    def hold(name, got, want, what):
        torch.cuda.synchronize()
        errs[name] = max(errs[name], max_abs_diff(got, want))
        if errs[name]:
            fail(f"{name} != plain at {what}: max |difference| {errs[name]}")

    # K2 and K3 are compiled once per m and direction: every m = 2^1 .. 2^10
    # both ways at a small batch, column and row counts that leave a ragged
    # last tile. K2: axis 0 with no, a full and a periodic twiddle, and a
    # scale; axis 1 with a twiddle and a scale. K3: with and without ta and t.
    for m_log2 in range(1, 11):
        m = 1 << m_log2
        for inverse in (False, True):
            what = f"m=2^{m_log2} inverse={inverse}"
            scale = G.inv(m) if inverse else 977
            x = _field_rand((m, 1056), gen, dev)
            tw, twp = _field_rand((m, 1056), gen, dev), _field_rand((m, 32), gen, dev)
            for kw, desc in ((dict(), "no twiddle"), (dict(tw=tw), "full twiddle"),
                             (dict(tw=twp, tw_period=32), "periodic twiddle"), (dict(tw=tw, scale=scale), "full twiddle, scale")):
                hold("ntt_phase_axis", NT.phase_axis(x, 0, inverse, **kw), NT.phase_axis_plain(x, 0, inverse, **kw),
                     f"{what} axis 0 [{m}, 1056], {desc}")
            x = _field_rand((1003, m), gen, dev)
            tw = _field_rand((1003, m), gen, dev)
            hold("ntt_phase_axis", NT.phase_axis(x, 1, inverse, tw=tw, scale=scale),
                 NT.phase_axis_plain(x, 1, inverse, tw=tw, scale=scale), f"{what} axis 1 [1003, {m}], twiddle, scale")
            hold("ntt_phase_axis", NT.phase_axis(x, 1, inverse), NT.phase_axis_plain(x, 1, inverse),
                 f"{what} axis 1 [1003, {m}]")
            x = _field_rand((3, m, 98), gen, dev)
            ta, t = _field_rand((3, m), gen, dev), _field_rand((m, 98), gen, dev)
            hold("ntt_phase_batched", NT.phase_batched(x, inverse, ta=ta, t=t),
                 NT.phase_batched_plain(x, inverse, ta=ta, t=t), f"{what} [3, {m}, 98] ta, t")
            hold("ntt_phase_batched", NT.phase_batched(x, inverse), NT.phase_batched_plain(x, inverse),
                 f"{what} [3, {m}, 98]")
            # K4: m1 = 3 is below every block's V vectors; 37 spans blocks at m = 1024 and is odd
            for m1, m2, sc in ((3, 5, scale), (37, 6, 1), (64, 3, scale)):
                x = _field_rand((m1, m2, m), gen, dev)
                hold("ntt_phase_last", NT.phase_last(x, inverse, scale=sc), NT.phase_last_plain(x, inverse, scale=sc),
                     f"{what} [{m1}, {m2}, {m}] scale {sc}")
    log("[kernels] K2 (axis 0: no, full, periodic twiddle, scale; axis 1), K3 (with and without ta, t) "
        "and K4 (m1 = 3, 37, 64; with and without scale) == plain at every m = 2^1 .. 2^10, both directions")

    timed_2_20 = {}
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
            if main:
                # times at the main-path shapes: the coset NTT (2^23) and the
                # base inverse NTT (2^20) of a T = 2^20 prove. bound_ms counts
                # the register-pass design's operations, bound_radix2_ms the
                # radix-2 count of the first design. K2/K3 are unchanged
                # since their redesign: their times are the control for the card.
                for name, fn, plain, shp, mlog, ntw, tab in (
                    ("ntt_phase_axis",
                     lambda: NT.phase_axis(x0, 0, inverse, tw=tb, tw_period=m3),
                     lambda: NT.phase_axis_plain(x0, 0, inverse, tw=tb, tw_period=m3),
                     f"int64 [{m1}, {m2 * m3}] axis 0, periodic twiddle [{m1}, {m3}]",
                     l1, 1, m1 * m3 + m1),
                    ("ntt_phase_batched",
                     lambda: NT.phase_batched(x1, inverse, ta=ta, t=tm),
                     lambda: NT.phase_batched_plain(x1, inverse, ta=ta, t=tm),
                     f"int64 [{m1}, {m2}, {m3}], ta [{m1}, {m2}], t [{m2}, {m3}]",
                     l2, 2, m1 * m2 + m2 * m3 + m2),
                    ("ntt_phase_last",
                     lambda: NT.phase_last(x2, inverse, scale=inv_n),
                     lambda: NT.phase_last_plain(x2, inverse, scale=inv_n),
                     f"int64 [{m1}, {m2}, {m3}] -> [{m3}, {m2}, {m1}]" + (", scale n^-1" if inverse else ""),
                     l3, int(inv_n != 1), m3 if l3 >= 7 else 0),
                ):
                    ms = time_cuda(fn, 20)
                    plain_ms = time_cuda(plain, 1)
                    # graph_ms: the same launches replayed from a CUDA graph, without the
                    # wrapper's host time (which exceeds the device time at 2^20)
                    row = dict(shape=shp, ms=ms, graph_ms=time_cuda_graph(fn, 20), plain_ms=plain_ms)
                    row["bound_ms"], row["bound_by"] = bound_design(n, mlog, inverse, ntw, tab)
                    # the radix-2 count of the first design (K4's table was w_m^k, m/2 elements)
                    row["bound_radix2_ms"] = bound(n, mlog, ntw, m3 // 2 if name == "ntt_phase_last" else tab)[0]
                    if n_log2 == 23:
                        src = "ntt_last.cu" if name == "ntt_phase_last" else "ntt_phases.cu"
                        kern[name] = dict(name=name, route="cuda", source="sezkp_tpu_torch/ops/csrc/" + src,
                                          **row, library_ms=None)
                    else:
                        timed_2_20[name] = row
                log(f"[kernels] times at {what} (ms, issued / replayed): " + json.dumps(
                    {k: (round(v["ms"], 4), round(v["graph_ms"], 4))
                     for k, v in (kern if n_log2 == 23 else timed_2_20).items() if k.startswith("ntt_phase")}))
        # whole transform against the host oracle at the sizes numpy does quickly
        if n_log2 <= 18:
            ref = ntt_host.inverse_ntt(_to_u64(a)) if inverse else ntt_host.forward_ntt(_to_u64(a))
            if not np.array_equal(_to_u64(res), ref):
                fail(f"NTT != host oracle at {what}")
        log(f"[kernels] NTT phases == plain at {what} (factors {logs})")
        del a, res

    for name, row in timed_2_20.items():
        kern[name]["at_2^20_inverse"] = row
    kern["ntt_phase_axis"]["replaces"] = "sezkp_tpu/ops/ntt_mxu.py:374"
    kern["ntt_phase_batched"]["replaces"] = "sezkp_tpu/ops/ntt_mxu.py:475"
    kern["ntt_phase_last"]["replaces"] = "sezkp_tpu/ops/ntt_mxu.py:540"
    # ---- K5 ntt_small: the whole transform of every n = 2^1 .. 2^13, both
    # ways, in one cluster launch
    lib = _kernels.lib()
    errs["ntt_small"] = 0
    for n_log2 in range(1, NT.MIN_LOG2):
        n = 1 << n_log2
        plan = NT.small_plan(n_log2)
        if lib.sezkp_ntt_small_cluster(n_log2) != plan["C"]:
            fail(f"n=2^{n_log2}: K5 launches a cluster of {lib.sezkp_ntt_small_cluster(n_log2)} CTAs, "
                 f"ntt_torch.small_plan says {plan['C']}")
        for inverse in (False, True):
            a = _field_rand((n,), gen, dev)
            what = f"n=2^{n_log2} inverse={inverse} (a cluster of {plan['C']})"
            got = NT.small_ntt(a, inverse)
            hold("ntt_small", got, NT.small_ntt_plain(a, inverse), what)
            whole = NT.inverse_ntt(a) if inverse else NT.forward_ntt(a)
            ref = ntt_host.inverse_ntt(_to_u64(a)) if inverse else ntt_host.forward_ntt(_to_u64(a))
            if not (np.array_equal(_to_u64(got), ref) and np.array_equal(_to_u64(whole), ref)):
                fail(f"small-n NTT != host oracle at {what}")
            if n_log2 == NT.MIN_LOG2 - 1 and inverse:
                # times at the main-path shape: the base inverse NTT of a T = 2^13 prove.
                # ms: launches made one by one from Python, as the prover makes them;
                # graph_ms: the same launches replayed from a CUDA graph, the device's share
                l1, l2 = plan["l1"], plan["l2"]
                fn = lambda: NT.small_ntt(a, inverse)
                ms, graph_ms = time_cuda(fn, 200), time_cuda_graph(fn, 200)
                plain_ms = time_cuda(lambda: NT.small_ntt_plain(a, inverse), 5)
                # the design bound: both phases' pass schedules and the four-step
                # twiddle (n^-1 rides in its table: no product for the scale);
                # bytes: the vector in and out, the four-step table, the pass tables
                kplan = dict(reg_log2=NT.SMALL_REG_LOG2, table=True)
                per_el = tuple(x + y + mc for x, y, mc in
                               zip(design_ops(l1, inverse, **kplan), design_ops(l2, inverse, **kplan), GL_MULCC_OPS))
                b_ops = ops_ms(n, per_el)
                tables = sum(8 << l for l in (l1, l2) if l > NT.SMALL_REG_LOG2)
                b_bytes = (24 * n + tables) / _peaks()[0] * 1e3
                # the launch floor: an empty kernel launched as K5 launches, one
                # CTA and a cluster of K5's size at this n
                floor = {}
                for c in sorted({1, plan["C"]}):
                    call = lambda c=c: _kernels.check(lib.sezkp_launch_floor(c, _kernels.stream_ptr()), "launch_floor")
                    floor[f"cluster_{c}"] = dict(ms=time_cuda(call, 200), graph_ms=time_cuda_graph(call, 200))
                kern["ntt_small"] = dict(
                    name="ntt_small", route="cuda", source="sezkp_tpu_torch/ops/csrc/ntt_small.cu",
                    replaces="sezkp_tpu/ops/ntt_pallas.py:162 (phase_a_kernel) and :177 (phase_b_kernel)",
                    shape=f"int64 [{n}] inverse ([{1 << l1}, {1 << l2}]): one cluster of {plan['C']} CTAs "
                          f"x {plan['nt']} threads",
                    ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                    bound_ms=max(b_ops, b_bytes), bound_by="bytes" if b_bytes >= b_ops else "operations",
                    library_ms=None, launch_floor=floor,
                )
                log(f"[kernels] K5 ntt_small at 2^13 inverse: {ms:.4f} ms issued, {graph_ms:.4f} ms replayed "
                    f"(bound {max(b_ops, b_bytes):.6f}); launch floor (ms, issued / replayed): "
                    + json.dumps({k: (round(v["ms"], 4), round(v["graph_ms"], 4)) for k, v in floor.items()}))
    kern["ntt_small"]["max_abs_err"] = errs["ntt_small"]
    if NT.forward_ntt(torch.zeros(1, dtype=torch.int64, device=dev)).shape != (1,):
        fail("forward_ntt of one point")
    log("[kernels] K5 == plain, and K5 and forward/inverse NTT == host oracle, at every n = 2^1 .. 2^13")

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
    refuses(ValueError, "phase_axis along axis 0 of an odd column count",
            lambda: NT.phase_axis(torch.zeros((8, 7), dtype=torch.int64, device=dev), 0, False))
    refuses(ValueError, "phase_axis with a tw_period of 3",
            lambda: NT.phase_axis(torch.zeros((8, 6), dtype=torch.int64, device=dev), 0, False,
                                  tw=torch.zeros((8, 3), dtype=torch.int64, device=dev), tw_period=3))
    refuses(ValueError, "phase_axis of a tensor 8 bytes off a 16-byte boundary",
            lambda: NT.phase_axis(torch.zeros(65, dtype=torch.int64, device=dev)[1:].view(8, 8), 0, False))
    refuses(ValueError, "phase_batched of an odd column count",
            lambda: NT.phase_batched(torch.zeros((2, 8, 5), dtype=torch.int64, device=dev), False))
    refuses(ValueError, "small_ntt of a 2-D tensor",
            lambda: NT.small_ntt(small.view(32, 32), False))
    refuses(ValueError, "small_ntt of n = 2^14",
            lambda: NT.small_ntt(a[: 1 << 14].clone(), False))
    zeros = torch.zeros((32, 8), dtype=torch.int32, device=dev)
    refuses(ValueError, "hash_many_words of 0-byte messages",
            lambda: BT.hash_many_words(zeros[:16], 0))
    refuses(ValueError, "hash_many_words of 1025-byte messages",
            lambda: BT.hash_many_words(torch.zeros((272, 8), dtype=torch.int32, device=dev), 1025))
    refuses(ValueError, "hash_many_words of 32 planes for one block",
            lambda: BT.hash_many_words(zeros, 64))
    refuses(ValueError, "hash_many_words of a non-contiguous view",
            lambda: BT.hash_many_words(zeros.t().contiguous().t()[:16], 64))
    shifted = torch.empty((1 << 16) + 1, dtype=torch.int64, device=dev)[1:]
    shifted.copy_(a[: 1 << 16])
    if not torch.equal(NT.forward_ntt(shifted), NT.forward_ntt(a[: 1 << 16].clone())):
        fail("forward_ntt of a tensor 8 bytes off a 16-byte boundary")
    log("[kernels] n = 2^10 on the card == host oracle; the wrappers refuse a wrong dtype, "
        "a wrong rank, non-contiguous input, K2/K3 odd column counts, a tw_period that is no power of two "
        "and misaligned tensors (forward_ntt realigns its input), and K7 a length outside 1..1024 "
        "and a wrong plane count")

    # ---- K12 deep_divide against its plain version on the same tensors: at
    # 2^13 + 3 random points, over the LDE's coset at 2^20 and 2^23 (the table a
    # T = 2^20 prove uses) and at 2^27 random points (the T = 2^24 prove's
    # size); z off the coset (nudged as the prover does) and on it (a zero
    # denominator, 0 there). Timed at 2^23 and 2^27.
    from sezkp_tpu_torch.stark.v1.prover import _nudge_off_coset

    err12, timed12 = 0, {}
    # Goldilocks products a point (ntt_torch.deep_divide_model): the prefix
    # (K - 1), the walk back (2 (K - 1)), the final K, the chain's 63 + 9 once a thread
    k12 = NT.DIVIDE_POINTS
    products = (3 * (k12 - 1) + k12 + 72) / k12
    for n_log2, extra in ((13, 3), (20, 0), (23, 0), (27, 0)):
        n = (1 << n_log2) + extra
        y = _field_rand((n,), gen, dev)
        if n_log2 == 23:
            xs = NT._deep_lde_tables(n_log2 - 3, n_log2, 3, dev)[1]
        elif n_log2 == 20:
            xs = FT.pack(G.mul(np.uint64(3), ntt_host.powers(G.primitive_root_2exp(n_log2), n)), dev)
        else:
            xs = _field_rand((n,), gen, dev)
        z_on = int(_to_u64(xs[7:8])[0])
        for z in (_nudge_off_coset(0x1234567890ABCDEF % int(G.P), 3, n_log2), z_on):
            before = NT.deep_divide.launches
            got = NT.deep_divide(y, z, xs)
            if NT.deep_divide.launches != before + 1:
                fail("K12 deep_divide: a call must launch once")
            want = NT.deep_divide_plain(y, z, xs)
            torch.cuda.synchronize()
            err12 = max(err12, max_abs_diff(got, want))
            if err12:
                fail(f"K12 deep_divide != plain at n = 2^{n_log2} + {extra}, z = {z}: max |difference| {err12}")
            del got, want
        if not extra:
            reps = 20 if n_log2 < 27 else 5
            b_bytes = 24 * n / _peaks()[0] * 1e3
            b_ops = ops_ms(n, tuple(products * mc + su for mc, su in zip(GL_MULCC_OPS, GL_SUB_OPS)))
            timed12[n_log2] = dict(
                shape=f"int64 y, xs [2^{n_log2}] -> [2^{n_log2}]",
                ms=time_cuda(lambda: NT.deep_divide(y, z_on, xs), reps),
                plain_ms=time_cuda(lambda: NT.deep_divide_plain(y, z_on, xs), 1) if n_log2 == 23 else None,
                bound_ms=max(b_bytes, b_ops), bound_by="bytes" if b_bytes >= b_ops else "operations",
                bytes_ms=b_bytes, operations_ms=b_ops, products_a_point=products)
        del y, xs
    kern["deep_divide"] = dict(
        name="deep_divide", route="cuda", source="sezkp_tpu_torch/ops/csrc/deep_divide.cu",
        replaces="none: plain jnp in the JAX package (sezkp_tpu/ops/ntt_jax.py _pow_p_minus_2)",
        max_abs_err=err12, **timed12[23], library_ms=None, at_2_27=timed12[27])
    log(f"[kernels] K12 deep_divide == plain at 2^13 + 3, 2^20, 2^23, 2^27, z off and on the coset: "
        + "; ".join(f"2^{k}: {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, {t['bound_by']})"
                    for k, t in timed12.items())
        + f"; plain {timed12[23]['plain_ms']:.1f} ms at 2^23")

    _kernel_chunk_roots(kern, gen, dev)

    _kernels_digit_form(kern, gen, dev)

    # the plain tensor steps of the DEEP glue (the coset scale's product) and
    # the FRI fold, which no kernel covers (they are outside any kernel in the
    # JAX package too)
    half = a.shape[0] // 2
    glue = {
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


def _int_mm_layouts(call, x, want, reps, what) -> dict:
    """K8's library yardstick, `call(B)` (torch._int_mm), timed with B = x
    row-major and with the same values column-major (x.t().contiguous().t(),
    the layout cuBLASLt's int8 path takes natively); library_ms is the faster,
    library_layout names it. Both results must equal K8's."""
    xc = x.t().contiguous().t()
    out = {}
    for layout, xb in (("row-major B", x), ("column-major B", xc)):
        if not torch.equal(call(xb), want):
            fail(f"torch._int_mm with {layout} != K8 at {what}")
        out[layout] = time_cuda(lambda: call(xb), reps)
    del xc
    best = min(out, key=out.get)
    return dict(library_ms=out[best], library_layout=best,
                library_row_major_ms=out["row-major B"], library_column_major_ms=out["column-major B"])


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
        # MAX_BAL + 1 has the digit -128 in planes 4-7, p - 0x80808080 in planes 0-3
        x = _field_rand(shape, gen, dev)
        x.view(-1)[2] = FT._i64(ND.MAX_BAL)
        x.view(-1)[3] = FT._i64(ND.MAX_BAL + 1)
        x.view(-1)[4] = FT._i64(FT.P_INT - 0x80808080)
        return x

    # ---- K8 i8_gemm
    # M, K, N multiples of 64 but not of the 256 (m) x 128 (n) tile and the 128-byte k chunk:
    # (128, 192, 320), (192, 320, 576), (320, 64, 4160)
    for M, K, N, nrep in ((64, 64, 64, 1), (128, 192, 320, 3), (192, 320, 576, 2), (320, 64, 4160, 5),
                          (256, 256, 8 * 4096, 8), (1024, 1024, 4096, 1)):
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
    macs = nd * m * m * nd * other
    bnd, by = _bound(w.numel() + x.numel() + 4 * m * nd * other, 2 * macs)
    lib = _int_mm_layouts(lambda xb: _int_mm_sum(w, xb, nd), x, got, 10, "the probe's shape")
    ms8 = time_cuda(lambda: ND.i8_gemm(w, x, nd), 10)
    fused8 = time_cuda(lambda: ND.i8_gemm(w, x, nd, "int32", True), 10)
    kern["i8_gemm"] = dict(
        name="i8_gemm", route="cuda", source="sezkp_tpu_torch/ops/csrc/i8_gemm.cu",
        replaces="scripts/exp_mxu_peak.py:76", also_replaces=["scripts/exp_mxu_peak.py:105", "scripts/exp_mxu_peak.py:128"],
        shape=f"int8 [{nd}*{m}, {m}] @ int8 [{m}, {nd}*{other}] -> int32 [{m}, {nd}*{other}], {nd} products summed",
        ms=ms8, fused_ms=fused8,
        plain_ms=time_cuda(lambda: ND.i8_gemm_plain(w, x, nd), 1),
        bound_ms=bnd, bound_by=by, **lib,
        # the share of the bound reached and the int8 rate, both of the fused order
        bound_share=bnd / fused8, tops=2 * macs / fused8 * 1e-9,
    )
    del w, x, got
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
        got = ND.i8_gemm(w, x)
        ms_b = time_cuda(lambda: ND.i8_gemm(w, x), 5)
        ms_b8 = time_cuda(lambda: ND.i8_gemm(w, x, 1, "and127"), 5)
        big[f"at_{mm}x{mm}x2^20"] = dict(
            ms=ms_b, bound_ms=bnd, bound_by=by, bound_share=bnd / ms_b, tops=ops / ms_b * 1e-9,
            and127_ms=ms_b8, and127_bound_ms=bnd8, and127_bound_by=by8, and127_bound_share=bnd8 / ms_b8,
            and127_tops=ops / ms_b8 * 1e-9,
            plain_ms=time_cuda(lambda: ND.i8_gemm_plain(w, x), 1),
            **_int_mm_layouts(lambda xb: torch._int_mm(w, xb), x, got, 5, what))
        del w, x, got
    kern["i8_gemm"].update(big)
    torch.cuda.empty_cache()
    log(f"[kernels] K8 i8_gemm == plain == torch._int_mm (both epilogues, both loop orders, the int32 wrap, the whole of [mm, mm] @ [mm, 2^20] at mm = 1024 and 512): "
        f"{kern['i8_gemm']['ms']:.3f} ms ({kern['i8_gemm']['fused_ms']:.3f} fused) against "
        f"{kern['i8_gemm']['library_ms']:.3f} ms of torch._int_mm ({kern['i8_gemm']['library_layout']}; "
        f"row-major {kern['i8_gemm']['library_row_major_ms']:.3f}, column-major "
        f"{kern['i8_gemm']['library_column_major_ms']:.3f}) at the probe's shape; at [1024, 1024] @ [1024, 2^20]: "
        + json.dumps({k: round(v, 3) for k, v in big["at_1024x1024x2^20"].items()
                      if k.startswith(("ms", "and127_ms", "library_", "bound_share", "tops")) and isinstance(v, float)}))

    # ---- K9 gl_digits: k-major tiles of 32, 64, 128 and 256 rows (m = 96 and 288: 32)
    for m, other in ((32, 32), (64, 160), (96, 64), (128, 32), (288, 32), (1024, 96), (256, 32768)):
        a = edge_field((m, other))
        planes = ND.digits_plain(a)
        hold("gl_digits", ND.gl_digits(a), ND.stack_kmajor(planes), f"[{m}, {other}] k-major")
        for tile in (32, other):
            hold("gl_digits", ND.gl_digits(a, tile), ND.stack_tiled(planes, tile), f"[{m}, {other}] tile {tile}")
    # every element MAX_BAL + 1 (the digit -128 in planes 4-7), and an x 8 bytes
    # off a 16-byte boundary (the wrapper copies it to an aligned one)
    xe = torch.full((64, 32), FT._i64(ND.MAX_BAL + 1), dtype=torch.int64, device=dev)
    hold("gl_digits", ND.gl_digits(xe), ND.stack_kmajor(ND.digits_plain(xe)), "all MAX_BAL + 1, k-major")
    xe = edge_field((256 * 64 + 1,))[1:].view(256, 64)
    if xe.data_ptr() % 16 != 8:
        fail("the misaligned K9 input is not 8 bytes off a 16-byte boundary")
    hold("gl_digits", ND.gl_digits(xe), ND.stack_kmajor(ND.digits_plain(xe)), "x 8 bytes off a 16-byte boundary")
    del xe
    m, other = 256, 32768
    n = m * other
    bnd, by = _bound(16 * n, 0)
    kern["gl_digits"] = dict(
        name="gl_digits", route="cuda", source="sezkp_tpu_torch/ops/csrc/gl_digits.cu",
        replaces="scripts/exp_ntt_breakdown.py:129",
        shape=f"int64 [{m}, {other}] -> int8 [8, {other}, {m}] (k-major)",
        ms=time_cuda(lambda: ND.gl_digits(a), 20), graph_ms=time_cuda_graph(lambda: ND.gl_digits(a), 20),
        tiled_512_ms=time_cuda(lambda: ND.gl_digits(a, 512), 20),
        tiled_512_graph_ms=time_cuda_graph(lambda: ND.gl_digits(a, 512), 20),
        plain_ms=time_cuda(lambda: ND.stack_kmajor(ND.digits_plain(a)), 2),
        bound_ms=bnd, bound_by=by, library_ms=None,
    )
    kern["gl_digits"]["bound_share"] = bnd / kern["gl_digits"]["ms"]
    log("[kernels] K9 gl_digits == plain in both layouts (k-major tiles of 32 to 256 rows, all MAX_BAL + 1, "
        "a misaligned x): at [256, 32768] " + json.dumps({k: round(kern["gl_digits"][k], 4) for k in (
            "ms", "graph_ms", "tiled_512_ms", "tiled_512_graph_ms", "bound_ms")}))

    # ---- K10 digit_dft: against the plain version in every (source, epilogue), and elements-in against K2
    for m_log2, other, inverse in ((5, 32, False), (6, 48, True), (7, 128, False), (9, 64, True), (10, 32, False),
                                   (8, 32768, False), (10, 48, True)):
        m = 1 << m_log2
        a = edge_field((m, other))
        w = ND.w_digits(m_log2, inverse, 1, dev)
        what = f"m={m} other={other} inverse={inverse}"
        stack = ND.stack_kmajor(ND.digits_plain(a))
        for epilogue in ("recombine", "sum"):
            want = ND.digit_dft_plain(stack, w, epilogue)
            hold("digit_dft", ND.digit_dft(stack, w, epilogue), want, f"{what} stack in, {epilogue}")
            hold("digit_dft", ND.digit_dft(a, w, epilogue, elements=True), want, f"{what} elements in, {epilogue}")
        hold("digit_dft", ND.digit_dft(a, w, "recombine", elements=True), NT.phase_axis(a, 0, inverse), what + " (K2)")
    # operands 8 bytes off a 16-byte boundary: the wrapper copies them to aligned ones
    m, other = 64, 80
    w = ND.w_digits(6, False, 1, dev)
    xe = edge_field((m * other + 1,))[1:].view(m, other)
    se = _rand_i8((ND.NDIG * other * m + 8,), 9, dev)[8:].view(ND.NDIG, other, m)
    if xe.data_ptr() % 16 != 8 or se.data_ptr() % 16 != 8:
        fail("the misaligned K10 inputs are not 8 bytes off a 16-byte boundary")
    for epilogue in ("recombine", "sum"):
        hold("digit_dft", ND.digit_dft(xe, w, epilogue, elements=True),
             ND.digit_dft_plain(xe, w, epilogue, elements=True), f"elements 8 bytes off a 16-byte boundary, {epilogue}")
        hold("digit_dft", ND.digit_dft(se, w, epilogue), ND.digit_dft_plain(se, w, epilogue),
             f"stack 8 bytes off a 16-byte boundary, {epilogue}")
    # a random stack whose first 16 columns are all -128 against an all -128
    # table: those outputs' diagonal sums reach their bound (2^27 at m = 1024)
    m, other = 1024, 64
    x8 = _rand_i8((ND.NDIG, other, m), 4, dev)
    x8[:, :16] = -128
    wneg = torch.full((ND.NDIG * m, m), -128, dtype=torch.int8, device=dev)
    for epilogue in ("recombine", "sum"):
        hold("digit_dft", ND.digit_dft(x8, wneg, epilogue), ND.digit_dft_plain(x8, wneg, epilogue),
             f"random stack against an all -128 table, m={m}, {epilogue}")
    del xe, se, wneg
    # times at one phase of n = 2^23
    m, other = 256, 32768
    w = ND.w_digits(8, False, 1, dev)
    a = edge_field((m, other))
    x8 = _rand_i8((ND.NDIG, other, m), 3, dev)
    hold("digit_dft", ND.digit_dft(x8, w, "sum"), ND.digit_dft_plain(x8, w, "sum"), "random digit stack, sum")
    hold("digit_dft", ND.digit_dft(x8, w, "recombine"), ND.digit_dft_plain(x8, w, "recombine"),
         "random digit stack, recombine")
    n = m * other
    macs = ND.NDIG * ND.NDIG * m * n
    bnd, by = _bound(8 * n + w.numel() + 8 * n, 2 * macs)
    calls = {"": lambda: ND.digit_dft(x8, w, "recombine"), "sum_": lambda: ND.digit_dft(x8, w, "sum"),
             "elements_in_": lambda: ND.digit_dft(a, w, "recombine", elements=True)}
    times = {}
    for key, fn in calls.items():
        times[key + "ms"] = time_cuda(fn, 20)
        times[key + "graph_ms"] = time_cuda_graph(fn, 20)
    kern["digit_dft"] = dict(
        name="digit_dft", route="cuda", source="sezkp_tpu_torch/ops/csrc/digit_dft.cu",
        replaces="scripts/exp_ntt_breakdown.py:112", also_replaces=["scripts/exp_ntt_breakdown.py:92"],
        shape=f"int8 digit stack [8, {other}, {m}] x table int8 [8*{m}, {m}] -> int64 [{m}, {other}], recombined",
        **times,
        k2_same_input_ms=time_cuda(lambda: NT.phase_axis(a, 0, False), 10),
        plain_ms=time_cuda(lambda: ND.digit_dft_plain(x8, w, "recombine"), 1),
        bound_ms=bnd, bound_by=by, library_ms=None,
        # the sum stores 4 bytes an output: its bound by bytes is lower, by operations the same
        sum_bound_ms=_bound(8 * n + w.numel() + 4 * n, 2 * macs)[0],
    )
    kern["digit_dft"]["bound_share"] = bnd / kern["digit_dft"]["ms"]
    del x8, stack, want
    log("[kernels] K10 digit_dft == plain (stack in, elements in, both epilogues, seven shapes, misaligned "
        "operands, the diagonal bound) == K2: at [256, 32768] "
        + json.dumps({k: round(v, 4) for k, v in times.items()})
        + f" (bound {bnd:.4f}), K2 {kern['digit_dft']['k2_same_input_ms']:.4f} ms")

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
    # the edges of its tiles, on random tables whose first 16 rows of slice 0
    # are all -128 (the diagonal sums' bound): one slice, three slices, 48
    # rows (a 64-row tile cut at the tensor's edge), the smallest and the
    # largest last factor, and an X 8 bytes off a 16-byte boundary
    for m2e, mce, colse in ((1, 128, 64), (3, 64, 32), (2, 32, 48), (1, 32, 16), (1, 1024, 16)):
        xe = edge_field((colse, m2e * mce))
        wfe = _rand_i8((m2e, mce, ND.NDIG, mce), m2e * mce + colse, dev)
        wfe[0, :16] = -128
        hold("digit_dft_last", ND.digit_dft_last(xe, wfe), ND.digit_dft_last_plain(xe, wfe),
             f"random table m2={m2e} mc={mce} cols={colse}")
    xe = edge_field((64 * 2 * 128 + 1,))[1:].view(64, 2 * 128)
    wfe = _rand_i8((2, 128, ND.NDIG, 128), 7, dev)
    if xe.data_ptr() % 16 != 8:
        fail("the misaligned K11 input is not 8 bytes off a 16-byte boundary")
    hold("digit_dft_last", ND.digit_dft_last(xe, wfe), ND.digit_dft_last_plain(xe, wfe), "X 8 bytes off a 16-byte boundary")
    del xe, wfe
    n = cols * m2 * mc
    bnd, by = _bound(8 * n + wf.numel() + 8 * n, 2 * ND.NDIG * ND.NDIG * mc * n)
    kern["digit_dft_last"] = dict(
        name="digit_dft_last", route="cuda", source="sezkp_tpu_torch/ops/csrc/digit_dft_last.cu",
        replaces="scripts/ntt_twiddle_fold_ab.py:101",
        shape=f"int64 [{cols}, {m2}*{mc}] x folded table int8 [{m2}, {mc}, 8, {mc}] -> int64 [{mc}, {m2}*{cols}]",
        ms=time_cuda(lambda: ND.digit_dft_last(x, wf), 20),
        graph_ms=time_cuda_graph(lambda: ND.digit_dft_last(x, wf), 20),
        plain_ms=time_cuda(lambda: ND.digit_dft_last_plain(x, wf), 1),
        bound_ms=bnd, bound_by=by, library_ms=None,
    )
    kern["digit_dft_last"]["bound_share"] = bnd / kern["digit_dft_last"]["ms"]
    del x, wf, want
    for n_log2 in (18, 20, 23):
        a = edge_field((1 << n_log2,))
        hold("digit_dft_last", ND.forward_ntt_folded(a), NT.forward_ntt(a), f"forward_ntt_folded at 2^{n_log2}")
    kern["digit_dft_last"]["folded_forward_2^23_ms"] = time_cuda(lambda: ND.forward_ntt_folded(a), 10)
    kern["digit_dft_last"]["forward_2^23_ms"] = time_cuda(lambda: NT.forward_ntt(a), 10)
    log(f"[kernels] K11 digit_dft_last == plain (three folded tables, five edge shapes, a misaligned X); "
        f"forward_ntt_folded == forward_ntt at 2^18, 2^20, 2^23: {kern['digit_dft_last']['ms']:.4f} ms issued, "
        f"{kern['digit_dft_last']['graph_ms']:.4f} replayed at 2^23 (bound {kern['digit_dft_last']['bound_ms']:.4f}); "
        f"whole transform {kern['digit_dft_last']['folded_forward_2^23_ms']:.3f} ms "
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
    # an operand off TMA's 16-byte boundary: the wrapper copies it to an aligned one
    wa = torch.randint(-128, 128, (64, 128), generator=gen, device=dev, dtype=torch.int8)
    xa = torch.randint(-128, 128, (128 * 64 + 8,), generator=gen, device=dev, dtype=torch.int8)[8:].view(128, 64)
    if not torch.equal(ND.i8_gemm(wa, xa).cpu(), ND.i8_gemm_plain(wa.cpu(), xa.cpu())):
        fail("i8_gemm of an operand 8 bytes off a 16-byte boundary != its plain version")
    log("[kernels] K8 of an operand 8 bytes off a 16-byte boundary == its plain version")
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


def _unit(op: str) -> str:
    """imad, memory (loads, stores, barriers), control, or alu: a kernel's instruction mix."""
    if op.startswith(("IMAD", "UIMAD")):
        return "imad"
    if op.startswith(("LD", "ST", "ATOM", "RED", "BAR", "MEMBAR")):
        return "mem"
    if op.startswith(("BRA", "EXIT", "NOP", "BSSY", "BSYNC", "WARPSYNC", "CALL", "RET", "S2R", "S2UR", "CS2R")):
        return "ctl"
    return "alu"


def _short(name: str) -> str:
    """ntt_phase_axis_kernel<7,0,0> for a mangled K2-K5 name, digit_dft_kernel<1,0>
    for K10's (source, epilogue); other names as they are."""
    k = re.search(r"(ntt_(?:phase_\w+?|small)_kernel)(?:I((?:L[ib]\d+E)+)E)?", name)
    if not k:
        other = re.search(r"\d((?:i8|gl|digit|deep)_[a-z_]+_kernel)(?:I((?:L[ib]\d+E)+)E)?", name)
        if not other:
            return name
        args = re.findall(r"L[ib](\d+)E", other.group(2) or "")
        return other.group(1) + (f"<{','.join(args)}>" if args else "")
    return f"{k.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', k.group(2) or ''))}>"


def _ptxas_start(sources):
    """One nvcc with ptxas's report (-Xptxas -v) for each of ops/csrc's
    `sources`, all started at once; objects under sezkp_tpu_torch/_build/ptxas/."""
    from sezkp_tpu_torch.ops import _kernels

    nvcc = _kernels._find_nvcc()
    out = os.path.join(_kernels._BUILD_DIR, "ptxas")
    os.makedirs(out, exist_ok=True)
    return [(src, subprocess.Popen([nvcc, *_kernels._NVCC_FLAGS, "-Xptxas", "-v", "-I", _kernels._CSRC, "-c",
                                    os.path.join(_kernels._CSRC, src), "-o", os.path.join(out, src + ".o")],
                                   stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src in sources]


def _ptxas_usage(procs):
    """(ptxas's whole report, {kernel: [its registers, spills and shared memory]})
    of `_ptxas_start`'s builds."""
    text, func, usage = "", None, {}
    for src, p in procs:
        out, _ = p.communicate()
        if p.returncode:
            fail(f"nvcc -Xptxas -v {src} failed\n{out[-4000:]}")
        text += out
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                func = _short(m.group(1))
            elif func and ("Used" in line or "spill" in line):
                usage.setdefault(func, []).append(line.split("ptxas info    :")[-1].strip())
    return text, usage


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
    from sezkp_tpu_torch.ops import ntt_torch as NT

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
    counts, summary = {}, []
    for prim in ("mul", "mul_cc", "add", "sub", "neg", "mul_pow2_lo", "mul_pow2_mid", "mul_pow2_hi", "bfly"):
        extra = Counter(op for _, op, _ in probes["probe_" + prim])
        extra.subtract(base)
        if prim in ("mul", "mul_cc", "add", "sub"):
            extra["LOP3.LUT"] += base["LOP3.LUT"]  # the base's own xor is not indexing
        extra = {op: c for op, c in extra.items() if c and op not in ("NOP", "BRA")}
        pipes = Counter()
        for op, c in extra.items():
            pipes[_pipe(op)] += c
        counts[prim] = dict(pipes)
        summary.append(f"gl::{prim}: {json.dumps(dict(pipes))} from {json.dumps(extra)}")
    summary.append("primitive counts: " + json.dumps(counts))
    pair = lambda prim: (counts[prim].get("imad", 0), counts[prim].get("alu", 0))
    summary.append(f"as chip_smoke.py's constants: GL_MUL_OPS, GL_ADD_OPS, GL_SUB_OPS = "
                   f"{pair('mul')}, {pair('add')}, {pair('sub')}; GL_NEG_OPS = {pair('neg')}; GL_MULPOW2_OPS = "
                   + json.dumps({r: pair('mul_pow2_' + r) for r in ('lo', 'mid', 'hi')})
                   + f"; GL_BFLY_OPS = {pair('bfly')}; GL_MULCC_OPS = {pair('mul_cc')}")

    # registers, spills and shared memory of K2-K5's instantiations and of K8-K11 (ptxas)
    ptxas, usage = _ptxas_usage(_ptxas_start(("ntt_phases.cu", "ntt_last.cu", "ntt_small.cu", "i8_gemm.cu",
                                              "gl_digits.cu", "digit_dft.cu", "digit_dft_last.cu",
                                              "deep_divide.cu")))
    with open("chiprun_out/sass/ptxas_ntt_phases.txt", "w") as f:
        f.write(ptxas)
    summary += [f"ptxas {f}: {' | '.join(u)}" for f, u in sorted(usage.items())]
    summary.append(f"digit_dft_kernel<*,*> (K10) and digit_dft_last_kernel (K11), one body (digit_wgmma.cuh): "
                   f"{_kernels.lib().sezkp_digit_dft_last_smem()} bytes of dynamic shared memory a block (one block an SM)")

    text, funcs = _sass_functions(cuobjdump, _kernels.build())
    # the unrolled K2/K3 instantiations make the text large: compressed
    with gzip.open("chiprun_out/sass/kernels.sass.gz", "wt") as f:
        f.write(text)
    out = ["# " + " | ".join(ver)]
    for name, ins in funcs.items():
        hist = Counter(op for _, op, _ in ins)
        pipes = Counter(_pipe(op) for _, op, _ in ins)
        units = Counter(_unit(op) for _, op, _ in ins)
        out.append(f"== {_short(name)}: {len(ins)} instructions, imad-family {pipes['imad']}, "
                   f"alu {units['alu']}, memory {units['mem']}, control {units['ctl']}, "
                   f"sha256 {_sass_sha(ins)}")
        out.append("   all: " + json.dumps(hist.most_common()))
        for addr, op, rest in ins:
            m = re.search(r"0x([0-9a-f]+)\s*$", rest.strip())
            if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
                lo = int(m.group(1), 16)
                body = [o for a, o, _ in ins if lo <= a <= addr]
                out.append(f"   loop 0x{lo:04x}..0x{addr:04x}: {len(body)} instructions "
                           + json.dumps(Counter(body).most_common()))
    # K4 has no loop: its instructions per element are the kernel's over the
    # E = min(m, 16) elements a thread holds
    for name, ins in funcs.items():
        short = _short(name)
        k4 = re.fullmatch(r"ntt_phase_last_kernel<(\d+),(\d+)>", short)
        if k4:
            per = min(1 << int(k4.group(1)), 16)
            pipes = Counter(_pipe(op) for _, op, _ in ins)
            units = Counter(_unit(op) for _, op, _ in ins)
            summary.append(f"K4 {short}: per element imad-family {pipes['imad'] / per:.1f}, "
                           f"alu {units['alu'] / per:.1f}, memory {units['mem'] / per:.1f}, "
                           f"control {units['ctl'] / per:.1f}")
        # K12: a thread's instructions over its kPoints points
        if short == "deep_divide_kernel":
            pipes = Counter(_pipe(op) for _, op, _ in ins)
            units = Counter(_unit(op) for _, op, _ in ins)
            loops = sum(1 for a, op, rest in ins if op.startswith("BRA") and
                        (m := re.search(r"0x([0-9a-f]+)\s*$", rest.strip())) and int(m.group(1), 16) <= a)
            per = NT.DIVIDE_POINTS
            summary.append(f"K12 deep_divide_kernel: {len(ins)} instructions, {loops} loops (their bodies "
                           f"counted once); over its {per} points imad-family {pipes['imad'] / per:.1f}, alu "
                           f"{units['alu'] / per:.1f}, memory {units['mem'] / per:.1f}, control "
                           f"{units['ctl'] / per:.1f} a point; ptxas {' | '.join(usage.get(short, ['not reported']))}")
        # K5 has no loop either: each thread runs its instructions once, the
        # chain whose length a transform waits for
        k5 = re.fullmatch(r"ntt_small_kernel<(\d+),(\d+)>", short)
        if k5:
            plan = NT.small_plan(int(k5.group(1)))
            pipes = Counter(_pipe(op) for _, op, _ in ins)
            units = Counter(_unit(op) for _, op, _ in ins)
            summary.append(f"K5 {short}: a cluster of {plan['C']} x {plan['nt']} threads; a thread's "
                           f"{len(ins)} instructions: imad-family {pipes['imad']}, alu {units['alu']}, "
                           f"memory {units['mem']}, control {units['ctl']}; "
                           f"ptxas {' | '.join(usage.get(short, ['not reported']))}")
    with open("chiprun_out/sass/loops.txt", "w") as f:
        f.write("\n".join(out) + "\n")
    for line in out:
        if line.startswith("=="):
            log("[sass] " + line)
    log("[sass] full text (gzip) and loop histograms under chiprun_out/sass/")
    for line in summary:
        log("[sass] " + line)

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
        "ntt_small": NT.small_ntt,
        "deep_divide": NT.deep_divide,
        "blake3_chunk_roots": BT.chunk_roots,
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


def _check_k13(launches, timings, lde_log2: int, what: str) -> None:
    """K13 launches once for the columns' commitment and, with the chunked
    FRI, once for each of its layers from 2^lde_log2 down to one chunk."""
    from sezkp_tpu_torch.stark.v1.fri_device import CHUNK_LOG2

    want = 1 + (lde_log2 - CHUNK_LOG2 + 1 if "fri_commit_chunked" in timings else 0)
    if launches["blake3_chunk_roots"] != want:
        fail(f"K13 blake3_chunk_roots must launch {want} times {what}, not {launches['blake3_chunk_roots']}")


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
    if launches["deep_divide"] != 1:
        fail(f"K12 deep_divide must launch exactly once a prove, not {launches['deep_divide']} times")
    _check_k13(launches, timings, t_log2 + 3, "a prove")

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
    if launches3["deep_divide"] != 1:
        fail(f"K12 deep_divide must launch exactly once on the host-columns route, not {launches3['deep_divide']}")
    _check_k13(launches3, timings3, t_log2 + 3, "on the host-columns route")
    if art3.proof_bytes != art.proof_bytes:
        fail("the host-columns route and the device-resident route give different proofs")

    del art3
    art4, wall4, timings4, launches4, peak4 = _counted_prove(blocks, man.root, fri_chunked_min_log2=23)
    log(f"[prove] chunked FRI forced, one prove wall {wall4:.2f} s; stages (s): {_stages(timings4)}; "
        f"peak device memory {peak4} bytes; launches {json.dumps(launches4)}; sha256 {_sha(art4)}")
    if "fri_commit_chunked" not in timings4:
        fail("fri_chunked_min_log2=23 did not select the chunked FRI at LDE 2^23")
    _check_k13(launches4, timings4, t_log2 + 3, "with the chunked FRI")
    sha = _sha(art4)
    if not (sha.startswith(STARK_SHA[0]) and sha.endswith(STARK_SHA[1])):
        fail(f"the chunked-FRI prove's sha256 {sha} is not the known {STARK_SHA[0]}...{STARK_SHA[1]}")


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
        # the streaming prove (host columns and composition, host-hashed chunks; LDE and FRI on the card)
        stages = {}
        streamed = StarkV1.prove_streaming(blocks, man.root, timings=stages)
        streamed_cpu = StarkV1.prove_streaming(blocks, man.root, device="cpu")
        if streamed.proof_bytes != on_card.proof_bytes or streamed_cpu.proof_bytes != on_card.proof_bytes:
            fail(f"T = 2^{t_log2}: the streaming proves (card, CPU) differ from the resident prove")
        if streamed.meta.get("mode") != "streaming" or "host_compose" not in stages:
            fail(f"T = 2^{t_log2}: prove_streaming did not take the streaming host-columns route")
        log(f"[parity-small] T = 2^{t_log2}: prove_streaming on the card and on the CPU == StarkV1.prove; "
            f"stages (s): {_stages(stages)}")
        if t_log2 == 13:
            state["launches_small"] = launches
            if launches["ntt_small"] != 1:
                fail(f"T = 2^13: K5 must launch exactly once (the base inverse NTT), not {launches['ntt_small']} times")

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


# sha256 of the STARK proof at T = 2^20, b = 512, tau = 8 (every route, both
# packages): its first and last eight hex digits
STARK_SHA = ("e83c5efe", "53d0a8db")


def _cli_child(argv) -> dict:
    """Run one command line of the port's CLI in a child process
    (`chip_smoke.py --cli-child`) and return what it reports: the wall time
    of cli.main, the stages of its STARK prove, the kernel launch counts over
    it, the peak device memory and the child's own peak RSS (sampled)."""
    r = subprocess.run([sys.executable, os.path.abspath(__file__), "--cli-child", json.dumps(argv)],
                       capture_output=True, text=True, cwd=os.path.dirname(os.path.abspath(__file__)))
    if r.returncode != 0:
        fail(f"cli child {' '.join(argv[:4])} exited with {r.returncode}\n{r.stdout[-2000:]}{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def _rss_kib() -> int:
    """This process's resident set size now, in KiB (/proc/self/statm)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") // 1024


def _sample_peak_rss(peak: list, stop) -> None:
    """Keep the largest `_rss_kib()` in peak[0], sampled every 10 ms until
    `stop` is set. A sampled peak, because the two direct readings fail:
    getrusage's ru_maxrss carries the parent's peak into a child across fork
    and exec, and the card's machine has no VmHWM in /proc/self/status."""
    while not stop.wait(0.01):
        peak[0] = max(peak[0], _rss_kib())


def cli_child(argv) -> None:
    """The child of `_cli_child`: cli.main(argv) with every kernel's launch
    count set to 0 before, the STARK prove's stages collected, and one JSON
    line of the results last. As a rank (SEZKP_PROCESS_ID set), the rank's
    index replaces RANK in the arguments, so every rank writes its own file."""
    from sezkp_tpu_torch import cli
    from sezkp_tpu_torch.stark import backends

    rank = os.environ.get("SEZKP_PROCESS_ID")
    if rank is not None:
        argv = [a.replace("RANK", rank) for a in argv]

    stages = {}
    prove_v1 = backends.prove_v1
    backends.prove_v1 = lambda *a, **o: prove_v1(*a, timings=stages, **o)
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    peak, stop = [_rss_kib()], threading.Event()
    sampler = threading.Thread(target=_sample_peak_rss, args=(peak, stop), daemon=True)
    sampler.start()
    t0 = time.time()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        backends.prove_v1 = prove_v1
        stop.set()
        sampler.join()
    wall = time.time() - t0
    if rc not in (0, None):
        fail(f"cli {' '.join(argv[:4])} returned {rc}")
    print(json.dumps({"wall_s": wall, "stages": stages, "launches": {k: w.launches for k, w in wrappers.items()},
                      "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "peak_rss_kib": max(peak[0], _rss_kib())}), flush=True)


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
        # after the two STARK proves and the first verify have checked the
        # blocks file against the manifest, the later commands skip that pass
        assumed = [*common, "--assume-committed"]
        run(["simulate", "--t", str(1 << 20), "--b", "512", "--tau", "8", "--out-blocks", blocks_p])
        run(["commit", "--blocks", blocks_p, "--out", man_p])
        run(["verify-commit", "--blocks", blocks_p, "--manifest", man_p])

        # the resident and the streamed STARK prove on the same command line
        # but --stream, each in a child process of its own: its peak host RSS
        def stark_child(flags, out):
            t0 = time.time()
            r = _cli_child(["prove", "--backend", "stark", *flags, *common, "--out", j(out)])
            log(f"[cli] prove --backend stark {' '.join(flags)} (child): {time.time() - t0:.2f} s, cli.main "
                f"{r['wall_s']:.2f} s; stages (s): {_stages(r['stages'])}; launches {json.dumps(r['launches'])}; "
                f"peak device memory {r['peak_device_bytes']} bytes; peak host RSS {r['peak_rss_kib']} KiB")
            for k in ("blake3_compress", "ntt_phase_axis", "ntt_phase_batched", "ntt_phase_last"):
                if r["launches"][k] <= 0:
                    fail(f"kernel {k} was never launched by prove --backend stark {' '.join(flags)}")
            return r

        stark_launches = stark_child([], "stark.cbor")["launches"]
        run(["verify", "--backend", "stark", *common, "--proof", j("stark.cbor")])
        flipped(j("stark.cbor"), j("stark_bad.cbor"))
        rejected(["verify", "--backend", "stark", *assumed, "--proof", j("stark_bad.cbor")], "a flipped STARK proof file")
        if "host_compose" not in stark_child(["--stream"], "stark_stream.cbor")["stages"]:
            fail("prove --backend stark --stream did not take the streaming host-columns route")
        run(["verify", "--backend", "stark", *assumed, "--proof", j("stark_stream.cbor")])
        flipped(j("stark_stream.cbor"), j("stark_stream_bad.cbor"))
        rejected(["verify", "--backend", "stark", *assumed, "--proof", j("stark_stream_bad.cbor")],
                 "a flipped streamed STARK proof file")

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
        stream_file = core_io.read_proof_auto(j("stark_stream.cbor"))
        fold_file = core_io.read_proof_auto(j("fold.cbor"))
    stream_sha = hashlib.sha256(stream_file.proof_bytes).hexdigest()
    if stream_file.proof_bytes != stark_file.proof_bytes:
        fail("the streamed STARK proof file differs from the resident proof file")
    if not (stream_sha.startswith(STARK_SHA[0]) and stream_sha.endswith(STARK_SHA[1])):
        fail(f"the streamed STARK proof's sha256 {stream_sha} is not the resident proof's {'...'.join(STARK_SHA)}")
    if stream_file.meta.get("mode") != "streaming":
        fail(f"the streamed STARK artifact's meta {stream_file.meta} does not say mode streaming")
    log(f"[cli] streamed STARK proof file == resident proof file, sha256 {stream_sha}; meta {stream_file.meta}")
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


# ---------------------------- the sharded phase -----------------------------

SHARDED_NTT_LOGS = (13, 13)  # n1, n2: n = 2^26, the LDE of T = 2^23 (scripts/northstar_sharded.py)
SHARDED_ROOT_LOG2 = 23  # the LDE of the T = 2^20 prove
COMMIT_T_LOG2 = 18  # the commitments-sharded prove's trace (b = 512, tau = 8)
FULL_T_LOG2 = 20  # the fully sharded prove's trace in every world
NORTHSTAR_T_LOG2 = 23  # scripts/northstar_sharded.py's trace, in one world
# sha256 of the STARK proof at T = 2^23, b = 512, tau = 8 (single-card, every FRI mode)
NORTHSTAR_SHA = ("d132fa9c", "87b543d7")
INGEST_HOSTS = (1, 2, 3, 5)
K1_K4 = ("blake3_compress", "ntt_phase_axis", "ntt_phase_batched", "ntt_phase_last")
K1_K5 = K1_K4 + ("ntt_small",)
K1_K3 = K1_K4[:3]  # the kernels of the fully sharded prove (the local NTT phases are K2/K3)


def _sharded_values(k: int) -> np.ndarray:
    """2^k seeded field values (the same in every process)."""
    return np.random.default_rng(k).integers(0, 0xFFFFFFFF00000001, 1 << k, dtype=np.uint64)


def _counts_zero(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def _counts(wrappers, names=K1_K4) -> dict:
    return {k: wrappers[k].launches for k in names}


def _rank_prove(mesh, wrappers, blocks, man, tag: str, **options) -> dict:
    """One prove_v1_sharded on this rank, with the launch counts and the
    collective tally set to 0 just before and read just after: sha256,
    wall, stages, K1-K5 launches, peak device memory, and the tally by scope
    (commit, phase1, phase2, open)."""
    from sezkp_tpu_torch.parallel import distributed as D
    from sezkp_tpu_torch.parallel.engine import prove_v1_sharded
    from sezkp_tpu_torch.parallel.traffic import collective_bytes
    from sezkp_tpu_torch.stark.v1.proof import encode_proof

    dev = mesh.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _counts_zero(wrappers)
    mesh.tally.clear()
    D.barrier(tag)
    timings = {}
    t0 = time.time()
    proof = prove_v1_sharded(blocks, man.root, mesh, timings=timings, **options)
    torch.cuda.synchronize(dev)
    wall = time.time() - t0
    return dict(
        sha256=hashlib.sha256(encode_proof(proof)).hexdigest(), wall_s=wall, stages=timings,
        launches=_counts(wrappers, K1_K5), peak_device_bytes=torch.cuda.max_memory_allocated(dev),
        manifest_root=man.root.hex(),
        traffic={sc or "commit": collective_bytes(mesh, sc) for sc in ("", "phase1", "phase2", "open")})


def rank_child(job) -> None:
    """One rank of a world of the sharded phase (`chip_smoke.py --rank-child
    JSON`, started with the SEZKP_* variables set): the sharded NTT both
    ways, the sharded Merkle root, the commitments-sharded prove at
    T = 2^COMMIT_T_LOG2 and the fully sharded prove at T = 2^FULL_T_LOG2,
    and in the world the job names the fully sharded prove at
    T = 2^NORTHSTAR_T_LOG2 (rank 0 then proves that input on its card alone
    too); each with the launch counts set to 0 just before and read just
    after; one JSON line of the results last (and in the job's file)."""
    from sezkp_tpu_torch.parallel import distributed as D
    from sezkp_tpu_torch.parallel.commit_sharded import sharded_merkle_root_u64
    from sezkp_tpu_torch.parallel.mesh import make_global, replicated_pull
    from sezkp_tpu_torch.parallel.ntt_sharded import build_sharded_ntt

    D.ensure_initialized(device=job["device"], backend=job["backend"])
    mesh = D.global_mesh()
    wrappers = _wrappers()
    dev = mesh.device
    res = {"rank": mesh.rank, "size": mesh.size, "device": str(dev), "backend": mesh.backend, "ntt": {}}

    l1, l2 = job["ntt_logs"]
    x = make_global(mesh, 1, _sharded_values(l1 + l2).reshape(1 << l1, 1 << l2))
    for inverse in (False, True):
        f = build_sharded_ntt(mesh, l1, l2, inverse)
        _counts_zero(wrappers)
        torch.cuda.synchronize(dev)
        t0 = time.time()
        y = f(x)  # the first call builds this rank's tables
        torch.cuda.synchronize(dev)
        first_ms = (time.time() - t0) * 1e3
        launches = _counts(wrappers)
        walls, a2a = [], []
        for rep in range(3):
            D.barrier(f"ntt{int(inverse)}{rep}")
            tm = {}
            t0 = time.time()
            y = f(x, timings=tm)
            torch.cuda.synchronize(dev)
            walls.append((time.time() - t0) * 1e3)
            a2a.append(tm["all_to_all"] * 1e3)
        got = replicated_pull(mesh, y, 0)  # Y[k1, k2]: natural order is its transpose
        res["ntt"]["inverse" if inverse else "forward"] = dict(
            sha256=hashlib.sha256(np.ascontiguousarray(got.T).tobytes()).hexdigest(),
            first_ms=first_ms, wall_ms=sorted(walls)[1], all_to_all_ms=sorted(a2a)[1],
            walls_ms=walls, all_to_all_each_ms=a2a, launches=launches)
        del y, got
    del x

    v = _sharded_values(job["root_log2"])
    _counts_zero(wrappers)
    D.barrier("root")
    t0 = time.time()
    root = sharded_merkle_root_u64(v, mesh)
    torch.cuda.synchronize(dev)
    res["root"] = dict(hex=root.hex(), ms=(time.time() - t0) * 1e3, launches=_counts(wrappers))

    blocks, man, t_in = _make_input(1 << COMMIT_T_LOG2, 512, 8)
    res["prove"] = _rank_prove(mesh, wrappers, blocks, man, "commitments", commitments_only=True)
    del blocks
    blocks, man, t_in = _make_input(1 << FULL_T_LOG2, 512, 8)
    res["prove_full"] = _rank_prove(mesh, wrappers, blocks, man, "full")
    res["prove_full"]["input_s"] = t_in
    del blocks
    if job.get("northstar"):
        blocks, man, t_in = _make_input(1 << NORTHSTAR_T_LOG2, 512, 8)
        ns = _rank_prove(mesh, wrappers, blocks, man, "northstar")
        ns["input_s"] = t_in
        if mesh.rank == 0:  # the single-card prove of the same input, on this rank's card
            torch.cuda.empty_cache()
            art, wall, timings, launches, peak = _counted_prove(blocks, man.root)
            ns["single"] = dict(sha256=_sha(art), wall_s=wall, stages=timings, peak_device_bytes=peak)
            del art
        res["northstar"] = ns
        del blocks
    with open(os.path.join(job["out"], f"rank{mesh.rank}.json"), "w") as fh:
        json.dump(res, fh)
    D.barrier("done")
    torch.distributed.destroy_process_group()
    print(json.dumps(res), flush=True)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch_world(argv, d: int, env=None, timeout: int = 600) -> list:
    """argv as d ranks on the SEZKP_* contract (tcp://localhost, a free
    port); fails the run if a rank fails."""
    from sezkp_tpu_torch.parallel import distributed as D

    here = os.path.dirname(os.path.abspath(__file__))
    res = D.launch(argv, d, f"tcp://localhost:{_free_port()}", env=env, cwd=here, timeout=timeout)
    for r, (rc, so, se) in enumerate(res):
        if rc != 0:
            fail(f"rank {r} of {d} exited with {rc}\n{so[-2000:]}{se[-4000:]}")
    return res


def _sharded_worlds():
    """(name, ranks, backend, device): NCCL at one rank, gloo for ranks that
    share card 0, and NCCL across every card (one a rank: device None) where
    the host has several."""
    worlds = [("D=1 nccl", 1, "nccl", None), ("D=2 gloo, shared card", 2, "gloo", "cuda:0"),
              ("D=4 gloo, shared card", 4, "gloo", "cuda:0")]
    n = torch.cuda.device_count()
    if n >= 2:
        worlds.append((f"D={n} nccl, a card a rank", n, "nccl", None))
    return worlds


def _files_and_ingest(blocks, tmp: str, cbor_written, out: dict) -> None:
    """Host work beside the worlds (a thread): the blocks as CBOR for the CLI
    world (then `cbor_written` is set) and as JSONL, then
    commit_block_file_sharded of the JSONL file at every INGEST_HOSTS against
    the sequential commit_block_file."""
    from sezkp_tpu_torch.commit.merkle import commit_block_file
    from sezkp_tpu_torch.core import io as core_io
    from sezkp_tpu_torch.parallel.ingest import commit_block_file_sharded

    t0 = time.time()
    try:
        core_io.write_block_summaries_auto(os.path.join(tmp, "blocks.cbor"), blocks)
    finally:  # the CLI world waits for it, and fails on a missing file
        cbor_written.set()
    jsonl = os.path.join(tmp, "blocks.jsonl")
    core_io.write_block_summaries_jsonl(jsonl, blocks)
    out["files_s"] = time.time() - t0
    t0 = time.time()
    seq = commit_block_file(jsonl, jsonl + ".manifest.cbor")
    out["sequential_s"] = time.time() - t0
    for hosts in INGEST_HOSTS:
        t0 = time.time()
        sh = commit_block_file_sharded(jsonl, n_hosts=hosts)
        out[hosts] = dict(s=time.time() - t0, equal=(sh.root, sh.n_leaves) == (seq.root, seq.n_leaves))


def phase_sharded(state) -> None:
    """parallel/ on torch.distributed, one process a rank (children of this
    script): worlds of 1 (NCCL), 2 and 4 ranks sharing the card (gloo), and
    of every card where there are several (NCCL). In each: the sharded NTT
    at 2^26 both ways against the single-card forward_ntt / inverse_ntt, the
    sharded Merkle root of 2^23 values against the single-card and the host
    root, the T = 2^18 commitments-sharded prove against the single-process
    prove, the T = 2^20 fully sharded prove against the known sha256 and
    its collectives against the analytic model; in one world the fully
    sharded prove at T = 2^23 against the single-card prove. Beside them:
    the ingest of the T = 2^20 input's file at 1, 2, 3, 5 hosts, and the
    CLI's prove --backend stark as two ranks sharing the card."""
    import tempfile

    from sezkp_tpu_torch.commit.merkle import write_manifest_auto
    from sezkp_tpu_torch.core import io as core_io
    from sezkp_tpu_torch.crypto import blake3 as b3
    from sezkp_tpu_torch.ops import _kernels
    from sezkp_tpu_torch.ops import blake3_torch as BT
    from sezkp_tpu_torch.ops import goldilocks as G
    from sezkp_tpu_torch.ops import goldilocks_torch as FT
    from sezkp_tpu_torch.ops import ntt_torch as NT
    from sezkp_tpu_torch.stark.backends import StarkV1

    _kernels.lib()  # built once here, before any rank starts
    torch.cuda.empty_cache()
    t_ref = time.time()
    l1, l2 = SHARDED_NTT_LOGS
    x = FT.pack(_sharded_values(l1 + l2), "cuda")
    want_ntt, single_ms = {}, {}
    for inverse in (False, True):
        fn = NT.inverse_ntt if inverse else NT.forward_ntt
        y = fn(x)
        want_ntt["inverse" if inverse else "forward"] = hashlib.sha256(FT.unpack(y).tobytes()).hexdigest()
        single_ms["inverse" if inverse else "forward"] = time_cuda(lambda: fn(x), 3)
        del y
    del x
    log(f"[sharded] single card at 2^{l1 + l2}: forward_ntt {single_ms['forward']:.3f} ms, inverse_ntt "
        f"{single_ms['inverse']:.3f} ms; sha256 {want_ntt['forward'][:16]}.., {want_ntt['inverse'][:16]}..")

    v = _sharded_values(SHARDED_ROOT_LOG2)
    t0 = time.time()
    cv = BT.hash_leaves_u64_planes(FT.pack(v, "cuda"))
    while cv.shape[1] > 1:
        cv = BT.parent_level_planes(cv)
    card_root = BT.cv_planes_to_bytes(cv)[0].tobytes()
    card_s = time.time() - t0
    t0 = time.time()
    host_root = b3.merkle_root_leaves(b3.hash_many(G.to_le_bytes(v).reshape(-1, 8)))
    log(f"[sharded] Merkle root of 2^{SHARDED_ROOT_LOG2} values: single card {card_s:.3f} s, host "
        f"{time.time() - t0:.2f} s, {card_root.hex()[:16]}..")
    if card_root != host_root:
        fail("the single-card Merkle root differs from the host root")
    del v, cv

    blocks_c, man_c, _ = _make_input(1 << COMMIT_T_LOG2, 512, 8)
    sha_commit = _sha(StarkV1.prove(blocks_c, man_c.root))
    del blocks_c
    blocks, man, _ = _make_input(1 << FULL_T_LOG2, 512, 8)
    art = StarkV1.prove(blocks, man.root)
    if not (_sha(art).startswith(STARK_SHA[0]) and _sha(art).endswith(STARK_SHA[1])):
        fail(f"the single-process prove's sha256 {_sha(art)} is not the known one")
    StarkV1.verify(art, blocks, man.root)
    try:
        StarkV1.verify(_tamper(art), blocks, man.root)
    except Exception as e:  # the verifier's rejection is what this step wants
        log(f"[sharded] the single-process T = 2^20 proof verifies; a tampered copy is rejected: "
            f"{type(e).__name__}")
    else:
        fail("tampered proof was accepted")

    log(f"[sharded] references made in {time.time() - t_ref:.1f} s")
    here = os.path.abspath(__file__)
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        j = lambda name: os.path.join(tmp, name)
        write_manifest_auto(j("manifest.cbor"), man)
        core_io.write_proof_auto(j("single.cbor"), art)
        ingest, cbor_written = {}, threading.Event()
        host_thread = threading.Thread(target=_files_and_ingest, args=(blocks, tmp, cbor_written, ingest))
        host_thread.start()
        del blocks

        worlds = _sharded_worlds()
        northstar = worlds[-1][0] if torch.cuda.device_count() >= 2 else worlds[0][0]
        for name, d, backend, device in worlds:
            out = j(f"world{d}{backend}")
            os.makedirs(out)
            job = dict(backend=backend, device=device, ntt_logs=SHARDED_NTT_LOGS, root_log2=SHARDED_ROOT_LOG2,
                       out=out, northstar=name == northstar)
            t0 = time.time()
            _launch_world([sys.executable, here, "--rank-child", json.dumps(job)], d)
            ranks = []
            for r in range(d):
                with open(os.path.join(out, f"rank{r}.json")) as fh:
                    ranks.append(json.load(fh))
            results[name] = ranks
            log(f"[sharded] world {name}: {time.time() - t0:.1f} s (ranks started, run, ended)"
                + ("; shared-card times are correctness runs, not scaling figures" if "shared" in name else ""))
            for res in ranks:
                r = res["rank"]
                if res["backend"] != backend or res["size"] != d:
                    fail(f"{name} rank {r}: backend {res['backend']}, size {res['size']}")
                for way, nt in res["ntt"].items():
                    log(f"[sharded] {name} rank {r} ({res['device']}) NTT 2^{l1 + l2} {way}: wall {nt['wall_ms']:.3f} ms "
                        f"(median of 3: {', '.join(f'{w:.3f}' for w in nt['walls_ms'])}), all-to-all "
                        f"{nt['all_to_all_ms']:.3f} ms, first call {nt['first_ms']:.1f} ms; launches "
                        f"{json.dumps(nt['launches'])}")
                    if nt["sha256"] != want_ntt[way]:
                        fail(f"{name} rank {r}: the sharded {way} NTT differs from the single-card one")
                    if nt["launches"]["ntt_phase_axis"] <= 0 or nt["launches"]["ntt_phase_batched"] <= 0:
                        fail(f"{name} rank {r}: K2 or K3 did not launch in the sharded NTT")
                rt = res["root"]
                log(f"[sharded] {name} rank {r} Merkle root 2^{SHARDED_ROOT_LOG2}: {rt['ms']:.1f} ms; launches "
                    f"{json.dumps(rt['launches'])}")
                if rt["hex"] != card_root.hex() or rt["launches"]["blake3_compress"] <= 0:
                    fail(f"{name} rank {r}: the sharded root differs from the single-card root, or K1 did not launch")
                pv = res["prove"]
                log(f"[sharded] {name} rank {r} prove T = 2^{COMMIT_T_LOG2} (commitments sharded): wall "
                    f"{pv['wall_s']:.2f} s; stages (s): {_stages(pv['stages'])}; peak device memory "
                    f"{pv['peak_device_bytes']} bytes; launches {json.dumps(pv['launches'])}; sha256 {pv['sha256']}")
                if pv["sha256"] != sha_commit:
                    fail(f"{name} rank {r}: the commitments-sharded proof differs from the single-process proof")
                for k in K1_K4:
                    if pv["launches"][k] <= 0:
                        fail(f"{name} rank {r}: kernel {k} was never launched by the commitments-sharded prove")
                _check_full_prove(name, r, d, res["prove_full"], FULL_T_LOG2, _sha(art), man.root.hex())
                if "northstar" in res:
                    ns = res["northstar"]
                    if r == 0:
                        sg = ns["single"]
                        log(f"[sharded] {name} T = 2^{NORTHSTAR_T_LOG2}: the single-card prove on rank 0's card: "
                            f"wall {sg['wall_s']:.2f} s; stages (s): {_stages(sg['stages'])}; peak device memory "
                            f"{sg['peak_device_bytes']} bytes; sha256 {sg['sha256']}")
                        sha_ns = sg["sha256"]
                        if not (sha_ns.startswith(NORTHSTAR_SHA[0]) and sha_ns.endswith(NORTHSTAR_SHA[1])):
                            fail(f"the single-card T = 2^{NORTHSTAR_T_LOG2} proof's sha256 {sha_ns} is not the "
                                 f"known {NORTHSTAR_SHA[0]}...{NORTHSTAR_SHA[1]}")
                    _check_full_prove(name, r, d, ns, NORTHSTAR_T_LOG2, sha_ns, None)

        # the CLI as two ranks sharing the card: every rank writes its own file
        with open(j("single.cbor"), "rb") as fh:
            single = fh.read()
        cbor_written.wait()
        t0 = time.time()
        # the cli phase checks the file against the manifest; here each rank reads it once
        argv = ["prove", "--backend", "stark", "--blocks", j("blocks.cbor"), "--manifest", j("manifest.cbor"),
                "--assume-committed", "--out", j("cli_RANK.cbor")]
        cli_ranks = _launch_world([sys.executable, here, "--cli-child", json.dumps(argv)], 2,
                                  env={"SEZKP_DIST_BACKEND": "gloo"})
        for r, (_, so, _) in enumerate(cli_ranks):
            rep = json.loads(so.strip().splitlines()[-1])
            with open(j(f"cli_{r}.cbor"), "rb") as fh:
                same = fh.read() == single
            log(f"[sharded] CLI prove --backend stark, rank {r} of 2 (gloo, shared card): cli.main "
                f"{rep['wall_s']:.2f} s; stages (s): {_stages(rep['stages'])}; launches "
                f"{json.dumps(rep['launches'])}; file == single-process file: {same}")
            if not same:
                fail(f"the CLI's rank {r} wrote another file than the single-process prove")
        log(f"[sharded] CLI world: {time.time() - t0:.1f} s")
        host_thread.join()
    if "files_s" not in ingest:
        fail("writing the blocks files failed")
    log(f"[sharded] beside the worlds: the blocks written as CBOR and JSONL in {ingest['files_s']:.1f} s; "
        f"ingest of the 2048-block JSONL file: sequential commit_block_file {ingest['sequential_s']:.2f} s; "
        + "; ".join(f"{h} hosts {ingest[h]['s']:.2f} s, equal {ingest[h]['equal']}" for h in INGEST_HOSTS))
    if not all(ingest.get(h, {}).get("equal") for h in INGEST_HOSTS):
        fail("the sharded ingest's root differs from commit_block_file's")
    state["launches_sharded"] = {
        name: [{"ntt": {w: nt["launches"] for w, nt in res["ntt"].items()}, "root": res["root"]["launches"],
                "prove": res["prove"]["launches"], "prove_full": res["prove_full"]["launches"],
                **({"northstar": res["northstar"]["launches"]} if "northstar" in res else {})}
               for res in ranks]
        for name, ranks in results.items()
    }


def _traffic_against_model(tr: dict, t_log2: int, d: int) -> list:
    """The fully sharded prove's tally (one rank) against
    traffic.analytic_phase_bytes: (term, measured, model, equal) rows. The
    relations of the two ppermute terms are those of
    tests/test_torch_parallel_full.py (the model's halo term counts each
    element's two u32 planes again; its fold term is what a rank hands to
    the fold's ppermutes, whose outputs are twice that)."""
    from sezkp_tpu_torch.parallel.traffic import analytic_phase_bytes

    m = analytic_phase_bytes(t_log2, 3, d, tau=8)
    p1, p2 = m["phase1"], m["phase2"]
    a2a = sum(p1[k] for k in ("intt_input_a2a", "intt_internal_a2a", "coeff_relayout_a2a",
                              "lde_internal_a2a", "natural_order_a2a"))
    get = lambda sc, op, key: tr[sc].get(op, {}).get(key, 0)
    rows = [
        ("phase 1 all-to-all link bytes", get("phase1", "all-to-all", "link_bytes"), a2a),
        ("phase 1 all-gather link bytes", get("phase1", "all-gather", "link_bytes"), p1["roots_all_gather"]),
        ("phase 1 halo ppermute bytes x 2", 2 * get("phase1", "collective-permute", "bytes"),
         p1["halo_ppermute"] if d > 1 else 0),
        ("phase 2 all-gather link bytes", get("phase2", "all-gather", "link_bytes"),
         p2["tail_all_gather"] + p2["roots_all_gather"]),
        ("phase 2 fold ppermute bytes / 2", get("phase2", "collective-permute", "bytes") / 2,
         p2["fold_ppermutes"] if d > 1 else 0),
    ]
    return [(name, got, want, got == want) for name, got, want in rows]


def _check_full_prove(name, r, d, pv, t_log2, want_sha, want_root) -> None:
    """Log and check one rank's fully sharded prove: its bytes, K1-K3
    launched, its tally against the analytic model."""
    log(f"[sharded] {name} rank {r} prove T = 2^{t_log2} (fully sharded): wall {pv['wall_s']:.2f} s "
        f"(input made in {pv['input_s']:.1f} s); stages (s): {_stages(pv['stages'])}; peak device memory "
        f"{pv['peak_device_bytes']} bytes; launches {json.dumps(pv['launches'])}; sha256 {pv['sha256']}")
    log(f"[sharded] {name} rank {r} T = 2^{t_log2} collectives by scope: {json.dumps(pv['traffic'])}")
    rows = _traffic_against_model(pv["traffic"], t_log2, d)
    log(f"[sharded] {name} rank {r} T = 2^{t_log2} tally against analytic_phase_bytes: "
        + "; ".join(f"{n} {g} vs {w}" for n, g, w, _ in rows))
    if pv["sha256"] != want_sha or (want_root is not None and pv["manifest_root"] != want_root):
        fail(f"{name} rank {r}: the fully sharded T = 2^{t_log2} proof differs from the single-card proof")
    for k in K1_K3:
        if pv["launches"][k] <= 0:
            fail(f"{name} rank {r}: kernel {k} was never launched by the fully sharded prove")
    if "sharded_phase1" not in pv["stages"] or "host_compose" in pv["stages"]:
        fail(f"{name} rank {r}: the prove did not take the sharded hot path")
    for n, g, w, ok in rows:
        if not ok:
            fail(f"{name} rank {r}: {n} {g} differ from the model's {w}")


# the proves of the prove-large phase: prove_v1 options on top of the defaults
LARGE_MODES = {
    "default": {},
    "resident": dict(fri_chunked_min_log2=64),
    "chunked": dict(fri_chunked_min_log2=0),
    "release": dict(release_planes_bytes=0),
}


def _fri_alone(lde_log2: int) -> None:
    """DeviceFri by itself on 2^lde_log2 seeded field values on the card, in
    both modes, twice each: wall of its commit and 30 openings, and its peak
    device memory above its input; the two modes' roots, final value and
    queries must be equal."""
    from sezkp_tpu_torch.stark.v1.fri_device import DeviceFri

    gen = torch.Generator(device="cuda")
    gen.manual_seed(lde_log2)
    vals = torch.randint(0, 1 << 62, (1 << lde_log2,), generator=gen, device="cuda", dtype=torch.int64)
    rng = np.random.default_rng(lde_log2)
    betas = [int(x) for x in rng.integers(0, 1 << 62, lde_log2)]
    rows = [int(x) for x in rng.integers(0, 1 << lde_log2, 30)]
    want = None
    for mode, threshold in (("resident", 64), ("chunked", 0)) * 2:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        eng = DeviceFri(vals, chunked_min_log2=threshold)
        got = ([eng.commit_layer0()] + eng.commit_rest(betas), eng.final_value_le(),
               [(q.positions, q.pairs) for q in eng.open_queries(rows)])
        torch.cuda.synchronize()
        wall = time.time() - t0
        log(f"[prove-large] FRI alone at 2^{lde_log2}, {mode}: {wall:.3f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() - base} bytes above its input")
        if eng.chunked != (mode == "chunked"):
            fail(f"DeviceFri took the wrong mode at 2^{lde_log2}")
        del eng
        if want is None:
            want = got
        elif got != want:
            fail(f"FRI alone at 2^{lde_log2}: the {mode} mode's roots or queries differ")


def phase_prove_large(state) -> None:
    """The largest proves: for each size in --large-t, each mode of
    --large-modes in turn (the first is that size's first prove, which builds
    its tables), all byte-identical; the first verified and tampered."""
    from sezkp_tpu_torch.stark.backends import StarkV1
    from sezkp_tpu_torch.stark.v1.fri_device import FRI_CHUNKED_MIN_LOG2
    from sezkp_tpu_torch.stark.v1.params import BLOWUP

    b, tau = 512, 8
    for t_log2 in state["large_t"]:
        lde_log2 = t_log2 + BLOWUP.bit_length() - 1
        blocks, man, t_in = _make_input(1 << t_log2, b, tau)
        log(f"[prove-large] T = 2^{t_log2}, b = {b}, tau = {tau} (LDE 2^{lde_log2}): {len(blocks)} blocks, "
            f"input made in {t_in:.1f} s")
        first = None
        for mode in state["large_modes"]:
            options = LARGE_MODES[mode]
            chunked = options.get("fri_chunked_min_log2", FRI_CHUNKED_MIN_LOG2) <= lde_log2
            art, wall, timings, launches, peak = _counted_prove(blocks, man.root, **options)
            ran = "fri_commit_chunked" in timings
            log(f"[prove-large] T = 2^{t_log2} {mode} ({'chunked' if ran else 'resident'} FRI): wall {wall:.2f} s; "
                f"stages (s): {_stages(timings)}; peak device memory {peak} bytes; launches "
                f"{json.dumps(launches)}; proof {len(art.proof_bytes)} bytes, sha256 {_sha(art)}")
            if "device_compose" not in timings:
                fail("the prove did not take the device-resident route")
            if ran != chunked:
                fail(f"mode {mode}: the FRI took its {'chunked' if ran else 'resident'} mode")
            for k in ("blake3_compress", "ntt_phase_axis", "ntt_phase_batched", "ntt_phase_last"):
                if launches[k] <= 0:
                    fail(f"kernel {k} was never launched by the prove")
            if launches["deep_divide"] != 1:
                fail(f"K12 deep_divide must launch exactly once a prove, not {launches['deep_divide']} times")
            _check_k13(launches, timings, lde_log2, f"in the {mode} prove")
            if t_log2 == state["large_t"][-1] and mode == state["large_modes"][0]:
                state["launches_large"] = launches
            if first is None:
                first = art
                t0 = time.time()
                StarkV1.verify(art, blocks, man.root)
                log(f"[prove-large] verify OK in {time.time() - t0:.2f} s")
                try:
                    StarkV1.verify(_tamper(art), blocks, man.root)
                except Exception as e:  # the verifier's rejection is what this step wants
                    log(f"[prove-large] tampered proof rejected: {type(e).__name__}: {str(e)[:80]}")
                else:
                    fail("tampered proof was accepted")
            elif art.proof_bytes != first.proof_bytes:
                fail(f"T = 2^{t_log2}: the {mode} prove differs from the {state['large_modes'][0]} prove")
            del art
        if t_log2 == 24 and not any(
            LARGE_MODES[m].get("fri_chunked_min_log2", FRI_CHUNKED_MIN_LOG2) <= lde_log2
            for m in state["large_modes"]
        ):
            fail("no prove at T = 2^24 took the chunked FRI")
        del blocks, man, first
        torch.cuda.empty_cache()
        _fri_alone(lde_log2)
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of: " + ", ".join(ALL_PHASES + EXTRA_PHASES))
    ap.add_argument("--sass-csrc", default=None,
                    help="sass phase: the ops/csrc directory of another checkout to compare with")
    ap.add_argument("--large-t", default="24",
                    help="prove-large phase: comma-separated log2 trace lengths (b = 512, tau = 8)")
    ap.add_argument("--large-modes", default="default,resident,chunked",
                    help="prove-large phase: the proves of each size, in order, from: "
                         + ", ".join(LARGE_MODES))
    ap.add_argument("--cli-child", default=None, metavar="JSON",
                    help="run one CLI command line (a JSON list) and print its RSS, stages and launches "
                         "(the cli phase's child processes)")
    ap.add_argument("--rank-child", default=None, metavar="JSON",
                    help="run one rank of a world of the sharded phase (started with the SEZKP_* "
                         "variables set; the phase's child processes)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in ALL_PHASES + EXTRA_PHASES:
            fail(f"unknown phase {p}")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port on the card only",
              file=sys.stderr)
        sys.exit(2)

    if args.cli_child is not None:
        cli_child(json.loads(args.cli_child))
        return
    if args.rank_child is not None:
        rank_child(json.loads(args.rank_child))
        return
    state = {"sass_csrc": args.sass_csrc, "large_t": [int(t) for t in args.large_t.split(",") if t],
             "large_modes": [m for m in args.large_modes.split(",") if m]}
    for m in state["large_modes"]:
        if m not in LARGE_MODES:
            fail(f"unknown prove-large mode {m}")
    t_start = time.time()
    run = {"env": phase_env, "kernels": phase_kernels, "prove": phase_prove,
           "parity-small": phase_parity_small, "fold": phase_fold,
           "crossover": phase_crossover, "probes": phase_probes, "cli": phase_cli,
           "sharded": phase_sharded, "prove-large": phase_prove_large,
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
        # K1-K4: the count over the T = 2^20 STARK prove; K5, which only a
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
            counted = "launches_small" if name == "ntt_small" else "launches"
            k["launches"] = state[counted][name] if counted in state else None
            if "launches_large" in state and name in state["launches_large"]:
                # K1-K4 over the first prove of the prove-large phase's largest size
                k["launches_prove_large"] = state["launches_large"][name]
            if "launches_sharded" in state and name in K1_K4:
                # K1-K4 on every rank of every world of the sharded phase: over
                # one sharded NTT each way, the sharded root, the commitments-sharded
                # prove, the fully sharded prove and the north star (one world)
                k["launches_sharded"] = {
                    world: [{"ntt": {w: c[name] for w, c in r["ntt"].items()},
                             **{key: r[key][name] for key in r if key != "ntt"}} for r in ranks]
                    for world, ranks in state["launches_sharded"].items()}
        kernels.append(k)
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

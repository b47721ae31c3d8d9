"""What the probes share: the device line, timing, the data-sheet peaks."""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch

from ..ops import goldilocks_torch as FT
from ..ops._kernels import resolve_device

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: int8 on the
# tensor cores, and the HBM3 memory rate
INT8_PEAK_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12


def add_common_args(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; raises where there is none)")
    ap.add_argument("--iters", type=int, default=10, help="timed repetitions per line")


def device_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "device: cpu (plain versions; times are host-clock, not the card's)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[device.index or 0].strip()


def open_probe(args) -> torch.device:
    device = resolve_device(args.device)
    print(device_line(device), flush=True)
    return device


def timeit(fn, device: torch.device, iters: int = 10) -> float:
    """Seconds per call after one warm-up: CUDA events around `iters`
    back-to-back calls on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters * 1e-3


def rand_field(shape, seed: int, device) -> torch.Tensor:
    """Random canonical field elements from a numpy seed."""
    a = np.random.default_rng(seed).integers(0, FT.P_INT, shape, dtype=np.uint64)
    return FT.pack(a, device)


def rand_i8(shape, seed: int, device) -> torch.Tensor:
    """Random int8 in [-128, 127], made on the device from a seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(-128, 128, shape, generator=gen, device=device, dtype=torch.int16).to(torch.int8)


def tops(macs: float, seconds: float) -> str:
    rate = 2 * macs / seconds
    return f"{rate / 1e12:7.1f} TOPS ({100 * rate / INT8_PEAK_OPS:5.1f} % of the {INT8_PEAK_OPS / 1e12:.0f} TOPS dense int8 data-sheet peak)"


def int_mm_sum(w: torch.Tensor, x: torch.Tensor, nrep: int) -> torch.Tensor:
    """The library's yardstick for K8: nrep `torch._int_mm` calls (cuBLASLt)
    plus the adds. Timed beside the kernels, used nowhere else in the port."""
    m = w.shape[0] // nrep
    acc = torch._int_mm(w[:m], x)
    for j in range(1, nrep):
        acc += torch._int_mm(w[j * m : (j + 1) * m], x)
    return acc

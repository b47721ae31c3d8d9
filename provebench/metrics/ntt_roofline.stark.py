"""Share of the HBM roofline that the NTT kernels K2-K5 reach: the least
bytes of every NTT the window's proves ran (one read and one write of n
8-byte elements, 16 n bytes, whatever the number of phases: the inverse NTT
of the n-row base domain and the coset NTT of blow-up x n points a prove)
at the data sheet's 3.35 TB/s, over the profiler's device time of all K2-K5
launches in the window."""

import re

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet
NTT_KERNELS = re.compile(r"ntt_(phase_axis|phase_batched|phase_last|small)_kernel")


def read(run):
    if not run.device_events or not run.proves:
        return None
    spent = sum(min(e, run.window_end) - max(b, run.window_start)
                for name, b, e in run.device_events
                if NTT_KERNELS.search(name) and e > run.window_start and b < run.window_end)
    if spent <= 0:
        return None
    blowup = run.cell.config["blowup"]
    least = sum(16 * p["steps"] * (1 + blowup) for p in run.proves)
    return 100.0 * least / HBM_BYTES_PER_S / spent

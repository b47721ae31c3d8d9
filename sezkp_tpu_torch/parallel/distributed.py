"""Multi-process runtime initialization and the global mesh.

Counterpart of sezkp_tpu/parallel/distributed.py on ``torch.distributed``.
One rank is one process that owns one device. Launch model (one process per
rank), the same environment contract as the JAX package:

    SEZKP_COORDINATOR=host0:9955 SEZKP_NUM_PROCESSES=4 SEZKP_PROCESS_ID=$i \\
        python -m sezkp_tpu_torch prove --backend stark ...

or programmatically::

    from sezkp_tpu_torch.parallel.distributed import ensure_initialized, global_mesh
    ensure_initialized()                # no-op without the variables
    mesh = global_mesh()                # 1-D mesh over every rank

``SEZKP_COORDINATOR`` is rank 0's ``host:port`` (a TCP store there), or a
store URL (``tcp://host:port``, ``file:///path``). The backend is NCCL for
ranks on CUDA cards (one card a rank, ``cuda:(rank % cards)``) and gloo for
ranks on the CPU; ranks that share a card pass ``backend="gloo"`` (or set
``SEZKP_DIST_BACKEND=gloo``), since NCCL refuses two ranks of one
communicator on one card. The backend is chosen once, here, and never
switched on an error.

The JAX package's ``sync_execute`` and shared compile cache answer XLA
compile skew between processes; the port has no such compile, so neither is
carried. Nothing here initialises at import.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

ENV_COORDINATOR = "SEZKP_COORDINATOR"
ENV_NUM_PROCESSES = "SEZKP_NUM_PROCESSES"
ENV_PROCESS_ID = "SEZKP_PROCESS_ID"
# the port's own: "nccl" or "gloo" in place of the device's default
ENV_BACKEND = "SEZKP_DIST_BACKEND"

# Timeouts (seconds), with the JAX package's defaults: the rendezvous of all
# ranks (init), a collective waiting for its peers (heartbeat), a barrier
# (shutdown). Overridable per deployment via the environment.
ENV_INIT_TIMEOUT = "SEZKP_DIST_INIT_TIMEOUT_S"
ENV_HEARTBEAT_TIMEOUT = "SEZKP_DIST_HEARTBEAT_TIMEOUT_S"
ENV_SHUTDOWN_TIMEOUT = "SEZKP_DIST_SHUTDOWN_TIMEOUT_S"
DEFAULT_INIT_TIMEOUT_S = 900
DEFAULT_HEARTBEAT_TIMEOUT_S = 600
DEFAULT_SHUTDOWN_TIMEOUT_S = 1800

_store = None
_device = None


def _seconds(env: str, default: int) -> datetime.timedelta:
    return datetime.timedelta(seconds=int(os.environ.get(env, default)))


def _make_store(coordinator: str, num_processes: int, process_id: int):
    """The key-value store every rank meets at (rank 0 hosts a TCP store)."""
    import torch.distributed as dist

    timeout = _seconds(ENV_INIT_TIMEOUT, DEFAULT_INIT_TIMEOUT_S)
    if coordinator.startswith("file://"):
        return dist.FileStore(coordinator[len("file://"):], num_processes)
    if coordinator.startswith("tcp://"):
        coordinator = coordinator[len("tcp://"):]
    host, port = coordinator.rsplit(":", 1)
    return dist.TCPStore(host, int(port), num_processes, is_master=process_id == 0,
                         timeout=timeout)


def ensure_initialized(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
    backend: Optional[str] = None,
) -> bool:
    """Join the multi-process runtime if configured; else no-op.

    Resolution order: explicit args > SEZKP_* env vars. Returns True when a
    multi-process runtime is (already) active, False without configuration
    (nothing touched). `device`: None = this rank's CUDA card (raises
    without one), "cpu" for CPU ranks; `backend` (or SEZKP_DIST_BACKEND):
    default "nccl" on the card, "gloo" on the CPU."""
    global _store, _device
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    num_str = os.environ.get(ENV_NUM_PROCESSES)
    num_processes = num_processes if num_processes is not None else (
        int(num_str) if num_str else None
    )
    pid_str = os.environ.get(ENV_PROCESS_ID)
    process_id = process_id if process_id is not None else (
        int(pid_str) if pid_str else None
    )
    if coordinator is None and num_processes is None:
        return False
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            f"{ENV_COORDINATOR}, {ENV_NUM_PROCESSES} and {ENV_PROCESS_ID} must all be set"
        )
    from ..ops._kernels import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or os.environ.get(ENV_BACKEND) or ("nccl" if dev.type == "cuda" else "gloo")
    store = _make_store(coordinator, num_processes, process_id)
    dist.init_process_group(
        backend, store=store, world_size=num_processes, rank=process_id,
        timeout=_seconds(ENV_HEARTBEAT_TIMEOUT, DEFAULT_HEARTBEAT_TIMEOUT_S),
    )
    _store, _device = store, dev
    return True


def local_device():
    """This rank's device as `ensure_initialized` chose it (None before)."""
    return _device


_barrier_seq = 0


def barrier(tag: str, timeout_s: Optional[int] = None) -> None:
    """Barrier of every rank on the store (no-op in a single process): no
    collective, so it holds for any backend, ranks that share a card on NCCL
    included, with a timeout of our choosing. Ids must be unique per use;
    every rank calls in the same program order, so a global sequence number
    keeps ids aligned."""
    global _barrier_seq
    import torch.distributed as dist

    if _store is None or not dist.is_initialized():
        return
    if timeout_s is None:
        timeout_s = int(os.environ.get(ENV_SHUTDOWN_TIMEOUT, DEFAULT_SHUTDOWN_TIMEOUT_S))
    _barrier_seq += 1
    key = f"sezkp/{tag}/{_barrier_seq}"
    if _store.add(key, 1) == dist.get_world_size():
        _store.set(key + "/go", "1")
    _store.wait([key + "/go"], datetime.timedelta(seconds=timeout_s))


def _world() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_coordinator() -> bool:
    """True on the process that should write artifacts (rank 0)."""
    return _world()[0] == 0


def global_mesh(n_devices: Optional[int] = None, device=None):
    """1-D mesh over every rank (each owning its device; see make_mesh)."""
    from .mesh import make_mesh

    return make_mesh(n_devices, device)


def launch(argv, num_processes: int, coordinator: str, *, env=None, cwd=None,
           timeout: Optional[float] = None) -> list:
    """Run `argv` once a rank, as child processes started together with the
    SEZKP_* contract set (rank i gets SEZKP_PROCESS_ID=i) plus `env`; wait for
    every one (`timeout` seconds each, then every child is killed and
    TimeoutExpired raised) and return [(returncode, stdout, stderr)] in rank
    order. Output goes through files, so no rank blocks on a full pipe while
    its peers wait for it in a collective."""
    import subprocess
    import tempfile

    procs, files = [], []
    try:
        for pid in range(num_processes):
            child_env = dict(os.environ, **(env or {}))
            child_env.update({ENV_COORDINATOR: coordinator, ENV_NUM_PROCESSES: str(num_processes),
                              ENV_PROCESS_ID: str(pid)})
            fo, fe = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
            files.append((fo, fe))
            procs.append(subprocess.Popen(argv, env=child_env, cwd=cwd, stdout=fo, stderr=fe))
        out = []
        for p, (fo, fe) in zip(procs, files):
            p.wait(timeout=timeout)
            fo.seek(0)
            fe.seek(0)
            out.append((p.returncode, fo.read(), fe.read()))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fo, fe in files:
            fo.close()
            fe.close()


def process_shard_bounds(n_items: int) -> tuple:
    """[start, end) of this process's contiguous shard of n_items."""
    i, p = _world()
    return n_items * i // p, n_items * (i + 1) // p

"""Guard: the port imports torch, never jax and nothing of sezkp_tpu; importing
it neither imports triton nor starts a kernel build."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sezkp_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "sezkp_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _dirs, names in os.walk(PKG):
        if "_build" in d.split(os.sep):
            continue
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_found():
    files = _port_files()
    rel = {os.path.relpath(f, ROOT) for f in files}
    assert "chip_smoke.py" in rel
    for must in (
        "sezkp_tpu_torch/ops/blake3_torch.py",
        "sezkp_tpu_torch/ops/ntt_torch.py",
        "sezkp_tpu_torch/stark/v1/prover.py",
        "sezkp_tpu_torch/stark/v1/columns_device.py",
        "sezkp_tpu_torch/convert.py",
        "sezkp_tpu_torch/ops/ntt_digits_torch.py",
        "sezkp_tpu_torch/cli.py",
        "sezkp_tpu_torch/__main__.py",
        "sezkp_tpu_torch/core/io.py",
        "sezkp_tpu_torch/trace/io.py",
        "sezkp_tpu_torch/trace/stream.py",
        "sezkp_tpu_torch/stark/iop.py",
        "sezkp_tpu_torch/stark/v0.py",
        "sezkp_tpu_torch/utils/tracing.py",
        "sezkp_tpu_torch/utils/config.py",
        "sezkp_tpu_torch/probes/mxu_peak.py",
        "sezkp_tpu_torch/probes/ntt_breakdown.py",
        "sezkp_tpu_torch/probes/twiddle_fold_ab.py",
        "sezkp_tpu_torch/probes/profile_ntt.py",
    ):
        assert must in rel


def test_no_import_of_jax_or_reference_package():
    bad = []
    for path in _port_files():
        for name in _imports(path):
            top = name.split(".")[0]
            if top in FORBIDDEN:
                bad.append((os.path.relpath(path, ROOT), name))
    assert not bad, f"forbidden imports in the port: {bad}"


def test_import_is_inert():
    """Importing every module of the port (in a fresh interpreter) pulls in
    neither jax nor triton nor the JAX package, and builds no CUDA kernel."""
    mods = []
    for path in _port_files():
        rel = os.path.relpath(path, ROOT)
        if rel == "chip_smoke.py":
            continue
        mod = rel[:-3].replace(os.sep, ".")
        if mod.endswith(".__main__"):
            continue  # importing it runs the command line
        if mod.endswith(".__init__"):
            mod = mod[: -len(".__init__")]
        mods.append(mod)
    code = (
        "import importlib, sys, glob, os\n"
        f"mods = {mods!r}\n"
        f"built = os.path.join({PKG!r}, '_build', 'libsezkp_kernels_*')\n"
        "before = sorted(glob.glob(built))\n"
        "for m in mods: importlib.import_module(m)\n"
        "from sezkp_tpu_torch.ops import _kernels\n"
        "assert _kernels._lib is None, 'kernel library loaded at import'\n"
        "assert sorted(glob.glob(built)) == before, 'kernels built at import'\n"
        "from sezkp_tpu_torch.utils import cbor\n"
        "assert cbor.native.cache_info().currsize == 0, 'CBOR extension loaded at import'\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'triton', 'sezkp_tpu')]\n"
        "assert not bad, bad\n"
        "print('inert', len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "inert" in r.stdout


def test_default_device_is_the_card_and_raises_without_one():
    import torch

    from sezkp_tpu_torch.stark.v1 import prover

    if torch.cuda.is_available():
        assert prover.resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            prover.resolve_device(None)
    assert prover.resolve_device("cpu").type == "cpu"


def test_kernel_sources_are_hashed_and_present():
    """Every .cu of ops/csrc is built and every .cuh is hashed, so an edited
    kernel is never served from a stale build."""
    from sezkp_tpu_torch.ops import _kernels

    on_disk = sorted(os.listdir(_kernels._CSRC))
    listed = sorted(_kernels._SOURCES + _kernels._HEADERS + ("gl_probe.cu",))
    assert on_disk == listed
    for name in ("i8_gemm.cu", "gl_digits.cu", "digit_dft.cu"):
        assert name in _kernels._SOURCES
    assert "i8_mma.cuh" in _kernels._HEADERS


PROBE_ARGS = {
    "mxu_peak": ["--other-log2", "7", "--big-log2", "7"],
    "ntt_breakdown": ["--k", "14", "--tile", "32"],
    "twiddle_fold_ab": ["--k", "18"],  # the smallest three-factor size
    "profile_ntt": ["--k", "14"],
}


@pytest.fixture()
def two_torch_threads():
    """The suite runs in several worker processes at once; with a full set of
    OpenMP threads in each, the float64 products of the plain versions slow
    down by orders of magnitude. Two threads keep them quick in any company."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(PROBE_ARGS))
def test_probe_runs_on_the_cpu(name, capsys, monkeypatch, two_torch_threads):
    """Each probe's main runs to the end on the plain versions at a tiny
    size, finds its equality check true and returns 0."""
    import importlib

    mod = importlib.import_module(f"sezkp_tpu_torch.probes.{name}")
    if name == "twiddle_fold_ab":
        monkeypatch.setattr(mod, "CHAIN", 1)  # one transform a timed run, not four
    rc = mod.main(["--device", "cpu", "--iters", "1", *PROBE_ARGS[name]])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert out.splitlines()[0].startswith("device: cpu")
    assert "True" in out and "False" not in out
    if name == "twiddle_fold_ab":
        import json

        rec = json.loads(out.splitlines()[-1])
        assert rec["k"] == 18 and rec["table_bytes"] == 8 << 18 and rec["fold_ms"] > 0


def test_probe_without_device_needs_the_card():
    import torch

    from sezkp_tpu_torch.probes import ntt_breakdown

    if torch.cuda.is_available():
        pytest.skip("this case is about a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ntt_breakdown.main(["--k", "14"])


def test_profile_ntt_writes_a_trace(tmp_path, capsys, two_torch_threads):
    from sezkp_tpu_torch.probes import profile_ntt

    d = str(tmp_path / "trace")
    assert profile_ntt.main(["--device", "cpu", "--iters", "1", "--k", "14", "--trace", d]) == 0
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0


def test_tracing_and_config(tmp_path):
    from sezkp_tpu_torch.utils import config, tracing

    t = tracing.SpanTimings()
    with tracing.span("x", t, k=1):
        pass
    assert t.rows[0][0] == "x" and t.rows[0][1] >= 0
    assert tracing.log.name == "sezkp_tpu_torch"
    assert tracing.global_timings() is tracing.global_timings()
    assert config.ENV_KEYS["FOLD_MODE"] == "SEZKP_FOLD_MODE"
    assert not hasattr(config, "enable_compile_cache")
    p = tmp_path / "p.toml"
    p.write_text("t = 64\nb = 8\ntau = 2\nrepeats = 3\n")
    assert config.load_profile(str(p)) == config.BenchProfile(64, 8, 2, 3)
    assert config.env("NOPE_NOT_SET", "d") == "d"

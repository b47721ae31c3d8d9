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

"""The port's backend registry (models.get_backend), the demo VM adapter
(models.vm_riscv) and the version stub (ffi) against the JAX package's, on
the CPU: run_e2e writes byte-identical files for every backend.

Tolerance: none -- file bytes."""

import os

import numpy as np
import pytest

from sezkp_tpu import ffi as ref_ffi
from sezkp_tpu import models as ref_models
from sezkp_tpu.models import vm_riscv as ref_vm
from sezkp_tpu_torch import ffi, models
from sezkp_tpu_torch.fold.backend import FoldBackend
from sezkp_tpu_torch.models import vm_riscv as vm
from sezkp_tpu_torch.stark.backends import StarkIOP, StarkV1

FILES = ("trace.cbor", "blocks.cbor", "manifest.cbor", "proof.cbor")


@pytest.fixture(autouse=True)
def _fold_env(monkeypatch):
    """run_e2e sets the fold mode in the environment, as the JAX package's does."""
    for var in ("SEZKP_FOLD_MODE", "SEZKP_WRAP_CADENCE", "SEZKP_FOLD_CACHE", "SEZKP_PROOF_STREAM_PATH"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("name, backend", [
    ("fold", FoldBackend), ("fold-v2", FoldBackend), ("stark", StarkV1), ("stark-v1", StarkV1), ("v1", StarkV1),
    ("stark-v0", StarkIOP), ("v0", StarkIOP),
])
def test_get_backend_names_the_ports_backend(name, backend):
    assert models.get_backend(name) is backend
    assert models.get_backend(name).__name__ == ref_models.get_backend(name).__name__


def test_get_backend_refuses_unknown_names():
    assert models.BACKENDS == ref_models.BACKENDS
    with pytest.raises(KeyError):
        models.get_backend("stark-v2")


def test_ffi_version_stub_equals_reference():
    assert ffi.sezkp_abi_version() == ref_ffi.sezkp_abi_version() == ffi.ABI_VERSION
    assert ffi.sezkp_version() == ref_ffi.sezkp_version() == ffi.VERSION


def test_make_trace_and_demo_block_equal_reference():
    tf, ref_tf = vm.make_trace(64), ref_vm.make_trace(64)
    assert tf.tau == ref_tf.tau == 2
    assert tf.to_obj() == ref_tf.to_obj()
    b, rb = vm.demo_block(3, 16), ref_vm.demo_block(3, 16)
    assert b.to_obj() == rb.to_obj()
    assert np.array_equal(b.windows, rb.windows)


@pytest.mark.parametrize("proto, steps, b", [("v0", 32, 4), ("v1", 64, 8), ("fold", 32, 4), ("v2", 32, 4)])
def test_run_e2e_files_equal_reference(tmp_path, proto, steps, b):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    vm.run_e2e(steps, b, out_dir=port, proto=proto, device="cpu")
    ref_vm.run_e2e(steps, b, out_dir=ref, proto=proto)
    for name in FILES:
        with open(os.path.join(port, name), "rb") as f, open(os.path.join(ref, name), "rb") as g:
            assert f.read() == g.read(), name


def test_run_e2e_without_device_needs_the_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA device"):
        vm.run_e2e(32, 4, out_dir=str(tmp_path), proto="v1")

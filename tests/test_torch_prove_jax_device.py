"""The port's device-resident route vs the JAX package's device pipeline,
both on the CPU. A file of its own: the JAX pipeline takes XLA:CPU about two
minutes to compile, which the test workers can overlap with the other prove
tests only across files.

Tolerance: none -- proofs are compared byte for byte."""

from sezkp_tpu.stark.v1 import proof as ref_proof
from sezkp_tpu.trace.generator import generate_trace as ref_generate_trace
from sezkp_tpu.trace.partition import partition_trace as ref_partition_trace
from sezkp_tpu_torch import convert
from sezkp_tpu_torch.commit.merkle import commit_blocks
from sezkp_tpu_torch.stark.v1 import proof as proof_mod
from sezkp_tpu_torch.stark.v1.prover import prove_v1


def test_device_route_bytes_equal_jax_device_pipeline(monkeypatch):
    """The JAX package's device pipeline (DeviceColumns -> compose_device ->
    deep_coset_lde_planes -> DeviceFri), forced on the CPU backend the way its
    own tests force it, against the port's device-resident route. At tau = 2
    only: XLA:CPU takes many minutes to compile the JAX device composition at
    tau = 8, where the JAX host pipeline stands for it (test_torch_prove.py)."""
    from sezkp_tpu.stark.v1 import merkle as RM
    from sezkp_tpu.stark.v1 import openings as RO
    from sezkp_tpu.stark.v1 import prover as RP

    t, b, tau = 1 << 13, 256, 2
    ref_blocks = ref_partition_trace(ref_generate_trace(t, tau), b)
    blocks = convert.blocks_from_reference(ref_blocks)
    root = commit_blocks(blocks).root
    monkeypatch.setattr(RP, "_use_device_cols", lambda n: True)
    monkeypatch.setattr(RP, "_use_device_fri", lambda n: True)
    monkeypatch.setattr(RM, "_device_ready", lambda n: True)
    monkeypatch.setattr(RO, "_device_ready", lambda n: True, raising=False)
    ref_dev = RP.prove_v1(ref_blocks, root)
    dev = prove_v1(blocks, root, device="cpu")  # n >= 2^13: the device-resident route
    assert proof_mod.encode_proof(dev) == ref_proof.encode_proof(ref_dev)

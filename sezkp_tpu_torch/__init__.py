"""sezkp_tpu_torch: the PyTorch/CUDA port of sezkp_tpu, for NVIDIA Hopper.

The layout mirrors the JAX package module for module (core, crypto, commit,
trace, ops, stark/v1, fold, sched, utils, native). Nothing here imports jax or sezkp_tpu; the
jax-free host modules are this package's own copies.

Entry points take ``device=None``, which means the CUDA card and raises when
there is none; they run on the CPU only when called with ``device="cpu"``.
The hand-written CUDA kernels (ops/csrc) and the native host library
(native/) are built at first use into ``_build/``; importing the package
builds and loads nothing.
"""

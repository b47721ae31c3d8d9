"""Multi-GPU scale-out on torch.distributed (counterpart of sezkp_tpu/parallel)."""

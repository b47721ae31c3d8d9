"""Probes of the port's NTT on the card: what the tensor cores give for int8
products (`mxu_peak`), the parts of a digit-form DFT phase beside the
butterfly kernels (`ntt_breakdown`), the folded-twiddle last phase against
the production transform (`twiddle_fold_ab`), and the phase-level profile of
the production transform (`profile_ntt`). Each runs as
``python -m sezkp_tpu_torch.probes.<name>`` on the CUDA card, or with
``--device cpu`` on the plain versions (to check the control flow; its times
are host-clock times of the plain versions and say nothing of the card).
"""

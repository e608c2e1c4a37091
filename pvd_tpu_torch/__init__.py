"""pvd_tpu_torch: PyTorch + CUDA port of pvd_tpu for NVIDIA Hopper GPUs.

The JAX package `pvd_tpu` stays the reference; every module here carries
the name of its JAX counterpart.  This package imports torch, numpy and the
standard library only.  Its hot ops are hand-written CUDA kernels
(`csrc/*.cu`, built on first use by `kernels.py`); each has a plain PyTorch
version in the same module, which runs for CPU tensors and is what the
kernels are checked against.

Ported so far: the hash (INGP) field's serving path — the occupancy sweep
(`engine.train_steps.make_occ_update`) and the chunked full-image render
(`engine.train_steps.make_eval_renderer`).
"""

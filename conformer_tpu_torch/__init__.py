"""PyTorch/CUDA port of conformer_tpu for NVIDIA Hopper GPUs.

The JAX package ``conformer_tpu`` is the reference each module here is held
against; this package imports none of it.
"""

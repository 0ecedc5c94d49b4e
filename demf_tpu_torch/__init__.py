"""demf_tpu_torch: the PyTorch + CUDA port of demf_tpu for NVIDIA Hopper.

Same configs, same parameter names (mmdet3d state_dict keys), same public
layouts as the JAX package, which stays the reference.  The geometric
kernels (FPS, ball query, MSDA) are hand-written CUDA in ``csrc/``, built
with nvcc at first use.  This package imports torch and never jax.
"""
__version__ = '0.1.0'

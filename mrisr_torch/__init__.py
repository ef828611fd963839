"""PyTorch / CUDA port of the ResDiff serving chain, for one NVIDIA H100.

The JAX package ``mrisr_tpu`` is the reference; every module here keeps the
name of its counterpart there.  Activations are NCHW inside the modules; the
public entry points keep the reference's layouts (the pipeline takes and
returns ``[B, H, W, 1]``, attention takes ``[B, N, D]``).

Hand-written kernels, each with a plain PyTorch version beside it:

* ``ops/flash_attention.py`` + ``csrc/flash_attn_fwd.cu``,
  ``csrc/flash_attn_bwd.cu``: flash-attention forward and backward (dQ,
  dK/dV), CUDA C++ for ``sm_90a``;
* ``ops/groupnorm.py`` + ``csrc/group_norm_silu.cu``: fused GroupNorm +
  SiLU, CUDA C++ for ``sm_90a`` (thread-block clusters).

A wrapper runs the plain version only for a tensor that lies on the CPU; for a
CUDA tensor it launches its kernel or raises.
"""

"""orb_slam2v2_1_tpu_torch — RGB-D tracking, mapping and loop closing in PyTorch.

A port of the repository's JAX package to PyTorch with hand-written CUDA kernels
for Hopper (`csrc/`, loaded by `kernels.py`). The module layout and the public
function names mirror the JAX package, so `ops/fast.py` here is the
counterpart of `ops/fast.py` there; the JAX package is the reference the
port's tests hold it against. This package never imports jax.

Precision policy: the reference forces "highest" float32 matmul precision
for the whole package, because geometry estimation loses tracking at lower
precision. On an NVIDIA card PyTorch would run float32 convolutions through
cuDNN in TF32 (on by default), and TF32 matmuls where enabled: the patch
blur conv (`ops/orb.py blur_patches`) and the float32 products of pose math
then drift by ~1e-3 relative, enough to flip BRIEF descriptor bits and move
LM accept tests. Both TF32 switches are turned off at import.
"""

import torch as _torch

__version__ = "0.1.0"

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

"""orb_slam2_tpu_torch — the PyTorch / CUDA port of orb_slam2_tpu.

A second package beside the JAX one, with the same layout (`ops/`,
`geometry/`, `slam/`) and module names, so each module has its
counterpart there.  Plain tensor code is PyTorch; the three kernels the
JAX package wrote in Pallas are CUDA C++ for Hopper (`csrc/`), built on
first use with `nvcc` and bound with ctypes (`ops/cuda_build.py`).

Every kernel wrapper dispatches on the device of its input: a CUDA
tensor launches the kernel (or raises), a CPU tensor takes the plain
PyTorch version beside it.  This package never imports jax or
orb_slam2_tpu; the tests import both to hold one against the other.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry and feature parity need genuine float32 arithmetic, as the JAX
# package's jax_default_matmul_precision="highest" does: TF32 keeps only
# ~3 decimal digits in matmuls and cuDNN convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from orb_slam2_tpu_torch.config import Sensor, Settings  # noqa: E402,F401
from orb_slam2_tpu_torch.system import System  # noqa: E402,F401

__all__ = ["Settings", "Sensor", "System", "__version__"]

"""sdslam_tpu_torch: the PyTorch/CUDA port of sdslam_tpu for NVIDIA Hopper.

The package mirrors sdslam_tpu's module tree and function names; the JAX
package stays the reference every module here is held against. Plain tensor
code is PyTorch; the per-frame kernels (image alignment, pose GN, the BA
Schur edge pass and the Hamming distance matrix) are hand-written CUDA C++
for sm_90a under `csrc/`, built at first use by `kernels/_build.py`.

Precision: pose chains and Schur sums fail at TF32/bf16 precision (the
reason sdslam_tpu forces full-f32 matmuls in its own __init__), so float32
matmuls and convolutions run in full float32 here too.
"""

import torch as _torch

_torch.set_float32_matmul_precision("highest")
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

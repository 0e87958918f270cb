"""Hand-written CUDA kernels (K1-K7) with their plain PyTorch versions.

Each module mirrors one sdslam_tpu/ops/pallas kernel: a plain function of
the same signature (used for CPU tensors and as the on-card oracle) and a
wrapper that launches the CUDA kernel for CUDA tensors and counts launches
in its module's `LAUNCHES`.
"""

"""Hopper kernels (CUDA C++ under `repro_torch/csrc/`) and their plain
PyTorch versions (counterpart of `repro.kernels`).

Models call through `repro_torch.kernels.ops`, which sends CUDA tensors to the
kernels and CPU tensors to the plain versions in `repro_torch.kernels.ref`.
"""
from repro_torch.kernels import ops, ref  # noqa: F401

"""PyTorch/CUDA port of the `repro` package for an NVIDIA H100.

Module paths mirror `repro`'s, so each module names the one it is held
against. The port imports torch and numpy, never jax and nothing of `repro`.
"""

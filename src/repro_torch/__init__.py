"""PyTorch port of the BlockLLM reproduction (``repro``), for NVIDIA Hopper.

Mirrors ``repro``'s module layout; imports torch and numpy, never JAX and
nothing of ``repro``.  Hand-written CUDA kernels live under
``repro_torch/kernels/<name>/csrc`` and build at first use.
"""

"""PyTorch/CUDA port of the prefix-scan system.

A package beside the JAX reference (``src/repro``), mirroring it module
for module. Entry points run on the device of their input tensor: a CUDA
tensor goes through the hand-written Hopper kernels (``csrc/``), a CPU
tensor through their plain PyTorch versions.

    from repro_torch.core import scan
    y = scan.cumsum(x)          # policy-picked algorithm and schedule
"""

"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops`` holds the dispatch wrappers the solvers call: a CUDA tensor launches
the kernel (built from ``repro_torch/csrc`` by ``_build`` at first use), a
CPU tensor takes the plain version beside the kernel.
"""

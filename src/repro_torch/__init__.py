"""PyTorch + CUDA port of the multi-service FL bandwidth allocator.

The package mirrors ``repro`` module for module (``repro_torch.core.intra``
is the counterpart of ``repro.core.intra``) and imports only ``torch`` and
numpy.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` or CPU tensors; the device of the tensors decides whether a
hand-written CUDA kernel (``repro_torch.kernels``) or its plain PyTorch
version runs.
"""

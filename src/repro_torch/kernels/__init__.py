"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel wrapper picks its implementation by the tensor's device: a CPU
tensor goes to the plain version in :mod:`repro_torch.kernels.ref`, a CUDA
tensor launches the CUDA kernel (or raises).  There is no fallback from the
card to the plain version.
"""

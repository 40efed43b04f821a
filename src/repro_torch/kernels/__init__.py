"""Hand-written CUDA kernels for Hopper, one subpackage per kernel.

Each subpackage holds the CUDA C++ source (``csrc/*.cu``, built for
``sm_90a`` by :mod:`repro_torch.kernels.build` at first use), its
ctypes-bound wrapper with a launch counter, and the plain PyTorch
version of the same function.  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.
"""

"""Hand-written CUDA kernels for Hopper, one subpackage per kernel.

Each subpackage holds the CUDA C++ source (``csrc/*.cu``, built for
``sm_90a`` by :mod:`repro_torch.kernels.build` at first use), its
ctypes-bound wrapper with a launch counter, and the plain PyTorch
version of the same function.  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.
"""
import threading

_COUNT_LOCK = threading.Lock()


def count_launch(counts: dict, name: str) -> None:
    """Add one launch of ``name`` to a kernel module's ``LAUNCHES``-style
    dict.  ``+= 1`` on a dict entry is a read, an add and a store, and
    two threads launching at once could lose a count; one lock makes
    each count exact whatever thread launches."""
    with _COUNT_LOCK:
        counts[name] += 1

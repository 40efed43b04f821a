"""repro_torch — the PyTorch/CUDA port of the ``repro`` prediction pipeline.

Module for module it mirrors ``src/repro/`` (the JAX reference):
``core/`` (levels, traces, reuse distances, SDCM, runtime models),
``hw/`` (targets), ``workloads/`` (PolyBench trace generators),
``api/`` (stages, batched SDCM grid, Session) and ``kernels/``
(hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version).

Device policy: entry points run on the GPU unless the caller asks for
the CPU.  ``device=None`` resolves to ``"cuda"`` and raises when no
CUDA device is present (:func:`repro_torch.device.resolve_device`);
nothing carries on silently on the CPU.  Pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the host.
"""

"""Model substrate of the port: the ``ssm`` (Mamba2) and ``hybrid``
(Zamba2) families, mirroring ``repro/models/`` on one device.

Blocks are ``nn.Module``s holding the reference's parameter names and
layouts; the step functions are plain functions over them, as in the
reference.  Attention runs kernel B4 and the prefill SSD scan kernel B5
(:mod:`repro_torch.kernels`).
"""

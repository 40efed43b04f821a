"""Offline analysis of a program's graph: the HLO readers ported from
``repro/analysis/`` (collectives, loop-aware costs, buffers, the
HLO -> labeled-trace builder, the roofline) and the port's own graph
source, :mod:`repro_torch.analysis.aten_trace`."""

"""Port of ``repro/workloads``: the PolyBench analytic trace generators."""

"""The benchmark of ``repro_torch``, the PyTorch and CUDA package.

One command runs one cell (a configuration under a traffic mix) once::

    python3 -m portbench.run --workload zamba2-1.2b.train-4k \\
        --seed 7 --seconds 30 --trace 0

and prints one JSON line: whether the outputs were correct, the cell's
end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``), and the device.  Everything that belongs to one
configuration, traffic mix or per-layer metric is a file of its own,
found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the model's sizes, its family and the cut;
* ``traffic/<mix>.json``: the mix's parameters, read by the one
  generator of its kind (``traffic.py``, ``loops/<kind>.py``);
* ``metrics/<metric>.py``: a reader of the trace and the counts;
* ``reference/<family>.py``: the plain float32 reference of a family;
* ``program/<family>.py``: how the program's outputs of a family are
  read for the comparison;
* ``limits/<workload>.json``: the limits of a cell's comparison and
  the readings they were set from.

Nothing here imports JAX or the JAX package; the references import
nothing of ``repro_torch`` either.
"""

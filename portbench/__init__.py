"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One command runs one cell once (see ``README.md``)::

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``configs/<config>.json``) under a traffic mix (``traffic/<mix>.json``).
The mix names the driver (``drivers/<driver>.py``) that sets the cell up,
drives its window and checks what the window produced against the plain
reference (``reference/<config>.py``).  Each per-layer metric is a reader
of its own (``metrics/<metric>.py``).  The benchmark imports neither JAX
nor the JAX package ``repro``.
"""

"""The benchmark of ``tneq_tpu_torch``, the PyTorch and CUDA port, on one H100.

One command runs one cell once, from the root of a checkout::

    python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

and prints one JSON line last (``run.py``).  Everything the harness knows of
a cell it finds by name: the cell in ``BENCHMARK.json``, its configuration
file (``configs/``, which names the driver in ``drivers/`` that runs it),
its traffic file (``traffic/``, read by the one generator ``traffic.py``)
and one reader per per-layer metric (``metrics/<metric name>.py``).  The
plain references that decide ``correct`` live in ``reference/`` and import
nothing of the port.  Nothing here imports JAX or the JAX package.
"""

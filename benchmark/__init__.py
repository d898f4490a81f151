"""The benchmark of ``snappy_tpu_torch``, the PyTorch and CUDA port.

One command runs one cell once and prints one JSON line::

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the root names the cells, configurations and
metrics; each is a file of its own here, found by its name:
``configs/<name>.json``, ``cells/<name>.json``, ``drivers/<driver>.py``
and ``metrics/<name>.py``. The reference (``reference/``) and the corpus
(``corpus/``) are the yardstick, and import nothing of the port.
"""

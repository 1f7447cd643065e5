"""The benchmark of ``instruct_tpu_torch``: ``run.py`` runs a cell of
``BENCHMARK.json``."""

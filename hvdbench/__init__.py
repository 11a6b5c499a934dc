"""The benchmark of ``horovod_tpu_torch``: see ``run.py`` and the
repository's ``BENCHMARK.json``."""

"""The benchmark of ``rcf_tpu_torch``: one cell of ``BENCHMARK.json`` a run.

``spec`` finds a cell's files by name, ``weights`` and ``traffic`` make the
inputs from the seed, ``core`` runs the cell, ``trace`` and ``counts``
reduce a profiler trace and count the work, ``compare`` decides
``correct``. Nothing here imports the JAX package.
"""

"""The benchmark of ``ics_tpu_torch``, the PyTorch and CUDA port, on NVIDIA
GPUs: ``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.

Everything that belongs to one configuration, one traffic mix, one metric or
one kernel sits in a file of its own, found by its name:
``configs/<config>.json``, ``traffic/<mix>.json`` (and the mix's set-up,
``traffic/<mix>.py``, where it has one), ``cells/<cell>.json`` (a cell's
limits over its configuration's, where it has one), ``end_to_end/<metric>.py``,
``metrics/<metric>.py`` and ``kernels/<kernel>.py``.  ``reference/`` holds
the plain PyTorch references that decide ``correct``, one a configuration
names (``plain`` by default).  Nothing here imports JAX or the JAX package.
"""

"""The benchmark of ``rtdm_tpu_torch``, the PyTorch and CUDA package.

One command runs one cell (one configuration under one traffic mix) once:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

and prints, as the last line of its standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` and, with
``--trace 1``, ``breakdown``. ``BENCHMARK.json`` at the root of the
checkout names the cells and metrics; everything that belongs to one of
them is a file of its own, found by its name:

- ``configs/<config>.json``: a configuration, as it is run;
- ``traffic/<traffic>.json``: a traffic mix, parameters that the loop
  (``loops.py``) reads: the batches in flight and the pool's size;
- ``systems/<system>.py``: how a configuration's entry point is built and
  called (the system under test comes from ``rtdm_tpu_torch``);
- ``reference/<reference>.py``: the plain reference of a configuration, in
  plain torch, importing nothing of ``rtdm_tpu_torch`` or ``rtdm_tpu``;
- ``checks/<check>.py``: the comparison that decides ``correct``;
- ``metrics/<metric>.py``: the reader of one metric.

Nothing here imports JAX or the JAX package ``rtdm_tpu``.
"""

"""The benchmark of the PyTorch / CUDA port (``multimodal_fusion_tpu_torch``).

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once (``portbench/run.py``).  What
belongs to one configuration, traffic mix, entry or metric sits in files
of its own that the harness finds by name:

- ``configs/<config>.json``: the configuration as it is run;
- ``traffic/<traffic>.json``: the parameters the generator reads, and the
  entry that feeds them to the program;
- ``entries/<entry>.py``: the timed entry into the program;
- ``reference/<family>.py``: the plain reference of an architecture and
  the counts of its operations and bytes;
- ``limits/<config>.<entry>.json``: the limits that decide ``correct``;
- ``metrics/<metric>.py``: the reader of one metric.

Nothing here imports JAX or the JAX package; ``reference/`` imports nothing
of the port either.
"""

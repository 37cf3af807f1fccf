"""portbench: the benchmark of kmb_tpu_torch, the PyTorch / CUDA port.

One command runs one cell (a configuration under a traffic mix) and prints
one JSON line:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name that BENCHMARK.json gives it:

- `configs/<config>.json`: the deployment's sizes, kernel, engine and the
  plain reference that judges it (`references/<reference>.py`);
- `traffic/<traffic>.json`: the parameters the one generator
  (`data.py`) reads;
- `workloads/<cell>.json`: how many rows of each answer are checked, and
  the limit of each number compared;
- `metrics/<metric>.py`: one reader per metric, end-to-end or per-layer.

The yardstick is frozen here: the generators, the table of peaks and the
least-time arithmetic (`roofline.py`), the plain references and the
comparison (`check.py`).  Of the port the benchmark takes only the engine
under test, its launch counters, its launch timer, its collective recorder
and its kernel names.  Nothing here imports jax or the JAX package.
"""

"""The benchmark of zpaqfranz_tpu_torch: backup (`a`), restore (`x`) and test
(`t`) of generated file trees through the port's CLI on a CUDA card.

Run one cell from the root of a checkout:

    python3 benchmark/run.py --workload m4_b1.add --seed 7 --seconds 51 --trace 0

Everything a cell needs is found by name: `BENCHMARK.json` names the cell's
configuration and traffic mix, `configs/<config>.json` and
`traffic/<cell>.json` hold their parameters, `metrics/<metric>.py` reads one
per-layer metric from a traced run, and `roofline/<kernel>.py` counts a
kernel's work. `reference/` judges what the timed path produced; it imports
nothing of the port.
"""

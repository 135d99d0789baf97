"""The port's benchmark: one cell of BENCHMARK.json run once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

Everything that belongs to one configuration, traffic mix, correctness limit
or per-layer metric is a file of its own, found by the name that
BENCHMARK.json gives it: configs/<config>.json, traffic/<traffic>.json,
checks/<workload>.json, metrics/<metric>.py. The plain reference that
decides `correct` is reference/, a frozen copy of the port's eager step in
plain PyTorch that imports nothing of the port.
"""

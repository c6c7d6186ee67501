"""The card benchmark of ``mcmc_tpu_torch``: one cell a run.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is data, found by name from ``BENCHMARK.json``:
its configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), the limits its outputs are held to
(``limits/<workload>.json``) and one reader a per-layer metric
(``metrics/<name>.py``).  The plain reference that decides ``correct``
lives in ``reference/`` and imports nothing of the program.
"""

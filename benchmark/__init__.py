"""The benchmark of ``dmlp_tpu_torch`` on one or four NVIDIA H100 cards.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line last on standard output.

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json``, the
driver the mix names in ``drivers/<kind>.py`` and each metric's reader in
``metrics/<metric>.py``. The yardstick lives here and nowhere in the
program: the seeded inputs (``datagen``), the plain float64 reference
(``reference/``), the comparison that decides ``correct`` (``judge``),
the frozen work counts and the card's peaks (``cost/``).
"""

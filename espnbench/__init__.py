"""The benchmark of the PyTorch and CUDA port of ESPN (``repro_torch``).

``python3 espnbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON result line. Everything a cell needs is found by name: a
configuration in ``configs/<config>.json``, a traffic mix in
``traffic/<mix>.json`` and each per-layer metric in
``metrics/<metric>.py``.
"""

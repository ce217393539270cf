"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 palmbench/run.py --workload NAME --seed N --seconds S --trace 0|1``
runs one cell of ``BENCHMARK.json`` on the card and prints one JSON line.
Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<traffic>.json``,
the mix's driver in ``drivers/<driver>.py`` and each metric's reader in
``metrics/<metric>.py``.
"""

"""The benchmark of the PyTorch/CUDA port (`src/repro_torch`): one
command runs one cell once (`portbench/run.py`). Everything a cell needs
is found by name: its configuration under `configs/`, its traffic mix
under `traffic/`, the limits of its comparison under `limits/`, the
driver its mix names under `drivers/`, each per-layer metric's reader
under `metrics/`, and the plain references under `reference/`.
"""

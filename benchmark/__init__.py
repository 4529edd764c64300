"""The benchmark of lqr_tpu_torch on NVIDIA GPUs (``python3 benchmark/run.py``).

Everything a cell needs is found by name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py``, and one reader a metric
in ``end_to_end/<metric>.py`` or ``layer_metrics/<metric>.py``. The
yardstick (inputs, work counts, peaks, trace reduction, the plain reference
and the comparison) lives here and imports nothing of the program.
"""

"""The benchmark of ``repro_torch`` on the H100 (``perfbench/run.py``)."""

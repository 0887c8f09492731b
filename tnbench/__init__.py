"""tnbench: the benchmark of artensor_tpu_torch (``run.py``)."""

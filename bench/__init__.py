"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell
per (configuration, traffic mix), run by ``bench/run.py``."""

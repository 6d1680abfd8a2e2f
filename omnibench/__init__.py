"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

One run serves one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the card and prints one JSON line; see ``run.py``.
"""

"""The benchmark of the PyTorch and CUDA port (`mplc_tpu_torch`).

`run.py` runs one cell once; `BENCHMARK.json` at the checkout's root lists
the cells, configurations and metrics; everything a cell is made of sits
in files found by name (`manifest.py`). The benchmark imports the program
only as the system under test, and never JAX or the JAX package.
"""

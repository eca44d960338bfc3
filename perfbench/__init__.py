"""The benchmark of the PyTorch/CUDA store: ``python3 perfbench/run.py``."""

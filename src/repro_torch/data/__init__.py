"""Part of the PyTorch/CUDA port of the `repro` package."""

"""PyTorch/CUDA port of the DIALS system in ``repro``.

The package mirrors ``repro``'s layout file for file: ``repro_torch/X.py``
is the counterpart of ``repro/X.py`` and is held to it by the parity
tests (``tests/test_torch_*.py``). The hot spots that ``repro`` runs as
Pallas kernels on a TPU run here as hand-written CUDA kernels for Hopper
(``repro_torch/kernels/csrc``), each beside a plain torch version of the
same function. Entry points run on CUDA unless the caller passes
``device="cpu"``. Nothing here imports JAX.
"""

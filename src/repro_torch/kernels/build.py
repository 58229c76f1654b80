"""Build-at-first-use of the port's CUDA kernels (``csrc/``).

``extension()`` compiles every source in one ``torch.utils.cpp_extension
.load`` call for ``sm_90a`` (``-O3``, no fast-math: the kernels sum in
fp32 as the reference does) into ``build/torch_kernels/`` at the root of
the checkout (``LIBRARY``), and caches the loaded module for the
process. Nothing is
compiled at import: the package imports on a host without ``nvcc``. A
build failure raises. The first build holds a lock: the loop driver's
collect worker and the driver itself may both reach it first.
"""
from __future__ import annotations

import pathlib
import threading

import torch

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "torch_kernels"
SOURCES = ("bindings.cpp", "gru.cu", "gae.cu", "flash_attention.cu",
           "flash_attention_sm90.cu", "ssd.cu", "ssd_sm90.cu")
CUDA_FLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a")
NAME = "repro_torch_kernels"
LIBRARY = BUILD_DIR / f"{NAME}.so"

_extension = None
_build_lock = threading.Lock()


def extension():
    """The compiled kernel module, built on the first call."""
    global _extension
    if _extension is None:
        with _build_lock:
            if _extension is None:
                from torch.utils.cpp_extension import load
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                _extension = load(
                    name=NAME,
                    sources=[str(_CSRC / s) for s in SOURCES],
                    build_directory=str(BUILD_DIR),
                    extra_cflags=["-O2"],
                    extra_cuda_cflags=list(CUDA_FLAGS),
                    verbose=False)
    return _extension


def check_tensor(name: str, x, shape, dtypes=(torch.float32,)) -> None:
    """A kernel wrapper's input contract: a contiguous CUDA tensor of
    exactly ``shape`` whose dtype is one of ``dtypes`` (float32 unless the
    wrapper says otherwise); raises ValueError otherwise."""
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes:
        names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise ValueError(f"{name} must be {names}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

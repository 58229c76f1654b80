"""Kernel dispatch — the port of ``repro/kernels/dispatch.py``.

Every hot spot (AIP GRU, policy GRU, GAE reverse scan) carries a
``use_kernels: "auto" | "on" | "off"`` knob on its config, driven
globally by ``DIALSConfig``. :func:`resolve` turns it into a decision
for the device the tensors live on:

* ``"off"``  — the plain torch version (``repro_torch.nn.gru`` /
  ``repro_torch.marl.gae``), on any device.
* ``"on"``   — the hand-written CUDA kernel. There is no interpreter for
  it off the card, so ``"on"`` with CPU tensors RAISES.
* ``"auto"`` — the CUDA kernel for CUDA tensors, the plain version for
  CPU tensors.

The LM stack keeps the reference's boolean flags
(``ModelConfig.use_flash``, ``nn.ssm.ssm_layer(use_kernel=...)``) and
resolves ``True`` as ``"auto"``: the kernel wrappers
(``kernels/flash_attention``, ``kernels/ssd``) launch the CUDA kernel for
CUDA tensors and run the plain version for CPU tensors, as the
reference's flags run the Pallas kernel in interpret mode off the TPU.

A kernel that fails to build or launch raises; nothing falls back to the
plain version.

:func:`resolve_device` is the entry points' device rule: the default is
``"cuda"``, which raises when no card is visible; the CPU runs only when
the caller asks for it. Resolving to CUDA also sets the card's matmul
numerics to the reference's: no TF32, and bf16 products reduced in fp32
(``preferred_element_type=float32``).
"""
from __future__ import annotations

import dataclasses

import torch

MODES = ("auto", "on", "off")


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller passes
    ``"cpu"``; asking for CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run the port's "
            "plain torch path on the host")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return device


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(
            f"use_kernels must be one of {MODES}, got {mode!r}")


def use_kernel(mode: str, device) -> bool:
    """Resolve ``mode`` for tensors on ``device``: True routes to the
    CUDA kernel, False to the plain version. ``"on"`` off the card
    raises."""
    _check_mode(mode)
    on_cuda = torch.device(device).type == "cuda"
    if mode == "on" and not on_cuda:
        raise RuntimeError(
            "use_kernels='on' needs CUDA tensors: the hand-written "
            "kernels run only on the GPU (use 'auto' or 'off' on the CPU)")
    return on_cuda if mode == "auto" else mode == "on"


def override_mode(cfg, mode: str):
    """Propagate a driver-level ``use_kernels`` onto a sub-config:
    ``"auto"`` defers to the sub-config, ``"on"``/``"off"`` win."""
    _check_mode(mode)
    if mode == "auto" or cfg.use_kernels == mode:
        return cfg
    return dataclasses.replace(cfg, use_kernels=mode)

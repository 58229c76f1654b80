"""Parameter initializers — the port of the ``repro/nn/init.py`` pieces the
MARL stack uses. Each takes batched keys (..., 2) and returns float32
tensors of shape (..., *shape). Built on ``repro_torch.random``'s normal
draws, so values follow the reference's construction but are not its
bits (QR and erfinv differ): parity tests carry the reference's
parameters across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math

import torch

from repro_torch import random as R


def fan_in_normal(axis: int = 0):
    """stddev = 1/sqrt(fan_in), truncated at two standard deviations."""
    def f(key, shape):
        std = 1.0 / math.sqrt(max(shape[axis], 1))
        return std * R.truncated_normal(key, -2.0, 2.0, shape)
    return f


def orthogonal(scale: float = 1.0):
    def f(key, shape):
        if len(shape) < 2:
            return scale * R.normal(key, shape)
        rows, cols = shape[-2], shape[-1]
        n = max(rows, cols)
        flat = R.normal(key, tuple(shape[:-2]) + (n, n))
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[..., None, :]
        return scale * q[..., :rows, :cols]
    return f

"""Parameter initializers — the port of ``repro/nn/init.py``.

Two families:

* Key-based (the MARL stack): ``fan_in_normal``, ``orthogonal``. Each
  takes batched keys (..., 2) and returns float32 tensors of shape
  (..., *shape). Built on ``repro_torch.random``'s normal draws, so values
  follow the reference's construction but are not its bits (QR and erfinv
  differ).
* Generator-based (the LM stack): ``normal``, ``truncated_normal``, and
  ``fan_in_normal`` when handed a generator. Each takes a
  ``torch.Generator`` and draws on the generator's device, in float32,
  then casts to ``dtype``. The LM stack
  has no key-stream contract to keep, and threefry's int64 temporaries
  would not fit beside a 917M-entry embedding.

Neither gives the reference's bits: parity tests carry the reference's
parameters across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math

import torch

from repro_torch import random as R


def fan_in_normal(axis: int = 0):
    """stddev = 1/sqrt(fan_in), truncated at two standard deviations.
    ``f(key, shape)`` draws from batched keys; ``f(gen, shape, dtype)``
    from a ``torch.Generator`` (see :func:`truncated_normal`)."""
    def f(key, shape, dtype=torch.float32):
        std = 1.0 / math.sqrt(max(shape[axis], 1))
        if isinstance(key, torch.Generator):
            return truncated_normal(std)(key, shape, dtype)
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


# ---------------------------------------------------------------------------
# torch.Generator-based initializers (the LM stack)
# ---------------------------------------------------------------------------
def normal(stddev: float = 1.0):
    def f(gen, shape, dtype=torch.float32):
        x = torch.randn(tuple(shape), generator=gen, device=gen.device,
                        dtype=torch.float32)
        return (stddev * x).to(dtype)
    return f


def truncated_normal(stddev: float = 1.0):
    """stddev * N(0, 1) truncated to [-2, 2], as ``jax.random.
    truncated_normal(key, -2, 2)``."""
    def f(gen, shape, dtype=torch.float32):
        x = torch.empty(tuple(shape), device=gen.device, dtype=torch.float32)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (stddev * x).to(dtype)
    return f


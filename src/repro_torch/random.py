"""Threefry-2x32 key streams in torch integer arithmetic.

The port's explicit random generator. Every reference contract rests on
``jax.random`` key streams — per-stream fold-in (``core/env_pool.py``),
per-agent fold-in (``core/ials.py``), the per-round collect keys of
``core/dials.py`` — so the port reproduces those streams bit for bit
instead of drawing from a ``torch.Generator``. The bits equal
``jax.random``'s under ``jax_threefry_partitionable=True`` (the default
since jax 0.5) for exactly the calls the port makes: ``split``,
``fold_in``, ``bernoulli``, ``randint``, ``categorical`` (Gumbel argmax)
and ``permutation``, plus ``uniform`` under them. ``normal`` and
``truncated_normal`` follow jax's construction for port-native parameter
init; their ``erfinv`` is torch's, so those two are close to jax's
values, not equal to them.

A key is a pair of uint32 words held in an int64 tensor of shape
``(..., 2)`` (values in ``[0, 2**32)``; int64 because torch's uint32
lacks the arithmetic, and ``& 0xFFFFFFFF`` keeps every word in range on
the CPU and on CUDA alike). Leading dimensions batch independent keys:
where the reference ``vmap``s a draw over stream or agent keys, the port
passes the stacked keys and each key draws its own ``shape``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = torch.finfo(torch.float32).tiny
# the float32 just above -1: ``normal``'s lower bound for its uniform draw
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# elements a block of ``categorical(shape=)`` draws at once
_DRAW_BLOCK = 1 << 24


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), elementwise over broadcast
    int64 tensors holding uint32 words. Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def key(seed: int, device=None):
    """``jax.random.PRNGKey(seed)`` for a non-negative seed < 2**64."""
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _words(key, ndim: int):
    """The key's two words, shaped to broadcast against ``ndim`` more
    trailing dimensions."""
    tail = (1,) * ndim
    k1 = key[..., 0].reshape(key.shape[:-1] + tail)
    k2 = key[..., 1].reshape(key.shape[:-1] + tail)
    return k1, k2


def _counts(shape, device):
    """The partitionable counter of ``prng.iota_2x32_shape``: the row-
    major index over ``shape`` as (high word, low word)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=device).reshape(shape)
    return idx >> 32, idx & _MASK


def split(key, num: int = 2):
    """``jax.random.split``: (..., 2) -> (..., num, 2)."""
    hi, lo = _counts((num,), key.device)
    y1, y2 = threefry2x32(*_words(key, 1), hi, lo)
    return torch.stack([y1, y2], dim=-1)


def fold_in(key, data):
    """``jax.random.fold_in``; ``data`` (an int or an integer tensor that
    broadcasts against the key's batch shape) is taken as uint32."""
    data = data & _MASK
    y1, y2 = threefry2x32(key[..., 0], key[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def random_bits(key, shape):
    """32 random bits per element: (..., 2) keys -> (..., *shape)."""
    shape = tuple(shape)
    hi, lo = _counts(shape, key.device)
    y1, y2 = threefry2x32(*_words(key, len(shape)), hi, lo)
    return y1 ^ y2


def _f32(x: float) -> float:
    """``x`` rounded to float32 (exact as a Python float): scalars enter
    float32 tensor ops as this value, as jax's weak-typed scalars do."""
    return float(np.float32(x))


def _unit(bits, minval, maxval):
    """32-bit draws -> float32 in [minval, maxval): mantissa bits under
    exponent 0, minus one, scaled."""
    one = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    lo = _f32(minval)
    span = _f32(np.float32(maxval) - np.float32(minval))
    return torch.clamp((one - 1.0) * span + lo, min=lo)


def uniform(key, shape, minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32."""
    return _unit(random_bits(key, shape), minval, maxval)


def bernoulli(key, p, shape=None):
    """``jax.random.bernoulli`` (mode "low"): ``uniform < p`` in float32.
    With ``shape`` None each key draws ``p``'s trailing shape beyond the
    key's batch dimensions."""
    if shape is None:
        shape = p.shape[key.ndim - 1:]
    return uniform(key, shape) < (p if torch.is_tensor(p) else _f32(p))


def randint(key, shape, minval: int, maxval: int):
    """``jax.random.randint`` for int32 bounds: two 32-bit draws combined
    modulo the span, as int64 values in [minval, maxval)."""
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    span = max(maxval - minval, 1) & _MASK
    multiplier = (2 ** 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((higher % span) * multiplier) & _MASK
    offset = ((offset + lower % span) & _MASK) % span
    return minval + offset


def _gumbel_argmax(u, logits):
    return torch.argmax(-torch.log(-torch.log(u)) + logits, dim=-1)


def categorical(key, logits, shape=None):
    """``jax.random.categorical`` along the last axis (Gumbel argmax,
    mode "low"). With ``shape`` None each key draws Gumbel noise of
    ``logits``' trailing shape beyond the key's batch dimensions. With
    ``shape`` one key draws ``shape + (V,)`` noise against ``logits``
    broadcast to it, as ``jax.random.categorical(key, logits, shape=)``
    does; the draw runs in blocks of rows (each element's bits depend only
    on its flat index), so its int64 temporaries stay small at any
    ``shape``."""
    if shape is None:
        u = uniform(key, logits.shape[key.ndim - 1:], minval=_TINY_F32,
                    maxval=1.0)
        return _gumbel_argmax(u, logits)
    assert key.ndim == 1, "categorical(shape=) takes one key"
    shape = tuple(shape)
    v = logits.shape[-1]
    rows = math.prod(shape)
    flat = torch.broadcast_to(logits, shape + (v,)).reshape(rows, v)
    block = max(1, _DRAW_BLOCK // v)
    out = []
    for r0 in range(0, rows, block):
        r1 = min(rows, r0 + block)
        idx = torch.arange(r0 * v, r1 * v, dtype=torch.int64,
                           device=key.device).reshape(r1 - r0, v)
        y1, y2 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
        out.append(_gumbel_argmax(_unit(y1 ^ y2, _TINY_F32, 1.0),
                                  flat[r0:r1]))
    return torch.cat(out).reshape(shape)


def permutation(key, n: int):
    """``jax.random.permutation(key, n)``: the rounds of stable sorts by
    fresh 32-bit keys that ``jax.random._shuffle`` runs. (..., 2) keys
    -> (..., n) int64."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(key.shape[:-1] + (n,))
    rounds = int(math.ceil(3 * math.log(max(1, n)) / math.log(_MASK)))
    for _ in range(rounds):
        keys = split(key, 2)
        key, sub = keys[..., 0, :], keys[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True)[1]
        x = torch.gather(x, -1, order)
    return x


def normal(key, shape):
    """Standard normal float32 by jax's inverse-CDF construction."""
    u = uniform(key, shape, minval=_NORMAL_LO, maxval=1.0)
    return math.sqrt(2.0) * torch.erfinv(u)


def truncated_normal(key, lower: float, upper: float, shape):
    """Standard normal truncated to [lower, upper], jax's construction."""
    a = math.erf(lower / math.sqrt(2.0))
    b = math.erf(upper / math.sqrt(2.0))
    u = uniform(key, shape, minval=a, maxval=b)
    out = math.sqrt(2.0) * torch.erfinv(u)
    return torch.clamp(out, math.nextafter(lower, math.inf),
                       math.nextafter(upper, -math.inf))

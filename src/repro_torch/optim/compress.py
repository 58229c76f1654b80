"""int8 gradient compression with error feedback — the port of
``repro/optim/compress.py``.

The reference uses it for the cross-pod reconciliation of the DIALS-outer
optimizer (``optim/outer.py``): the pod-to-pod delta is the only
inter-pod collective, and int8 with a per-row fp32 scale cuts it 4x; the
error feedback keeps the quantization noise from biasing convergence.
``torch.round`` rounds half to even, as ``jnp.round`` does, so ``q`` is the
reference's bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like


def _rowwise(x):
    """Flatten to (rows, cols) for per-row scales; rows = leading dim."""
    if x.ndim == 0:
        return x.reshape(1, 1)
    return x.reshape(x.shape[0], -1)


def compress(x, err):
    """Returns (q int8, scale fp32 (rows,), new_err). err has x's shape."""
    xf = x.float() + err
    rows = _rowwise(xf)
    scale = torch.amax(torch.abs(rows), dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(rows / scale), -127, 127).to(torch.int8)
    deq = (q.float() * scale).reshape(xf.shape)
    return q.reshape(x.shape if x.ndim else (1,)), scale[:, 0], xf - deq


def decompress(q, scale, shape):
    rows = _rowwise(q.float())
    return (rows * scale[:, None]).reshape(shape)


def tree_compress(tree, err_tree):
    """Compress every leaf; returns (q_tree, scale_tree, new_err_tree)."""
    out = [compress(x, e) for x, e in zip(leaves(tree), leaves(err_tree))]
    return tuple(unflatten_like(tree, [o[i] for o in out]) for i in range(3))


def tree_decompress(q_tree, scale_tree, like_tree):
    return tree_map(lambda q, s, x: decompress(q, s, x.shape), q_tree,
                    scale_tree, like_tree)


def init_error(tree):
    return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                          device=x.device), tree)

"""Carry the JAX package's pytrees into the port, and back.

The reference initialises parameters with a QR-based orthogonal init that
the port cannot match bit for bit, so parity runs start both sides from
the SAME state: the reference's pytree, fetched to numpy
(``jax.device_get``), becomes the port's nested dicts/lists of tensors.
The layouts already agree leaf for leaf (per-agent stacks on a leading
axis, ``{"mu", "nu", "master", "step"}`` optimizer states, the IALS state
dict); only the integer types change: every integer leaf (including the
uint32 PRNG keys) becomes int64, floats and bools keep their type. A
bfloat16 leaf (numpy's ``ml_dtypes.bfloat16``, which ``torch.tensor``
does not take) crosses through its uint16 bits, so it arrives bit for
bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import dispatch
from repro_torch.tree import tree_map


def _leaf_to_torch(x, device):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(x).view(np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    if np.issubdtype(x.dtype, np.integer):
        x = x.astype(np.int64)
    return torch.tensor(x, device=device)


def from_jax_params(tree, device="cuda"):
    """A params (or optimizer-state) pytree of numpy arrays -> tensors."""
    device = dispatch.resolve_device(device)
    return tree_map(lambda x: _leaf_to_torch(x, device), tree)


def from_jax_state(state, device="cuda"):
    """A ``repro.core.dials.DIALSTrainer`` state (``{"ials", "aips",
    "round", "key"}``, arrays as numpy) -> the port trainer's state."""
    device = dispatch.resolve_device(device)
    return {"ials": from_jax_params(state["ials"], device),
            "aips": from_jax_params(state["aips"], device),
            "round": int(state["round"]),
            "key": _leaf_to_torch(state["key"], device)}


def _leaf_to_numpy(x):
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:      # numpy has no bfloat16: compare in f32
        x = x.float()
    return x.numpy()


def to_numpy(tree):
    """The port's tensors -> numpy, for comparison with the reference
    (bfloat16 leaves come back as float32, exactly)."""
    return tree_map(_leaf_to_numpy, tree)

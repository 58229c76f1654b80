"""Public GRU ops matching ``repro_torch.nn.gru``'s contract — the port
of ``repro/kernels/gru/ops.py``.

Params carry a leading agent axis A (wi (A,in,3H), wh (A,H,3H), bi/bh
(A,3H)). The input-gate matmul x.W_i + b_i for all steps is one batched
``torch.matmul`` outside the kernel, as it is XLA outside the Pallas
kernel in the reference; the kernel runs the recurrence.

Dtype contract: outputs come back in the oracle's dtype (``h.dtype`` for
the cell; ``h0.dtype`` when given, else ``xs.dtype``, for the sequence);
the kernel computes in float32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gru import kernel as k_mod


def _f32(params, name):
    return params[name].float().contiguous()


def gru_cell(params, h, x):
    """One step: h (A,B,H), x (A,B,in) -> new h, through the scan kernel
    at T=1 (the rollout step's fast path)."""
    gi = (torch.matmul(x.float(), _f32(params, "wi"))
          + _f32(params, "bi")[:, None, :])[:, None]          # (A,1,B,3H)
    resets = torch.zeros(gi.shape[:3], dtype=torch.float32, device=x.device)
    hs = k_mod.gru_scan(gi.contiguous(), _f32(params, "wh"),
                        _f32(params, "bh"), h.float().contiguous(), resets)
    return hs[:, 0].to(h.dtype)


def gru_sequence(params, xs, h0=None, *, reset_mask=None):
    """xs (A,B,T,in) -> (hs (A,B,T,H), h_last (A,B,H)). Differentiable in
    params/xs/h0 through the backward kernel."""
    out_dtype = h0.dtype if h0 is not None else xs.dtype
    a, b, t, din = xs.shape
    hdim = params["wh"].shape[1]
    if h0 is None:
        h0 = torch.zeros((a, b, hdim), dtype=torch.float32, device=xs.device)
    gi = torch.matmul(xs.float().reshape(a, b * t, din), _f32(params, "wi"))
    gi = gi.reshape(a, b, t, 3 * hdim) + _f32(params, "bi")[:, None, None, :]
    gi = gi.transpose(1, 2).contiguous()                       # (A,T,B,3H)
    if reset_mask is None:
        resets = torch.zeros((a, t, b), dtype=torch.float32, device=xs.device)
    else:
        resets = reset_mask.float().transpose(1, 2).contiguous()
    hs = k_mod.gru_scan(gi, _f32(params, "wh"), _f32(params, "bh"),
                        h0.float().contiguous(), resets)
    hs = hs.transpose(1, 2).to(out_dtype)                      # (A,B,T,H)
    return hs, hs[:, :, -1]

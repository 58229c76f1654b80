"""Plain torch version of the GRU scan kernel (``kernel.gru_scan``): the
same function, written as a loop over T. The kernel's CPU path and its
oracle on the card; autograd gives its backward."""
from __future__ import annotations

import torch


def gru_scan(gi, wh, bh, h0, resets):
    """gi (A,T,B,3H); wh (A,H,3H); bh (A,3H); h0 (A,B,H); resets (A,T,B)
    -> hs (A,T,B,H). Per step: h <- h(1-reset), gh = h.W_h + b_h,
    r, z = sigmoid, n = tanh(i_n + r*gh_n), h' = (1-z)n + z h."""
    hdim = wh.shape[1]
    h = h0
    hs = []
    for t in range(gi.shape[1]):
        h = h * (1.0 - resets[:, t, :, None])
        gh = torch.matmul(h, wh) + bh[:, None, :]
        g = gi[:, t]
        r = torch.sigmoid(g[..., :hdim] + gh[..., :hdim])
        z = torch.sigmoid(g[..., hdim:2 * hdim] + gh[..., hdim:2 * hdim])
        n = torch.tanh(g[..., 2 * hdim:] + r * gh[..., 2 * hdim:])
        h = (1.0 - z) * n + z * h
        hs.append(h)
    return torch.stack(hs, dim=1)

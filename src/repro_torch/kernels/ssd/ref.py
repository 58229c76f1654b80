"""Plain torch versions of the SSD kernel. :func:`ssd` delegates to the
port's :func:`repro_torch.nn.ssm.ssd_chunked`, as the reference's
``ref.py`` does; :func:`intra_chunk` computes exactly the kernel's three
outputs (``kernel.ssd_intra_chunk``), so the kernel is held to it one to
one. The kernel's CPU path and its oracle on the card."""
from __future__ import annotations

import torch

from repro_torch.nn import ssm as ssm_mod


def ssd(x, dt, a, b, c, *, chunk: int = 128, initial_state=None):
    """x: (B,T,H,P); dt: (B,T,H); a: (H,); b,c: (B,T,N)."""
    return ssm_mod.ssd_chunked(x, dt, a, b, c, chunk=chunk,
                               initial_state=initial_state)


def intra_chunk(xw, la, b, c, *, chunk: int):
    """xw: (B, T, H, P) dt-weighted inputs; la: (B, T, H) log decays;
    b, c: (B, T, N). Returns (y_diag (B,T,H,P) in xw's dtype, states
    (B,nc,H,P,N) f32, chunk_decay (B,nc,H) f32), all math in f32:
    cs = cumsum(la), y = (C·Bᵀ ⊙ tril(exp(cs_i - cs_j)))·X,
    state = Σ_j x_j (b_j exp(cs_L - cs_j))ᵀ, decay = exp(cs_L)."""
    bsz, t, h, p = xw.shape
    n = b.shape[-1]
    nc = t // chunk
    x = xw.reshape(bsz, nc, chunk, h, p).float()
    lac = torch.movedim(la.reshape(bsz, nc, chunk, h).float(), -1, 2)
    bc = b.reshape(bsz, nc, chunk, n).float()
    cc = c.reshape(bsz, nc, chunk, n).float()
    cs = torch.cumsum(lac, dim=-1)                       # (B, nc, H, L)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=xw.device))
    decay = torch.where(tri, torch.exp(cs[..., :, None] - cs[..., None, :]),
                        0.0)                             # (B, nc, H, L, L)
    cb = torch.einsum("bcin,bcjn->bcij", cc, bc)          # (B, nc, L, L)
    y = torch.einsum("bchij,bcjhp->bcihp", cb[:, :, None] * decay, x)
    w = torch.exp(cs[..., -1:] - cs)                     # (B, nc, H, L)
    states = torch.einsum("bcjhp,bchjn->bchpn", x,
                          bc[:, :, None] * w[..., None])
    return (y.reshape(bsz, t, h, p).to(xw.dtype), states,
            torch.exp(cs[..., -1]))

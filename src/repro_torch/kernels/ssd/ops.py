"""Public SSD op — the port of ``repro/kernels/ssd/ops.py``: the
intra-chunk kernel plus the inter-chunk recurrence and the off-diagonal
output in torch (where the reference leaves them to XLA: the serial
scan over T/L chunks is latency-bound either way)."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd import kernel as k_mod
from repro_torch.nn import ssm as ssm_mod


def ssd(x, dt, a, b, c, *, chunk: int = 128, initial_state=None):
    """Same contract as :func:`repro_torch.nn.ssm.ssd_chunked`."""
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    nc = t // chunk

    la = dt * a[None, None, :]                           # (B, T, H)
    xw = x * dt[..., None].to(x.dtype)

    y_diag, states, chunk_decay = k_mod.ssd_intra_chunk(
        xw.contiguous(), la.float().contiguous(), b.contiguous(),
        c.contiguous(), chunk=chunk)

    # inter-chunk recurrence (serial over nc)
    if initial_state is None:
        initial_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                    device=x.device)
    final, prev_states = ssm_mod.inter_chunk_scan(states, chunk_decay,
                                                  initial_state)

    # off-diagonal output: y_i += C_i · S_prev · exp(cs_i)
    lac = la.reshape(bsz, nc, chunk, h)
    cs = torch.cumsum(torch.movedim(lac, -1, 2), dim=-1)  # (B, nc, H, L)
    cc = c.reshape(bsz, nc, chunk, n)
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cc.float(), prev_states,
                         torch.exp(cs))
    y = y_diag.float() + y_off.reshape(bsz, t, h, p)
    return y.to(x.dtype), final

"""Mamba-2 SSD (state-space duality) layer — the port of
``repro/nn/ssm.py``: the chunked parallel form for prefill and the
O(1)-state recurrent form for decode.

:func:`ssd_chunked` is the plain version the SSD kernel
(``repro_torch.kernels.ssd``) is held to. ``ssm_layer(use_kernel=True)``
launches that kernel on CUDA tensors and runs its plain version on CPU
tensors, as the reference's flag runs the Pallas kernel in interpret
mode off the TPU. As in the reference, no model block passes
``use_kernel``: the flag is reached through this layer entry point only.

Shapes: x (B, T, d_model); inner activations (B, T, H, P) with
H = d_inner // head_dim heads, P = head_dim, N = ssm state size.

Left out: the logical-axis specs (mesh sharding, not ported).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.nn import init as initializers
from repro_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_model: int
    state: int = 128            # N
    head_dim: int = 64          # P
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128            # SSD chunk length
    dtype: object = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def ssm_init(gen, cfg: SSMConfig):
    di, n, h = cfg.d_inner, cfg.state, cfg.num_heads
    dev = gen.device
    # in_proj -> [z (di), x (di), B (n), C (n), dt (h)]
    proj_out = 2 * di + 2 * n + h
    conv_ch = di + 2 * n          # conv over x, B, C
    fan_in = initializers.fan_in_normal(0)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": fan_in(gen, (cfg.d_model, proj_out), cfg.dtype),
        "conv_w": fan_in(gen, (cfg.conv_width, conv_ch), cfg.dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=cfg.dtype, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.log(torch.expm1(          # inv-softplus of ~1e-3..1e-1
            torch.linspace(1e-3, 1e-1, h, **f32))),
        "d_skip": torch.ones((h,), **f32),
        "norm": layers.rmsnorm_init(di, dev),
        "out_proj": fan_in(gen, (di, cfg.d_model), cfg.dtype),
        "dt_w": fan_in(gen, (1,), torch.float32),  # placeholder, as the reference
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv
# ---------------------------------------------------------------------------
def causal_conv1d(x, w, b):
    """x: (B, T, C); w: (W, C) depthwise; left-pad so output is causal."""
    width = w.shape[0]
    xp = F.pad(x, (0, 0, width - 1, 0))
    t = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        out = out + xp[:, i:i + t, :].float() * w[i].float()
    out = out + b.float()
    return F.silu(out).to(x.dtype)


# ---------------------------------------------------------------------------
# SSD chunked scan
# ---------------------------------------------------------------------------
def _segsum(a):
    """a: (..., L). Returns (..., L, L) with out[i,j] = sum_{k=j+1..i} a_k
    (i >= j), -inf elsewhere — so exp() gives the decay matrix."""
    l = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def inter_chunk_scan(states, chunk_decay, initial_state):
    """The serial recurrence over chunks: s_c = s_{c-1}·decay_c + S_c.
    states (B, nc, H, P, N), chunk_decay (B, nc, H), initial_state
    (B, H, P, N) -> (final state, the state entering each chunk
    (B, nc, H, P, N)), all fp32."""
    s = initial_state.float()
    prev = []
    for ci in range(states.shape[1]):
        prev.append(s)
        s = s * chunk_decay[:, ci, :, None, None] + states[:, ci]
    return s, torch.stack(prev, dim=1)


def ssd_chunked(x, dt, a, b, c, *, chunk: int, initial_state=None):
    """Chunked SSD.

    x : (B, T, H, P)   inputs (dt applied here)
    dt: (B, T, H)      positive step sizes
    a : (H,)           negative per-head decay rates
    b : (B, T, N)      input projection (shared across heads)
    c : (B, T, N)      output projection (shared across heads)

    Returns (y, final_state) with y (B, T, H, P), state (B, H, P, N).
    """
    bsz, t, h, p = x.shape
    n = b.shape[-1]
    assert t % chunk == 0, f"T={t} must be divisible by chunk={chunk}"
    nc = t // chunk

    # dt-discretise: per-step log decay and effective input weight.
    la = dt * a[None, None, :]                       # (B,T,H) log decay (<0)
    xw = x * dt[..., None].to(x.dtype)               # dt * x

    def ck(v):  # (B, T, ...) -> (B, nc, chunk, ...)
        return v.reshape((bsz, nc, chunk) + tuple(v.shape[2:]))

    xc, lac, bc, cc = ck(xw), ck(la), ck(b), ck(c)
    lac = torch.movedim(lac, -1, 2)                  # (B, nc, H, L)
    cs = torch.cumsum(lac, dim=-1)                   # inclusive cumsum

    # 1. Intra-chunk (diagonal blocks): y_i += C_i·B_j exp(cs_i-cs_j) x_j
    decay = torch.exp(_segsum(lac))                  # (B, nc, H, L, L)
    cb = torch.einsum("bcin,bcjn->bcij", cc.float(), bc.float())
    y_diag = torch.einsum("bchij,bcjhp->bcihp", cb[:, :, None] * decay,
                          xc.float())

    # 2. Per-chunk end states: S_c = sum_j exp(cs_L - cs_j) B_j x_j^T
    decay_states = torch.exp(cs[..., -1:] - cs)      # (B, nc, H, L)
    states = torch.einsum("bcjn,bchj,bcjhp->bchpn", bc.float(),
                          decay_states, xc.float())

    # 3. Inter-chunk recurrence over nc chunks.
    chunk_decay = torch.exp(cs[..., -1])             # (B, nc, H)
    if initial_state is None:
        initial_state = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                                    device=x.device)
    final, prev_states = inter_chunk_scan(states, chunk_decay, initial_state)

    # 4. Inter-chunk output: y_i += C_i · S_prev * exp(cs_i)
    out_decay = torch.exp(cs)                        # (B, nc, H, L)
    y_off = torch.einsum("bcin,bchpn,bchi->bcihp", cc.float(), prev_states,
                         out_decay)

    y = (y_diag + y_off).reshape(bsz, t, h, p).to(x.dtype)
    return y, final


def ssd_recurrent_step(state, x, dt, a, b, c):
    """One decode step. state: (B,H,P,N); x: (B,H,P); dt: (B,H);
    b, c: (B,N). Returns (y, new_state)."""
    dec = torch.exp(dt * a[None, :])                          # (B,H)
    upd = torch.einsum("bhp,bn->bhpn",
                       (x * dt[..., None].to(x.dtype)).float(), b.float())
    new = state * dec[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new, c.float())
    return y.to(x.dtype), new


# ---------------------------------------------------------------------------
# Full layer
# ---------------------------------------------------------------------------
def _project(params, x, cfg: SSMConfig):
    di, n = cfg.d_inner, cfg.state
    proj = layers.dot(x, params["in_proj"])
    z, xin, bb, cc, dt = torch.split(
        proj, [di, di, n, n, proj.shape[-1] - 2 * di - 2 * n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    return z, xin, bb, cc, dt


def _gate_out(params, y, z, cfg: SSMConfig):
    y = layers.rmsnorm(params["norm"], y) * F.silu(z.float()).to(y.dtype)
    return layers.dot(y, params["out_proj"])


def ssm_layer(params, x, cfg: SSMConfig, *, use_kernel: bool = False):
    """Train/prefill. x: (B, T, d_model) -> (B, T, d_model).
    ``use_kernel`` routes the scan through ``kernels.ssd.ops.ssd``: the
    CUDA kernel on CUDA tensors, its plain version on CPU tensors."""
    bsz, t, _ = x.shape
    h, p = cfg.num_heads, cfg.head_dim
    z, xin, bb, cc, dt = _project(params, x, cfg)
    conv_in = torch.cat([xin, bb, cc], dim=-1)
    conv_out = causal_conv1d(conv_in, params["conv_w"], params["conv_b"])
    xin, bb, cc = torch.split(conv_out, [cfg.d_inner, cfg.state, cfg.state],
                              dim=-1)
    xh = xin.reshape(bsz, t, h, p)
    a = -torch.exp(params["a_log"])
    if use_kernel:
        from repro_torch.kernels.ssd import ops as ssd_ops
        y, _ = ssd_ops.ssd(xh, dt, a, bb, cc, chunk=cfg.chunk)
    else:
        y, _ = ssd_chunked(xh, dt, a, bb, cc, chunk=cfg.chunk)
    y = y + xh * params["d_skip"][None, None, :, None].to(xh.dtype)
    return _gate_out(params, y.reshape(bsz, t, cfg.d_inner), z, cfg)


def init_ssm_cache(cfg: SSMConfig, batch: int, dtype=None, device="cpu"):
    dtype = dtype or cfg.dtype
    conv_ch = cfg.d_inner + 2 * cfg.state
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.num_heads, cfg.head_dim, cfg.state),
                             dtype=torch.float32, device=device),
    }


def ssm_decode_step(params, x, cache, cfg: SSMConfig):
    """One-token decode. x: (B, 1, d_model). Returns (y, new_cache)."""
    bsz = x.shape[0]
    h, p = cfg.num_heads, cfg.head_dim
    z, xin, bb, cc, dt = _project(params, x, cfg)
    conv_in = torch.cat([xin, bb, cc], dim=-1)                 # (B, 1, C)
    window = torch.cat([cache["conv"], conv_in], dim=1)        # (B, W, C)
    conv_out = (window.float() * params["conv_w"].float()[None]).sum(1) \
        + params["conv_b"].float()
    conv_out = F.silu(conv_out).to(x.dtype)                    # (B, C)
    xin1, bb1, cc1 = torch.split(conv_out,
                                 [cfg.d_inner, cfg.state, cfg.state], dim=-1)
    a = -torch.exp(params["a_log"])
    y, new_state = ssd_recurrent_step(
        cache["state"], xin1.reshape(bsz, h, p), dt[:, 0], a, bb1, cc1)
    y = y + xin1.reshape(bsz, h, p) * \
        params["d_skip"][None, :, None].to(y.dtype)
    y = _gate_out(params, y.reshape(bsz, 1, cfg.d_inner), z, cfg)
    return y, {"conv": window[:, 1:], "state": new_state}

"""Mixture-of-Experts — the port of ``repro/nn/moe.py``: a top-k
token-choice router with capacity, experts stacked on a leading E axis.

Routing is the reference's, integer for integer: the float32 softmax's
top-k (ties to the lower expert index, as ``jax.lax.top_k``), renormalised
weights, and each (token, k)'s slot in its expert's buffer, counted in
token-major then k order (an exclusive ``cumsum`` gives the integers the
reference's ``associative_scan`` gives). A pair whose slot is past the
capacity is dropped: its combine weight is zero, so the residual carries
the token.

Both dispatches are a row scatter into the (E, C, d) buffers and a row
gather back. Each slot holds at most one token, so the reference's dense
one-hot products (``dispatch="dense"``) only copy rows: the port computes
the same result without building the (N, k, E, C) one-hot, which at
granite's B=2 x T=8192 prefill would take ~43 GB of bf16.
``dispatch="gather"`` routes each of ``token_shards`` contiguous token
groups on its own (one group when the token count does not divide), the
aux terms then means over the groups. The expert products are batched
matmuls, float32 accumulation cast back to the activation dtype, as the
reference's ``preferred_element_type=float32`` einsums.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import mesh as mesh_lib
from repro_torch.nn import init as initializers
from repro_torch.nn import layers


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                     # per-expert hidden
    num_experts: int
    top_k: int
    capacity_factor: float = 1.25
    activation: str = "swiglu"
    dtype: object = torch.bfloat16
    dispatch: str = "dense"       # dense | gather (same result)
    token_shards: int = 1         # gather only: routing groups

    def capacity(self, tokens: int) -> int:
        cap = int(math.ceil(tokens * self.top_k / self.num_experts
                            * self.capacity_factor))
        # round up to a multiple of 8, min 8 (the reference's)
        return max(8, -(-cap // 8) * 8)


def moe_init(gen, cfg: MoEConfig):
    e, dm, df = cfg.num_experts, cfg.d_model, cfg.d_ff
    w_in = initializers.fan_in_normal(axis=1)   # fan-in = d_model
    w_out = initializers.fan_in_normal(axis=1)  # fan-in = d_ff
    params = {
        "router": initializers.truncated_normal(dm ** -0.5)(
            gen, (dm, e), torch.float32),
        "up": w_in(gen, (e, dm, df), cfg.dtype),
        "down": w_out(gen, (e, df, dm), cfg.dtype),
    }
    if cfg.activation == "swiglu":
        params["gate"] = w_in(gen, (e, dm, df), cfg.dtype)
    return params


def moe_logical_specs(cfg: MoEConfig):
    specs = {
        "router": ("embed", None),
        "up": ("expert", "embed", "mlp"),
        "down": ("expert", "mlp", "embed"),
    }
    if cfg.activation == "swiglu":
        specs["gate"] = ("expert", "embed", "mlp")
    return specs


def router_probs(params, x, cfg: MoEConfig):
    """x: (..., d_model) -> (router probabilities (..., E), logits), fp32."""
    logits = torch.matmul(x.float(), params["router"])
    return torch.softmax(logits, dim=-1), logits


def _route(params, xf, cfg: MoEConfig):
    """xf (..., N, d) -> (top_w (..., N, k) fp32, top_e (..., N, k), pos
    (..., N, k) int32, keep (..., N, k) bool, the capacity of N tokens,
    aux {load_balance, z_loss} (...,)): leading axes are token groups,
    each routed on its own."""
    tokens = xf.shape[-2]
    e, k = cfg.num_experts, cfg.top_k
    probs, logits = router_probs(params, xf, cfg)            # (..., N, E)
    # a stable descending sort: equal probabilities keep the lower expert
    # index first, as jax.lax.top_k does
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :k], top_e[..., :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    cap = cfg.capacity(tokens)
    # position of each (token, k) in its expert's buffer: the pairs before
    # it (token-major, then k) that chose the same expert
    flat = torch.nn.functional.one_hot(
        top_e.reshape(top_e.shape[:-2] + (tokens * k,)), e).to(torch.int32)
    pos = torch.cumsum(flat, dim=-2, dtype=torch.int32) - flat
    pos = (pos * flat).sum(-1).reshape(top_e.shape)          # (..., N, k)
    keep = pos < cap

    me = probs.mean(-2)
    ce = torch.nn.functional.one_hot(top_e[..., 0], e).float().mean(-2)
    aux = {"load_balance": e * torch.sum(me * ce, dim=-1),
           "z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2,
                                dim=-1)}
    return top_w, top_e, pos, keep, cap, aux


def _expert_mlp(params, xe, cfg: MoEConfig):
    """xe: (E, C, dm) -> (E, C, dm), batched over experts."""
    up = torch.bmm(xe, params["up"].to(xe.dtype))
    if cfg.activation == "swiglu":
        gate = torch.bmm(xe, params["gate"].to(xe.dtype))
        h = layers.swiglu(gate, up)
    else:
        h = layers.gelu(up)
    return torch.bmm(h, params["down"].to(xe.dtype))


def _groups(cfg: MoEConfig, tokens: int) -> int:
    if cfg.dispatch == "gather" and tokens % cfg.token_shards == 0:
        return cfg.token_shards
    return 1


def route_groups(params, x, cfg: MoEConfig):
    """The routing of :func:`moe_layer` on x (B, T, d): (top_w, top_e, pos,
    keep), each (S, n, k) over the S token groups, the capacity of a
    group and the aux terms (means over the groups)."""
    b, t, dm = x.shape
    s = _groups(cfg, b * t)
    top_w, top_e, pos, keep, cap, aux = _route(
        params, x.reshape(s, -1, dm), cfg)
    return top_w, top_e, pos, keep, cap, {name: v.mean()
                                          for name, v in aux.items()}


def moe_layer(params, x, cfg: MoEConfig):
    """x: (B, T, d_model) -> (y, aux) with aux = {load_balance, z_loss}.

    Token-choice top-k with capacity; dropped tokens pass through (their
    combine weights are zero, so the residual carries them). On the mesh
    see :func:`_moe_layer_mesh`."""
    if mesh_lib.is_dtensor(x):
        return _moe_layer_mesh(params, x, cfg)
    return _moe_apply(params, x, cfg, 0)


def _moe_apply(params, x, cfg: MoEConfig, e_lo: int):
    """The layer with the experts [e_lo, e_lo + E_local) that ``params``'
    expert weights hold (all of them off the mesh): routing over every
    token of x, the pairs routed elsewhere left out of the combine."""
    b, t, dm = x.shape
    k = cfg.top_k
    e = params["up"].shape[0]
    top_w, top_e, pos, keep, cap, aux = route_groups(params, x, cfg)
    s, n = top_e.shape[:2]
    if e != cfg.num_experts:
        keep = keep & (top_e >= e_lo) & (top_e < e_lo + e)
    # every group's buffers in one (S*E*C + 1, dm) table: the row of
    # (group g, token, k) is g*E*C + e*C + c; a dropped pair goes to the
    # spare last row, which no expert reads and which reads back as 0
    spare = s * e * cap
    group = torch.arange(s, device=x.device)[:, None, None] * (e * cap)
    row = torch.where(keep, group + (top_e - e_lo) * cap + pos,
                      spare).reshape(-1)
    buf = torch.zeros((spare + 1, dm), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, row, x.reshape(s * n, dm).repeat_interleave(k, 0))
    # the experts take every group's buffer at once: (E, S*C, dm)
    xe = buf[:spare].reshape(s, e, cap, dm).transpose(0, 1) \
        .reshape(e, s * cap, dm)
    ye = _expert_mlp(params, xe, cfg).reshape(e, s, cap, dm).transpose(0, 1)
    ye = torch.cat([ye.reshape(spare, dm),
                    torch.zeros((1, dm), dtype=ye.dtype, device=ye.device)])
    w = (top_w * keep).to(ye.dtype)                          # (S, n, k)
    y = torch.einsum("snk,snkd->snd", w.float(),
                     ye[row].reshape(s, n, k, dm).float())
    return y.to(x.dtype).reshape(b, t, dm), aux


def _moe_layer_mesh(params, x, cfg: MoEConfig):
    """The layer on DTensors, expert-parallel: every rank routes every
    token (an all-gather of x over its splits: the routing's capacity and
    slot counts run over all the tokens of a group, as on one device),
    runs the experts its block of the expert axis holds (the expert
    weights gathered along their other splits) and combines their
    outputs; the result is summed over the mesh dims that split the
    experts and laid out as x. The aux terms are the same on
    every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = x.device_mesh
    whole = [Replicate()] * mesh.ndim

    def experts_only(w):
        return w.redistribute(mesh, [
            p if isinstance(p, Shard) and p.dim == 0 else Replicate()
            for p in w.placements])

    local, ref = {}, None
    for name in ("up", "gate", "down"):
        if name in params:
            w = experts_only(params[name])
            local[name], ref = w.to_local(), w
    split = [isinstance(p, Shard) and p.dim == 0 for p in ref.placements]
    # the tokens and the router reach every rank's experts: their
    # gradients are partial over the mesh dims that split the experts
    grads = tuple(Partial() if s_ else Replicate() for s_ in split)
    local["router"] = params["router"].redistribute(mesh, whole).to_local(
        grad_placements=grads)
    y, aux = _moe_apply(local, x.redistribute(mesh, whole).to_local(
        grad_placements=grads), cfg, mesh_lib.block_offset(ref, 0))
    y = mesh_lib.partial_sum(y, x, tuple(Partial() if s_ else Replicate()
                                         for s_ in split))
    aux = {k: mesh_lib.shape_like(v, x, tuple(whole))
           for k, v in aux.items()}
    return y.redistribute(mesh, x.placements), aux

"""Core functional layers — the port of ``repro/nn/layers.py``.

A layer is a pair of functions: ``<name>_init(gen, ...) -> params`` (a
``torch.Generator`` on the target device) and ``<name>(params, x, ...)``.
Params are plain dicts of tensors with the reference's keys and layouts,
so a JAX params tree carries across leaf for leaf
(``repro_torch.convert``).

Matmuls accumulate in fp32 and cast back to the activation dtype, as the
reference's ``preferred_element_type=float32`` does: ``torch.matmul`` on
matching bf16 operands accumulates in fp32 (on the card,
``kernels.dispatch.resolve_device`` turns
``allow_bf16_reduced_precision_reduction`` off), and fp32 operands run in
full fp32 (no TF32).

Left out: ``layernorm`` (whisper only) and the logical-axis specs (mesh
sharding, not ported).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.nn import init as initializers


def dot(x, w):
    """Matmul over x's last axis and w's first, fp32 accumulation, output
    in x.dtype."""
    return torch.matmul(x, w.to(x.dtype))


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------
def linear_init(gen, in_dim: int, out_dim: int, *, use_bias: bool = False,
                dtype=torch.bfloat16, w_init=None):
    w_init = w_init or initializers.fan_in_normal(axis=0)
    params = {"w": w_init(gen, (in_dim, out_dim), dtype)}
    if use_bias:
        params["b"] = torch.zeros((out_dim,), dtype=dtype, device=gen.device)
    return params


def linear(params, x):
    y = dot(x, params["w"])
    if "b" in params:
        y = y + params["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(dim: int, device="cpu"):
    # Norm scales stay fp32 ("zero-centred": the multiplier is 1 + scale).
    return {"scale": torch.zeros((dim,), dtype=torch.float32, device=device)}


def rmsnorm(params, x, *, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------
def embedding_init(gen, vocab: int, dim: int, dtype=torch.bfloat16,
                   stddev: float = 1.0):
    return {"table": initializers.normal(stddev)(gen, (vocab, dim), dtype)}


def embedding_lookup(params, ids, *, scale_by_sqrt_dim: bool = False):
    table = params["table"]
    y = table[ids.long()]
    if scale_by_sqrt_dim:
        # the reference casts sqrt(d) to the activation dtype BEFORE the
        # multiply (bf16 sqrt(3584) = 60.0, not 59.866...)
        s = torch.sqrt(torch.tensor(float(table.shape[-1]),
                                    dtype=torch.float32))
        y = y * s.to(y.dtype).to(y.device)
    return y


def embedding_logits(params, x):
    """Tied unembedding: x @ table.T with fp32 accumulation, fp32 output."""
    table = params["table"]
    return torch.matmul(x.float(), table.float().t())


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
def softcap(x, cap: Optional[float]):
    """Gemma-2 style logit soft-capping: cap * tanh(x / cap)."""
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def swiglu(gate, up):
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu(x):
    return F.gelu(x.float(), approximate="tanh").to(x.dtype)


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    d_model: int
    d_ff: int
    activation: str = "swiglu"  # swiglu | gelu
    use_bias: bool = False
    dtype: object = torch.bfloat16


def mlp_init(gen, cfg: MLPConfig):
    kw = dict(use_bias=cfg.use_bias, dtype=cfg.dtype)
    if cfg.activation == "swiglu":
        return {"gate": linear_init(gen, cfg.d_model, cfg.d_ff, **kw),
                "up": linear_init(gen, cfg.d_model, cfg.d_ff, **kw),
                "down": linear_init(gen, cfg.d_ff, cfg.d_model, **kw)}
    return {"up": linear_init(gen, cfg.d_model, cfg.d_ff, **kw),
            "down": linear_init(gen, cfg.d_ff, cfg.d_model, **kw)}


def mlp(params, x, *, activation: str = "swiglu"):
    if activation == "swiglu":
        h = swiglu(linear(params["gate"], x), linear(params["up"], x))
    else:
        h = gelu(linear(params["up"], x))
    return linear(params["down"], h)

"""Decoder-only LM — the port of ``repro/models/lm.py``, forward only.

* Params for each period position are stacked on a leading repeats axis,
  exactly as the reference's ``init_lm`` (``jax.vmap(block_init)``), so a
  JAX params tree carries across leaf for leaf. :func:`forward` and
  :func:`decode_step` are Python loops over the repeats where the
  reference has a ``lax.scan``.
* ``use_flash`` routes every attention layer's prefill through the flash
  kernel (``repro_torch.kernels.flash_attention``) on CUDA tensors; on
  CPU tensors it runs the kernel's plain version.
* Decode threads stacked per-layer caches, updated in place.

Left out: ``token_xent``/``lm_loss`` (the training slice), the
zamba-style ``shared`` block and cross-attention (``ModelConfig.shared``
must be None; ROADMAP queue 1 item 12), ``act_constraint`` (mesh
sharding) and the logical-axis specs. ``remat`` and ``scan_unroll`` are
accepted and ignored: there is no autodiff or XLA scan here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.models import blocks
from repro_torch.nn import layers
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int                               # len(period) * repeats
    period: Tuple[blocks.LayerSpec, ...]
    shared: Optional[blocks.LayerSpec] = None   # zamba-style shared block
    tie_embeddings: bool = True
    final_softcap: Optional[float] = None
    embed_scale: bool = False                   # gemma: x *= sqrt(d_model)
    dtype: object = torch.bfloat16
    remat: str = "full"                         # accepted, ignored
    loss_chunk: int = 2048
    use_flash: bool = False
    scan_unroll: bool = False                   # accepted, ignored

    @property
    def repeats(self) -> int:
        assert self.n_layers % len(self.period) == 0, \
            f"{self.n_layers} layers not divisible by period {len(self.period)}"
        return self.n_layers // len(self.period)


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.shared is not None:
        raise NotImplementedError(
            "shared (zamba-style) blocks are not ported yet (ROADMAP queue 1 "
            "item 12)")


def _stacked_init(gen, spec: blocks.LayerSpec, repeats: int):
    """``repeats`` blocks stacked on a leading axis, filled one block at a
    time (the full stack is never held twice)."""
    first = blocks.block_init(gen, spec)
    stacked = tree_map(lambda x: torch.empty((repeats,) + tuple(x.shape),
                                             dtype=x.dtype, device=x.device),
                       first)
    tree_map(lambda dst, src: dst[0].copy_(src), stacked, first)
    del first
    for r in range(1, repeats):
        tree_map(lambda dst, src: dst[r].copy_(src), stacked,
                 blocks.block_init(gen, spec))
    return stacked


def init_lm(gen, cfg: ModelConfig):
    """Params on ``gen.device`` from a seeded ``torch.Generator``."""
    _check_ported(cfg)
    params = {
        "embed": layers.embedding_init(gen, cfg.vocab, cfg.d_model,
                                       dtype=cfg.dtype,
                                       stddev=cfg.d_model ** -0.5),
        "final_norm": layers.rmsnorm_init(cfg.d_model, gen.device),
        "layers": [_stacked_init(gen, spec, cfg.repeats)
                   for spec in cfg.period],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = layers.linear_init(gen, cfg.d_model, cfg.vocab,
                                               dtype=cfg.dtype)
    return params


def _layer(stacked, r: int):
    return tree_map(lambda x: x[r], stacked)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def forward(params, tokens, cfg: ModelConfig, *, positions=None):
    """tokens: (B, T) integer -> (final hidden states (B, T, d_model),
    aux), aux holding the reference's (here always zero) MoE losses."""
    _check_ported(cfg)
    x = layers.embedding_lookup(params["embed"], tokens,
                                scale_by_sqrt_dim=cfg.embed_scale)
    for r in range(cfg.repeats):
        for j, spec in enumerate(cfg.period):
            x, _ = blocks.block_apply(_layer(params["layers"][j], r), x, spec,
                                      positions=positions,
                                      use_flash=cfg.use_flash)
    x = layers.rmsnorm(params["final_norm"], x)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, {"load_balance": zero, "z_loss": zero.clone()}


def logits_fn(params, x, cfg: ModelConfig):
    """Full logits (fp32). Only safe for small vocab/short sequences."""
    if cfg.tie_embeddings:
        logits = layers.embedding_logits(params["embed"], x)
    else:
        logits = layers.linear(params["unembed"], x).float()
    return layers.softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_caches(params, cfg: ModelConfig, batch: int, max_len: int):
    """Stacked caches: one tree per period position, leading repeats axis
    (real tensors, not broadcasts: decode writes them in place)."""
    _check_ported(cfg)
    device = params["embed"]["table"].device
    caches = []
    for spec in cfg.period:
        one = blocks.init_block_cache(spec, batch, max_len, device=device)
        caches.append(tree_map(
            lambda a: a[None].repeat((cfg.repeats,) + (1,) * a.ndim), one))
    return {"layers": caches, "shared": None}


def decode_step(params, token, caches, index: int, cfg: ModelConfig):
    """token: (B, 1) integer, index: the absolute position (a Python int).
    Returns (logits (B, 1, V) fp32, caches); the caches are updated in
    place (the reference's serve step donates them)."""
    _check_ported(cfg)
    x = layers.embedding_lookup(params["embed"], token,
                                scale_by_sqrt_dim=cfg.embed_scale)
    for r in range(cfg.repeats):
        for j, spec in enumerate(cfg.period):
            x, _ = blocks.block_decode(_layer(params["layers"][j], r), x,
                                       _layer(caches["layers"][j], r), index,
                                       spec)
    x = layers.rmsnorm(params["final_norm"], x)
    return logits_fn(params, x, cfg), caches

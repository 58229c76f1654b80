"""Decoder-only LM (and the generic backbone of enc-dec / VLM) — the port
of ``repro/models/lm.py``.

* Params for each period position are stacked on a leading repeats axis,
  exactly as the reference's ``init_lm`` (``jax.vmap(block_init)``), so a
  JAX params tree carries across leaf for leaf. :func:`forward` and
  :func:`decode_step` are Python loops over the repeats where the
  reference has a ``lax.scan``. A zamba-style ``shared`` block keeps one
  unstacked copy, applied once per repeat after the period, with a KV
  cache of its own per repeat.
* ``use_flash`` routes every self-attention layer's prefill through the
  flash kernel (``repro_torch.kernels.flash_attention``) on CUDA tensors;
  on CPU tensors it runs the kernel's plain version.
* Decode threads stacked per-layer caches, updated in place;
  cross-attention blocks read K/V projected once from the source.

* Training: under autograd each repeat of the period is recomputed in
  backward as ``remat`` says (``"full"``: the whole repeat, through
  ``torch.utils.checkpoint``; ``"dots"``: the matmul outputs without batch
  dims are kept, the rest recomputed; ``"none"``: everything kept), as the
  reference's ``_remat_wrap`` does per scan step. The loss is chunked
  over the sequence (``loss_chunk``), each chunk recomputed in backward,
  so the (B, T, vocab) fp32 logits are never kept. Recompute changes no
  number. ``use_flash`` under autograd raises: the reference's flash
  kernel is forward-only (``nn.attention.self_attention``).

* The mesh: :func:`lm_logical_specs` and :func:`cache_logical_specs`
  name each leaf's logical axes (``repro_torch.distributed.mesh``
  resolves them); ``act_constraint`` redistributes the residual stream at
  the repeat boundaries (sequence parallelism) and ``logits_constraint``
  the decode attention logits (the distributed softmax), as the
  reference's sharding constraints.

``scan_unroll`` is accepted and ignored: there is no XLA scan here, and a
loop over repeats costs every repeat in full.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.distributed.mesh import (is_dtensor, local_rows,
                                          reduce_partial, replicated_scalar,
                                          stack_specs, take_last, unshard)
from repro_torch.models import blocks
from repro_torch.nn import attention as attn_mod
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
    remat: str = "full"                         # none | full | dots
    loss_chunk: int = 2048
    use_flash: bool = False
    scan_unroll: bool = False                   # accepted, ignored

    @property
    def repeats(self) -> int:
        assert self.n_layers % len(self.period) == 0, \
            f"{self.n_layers} layers not divisible by period {len(self.period)}"
        return self.n_layers // len(self.period)


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
    params = {
        "embed": layers.embedding_init(gen, cfg.vocab, cfg.d_model,
                                       dtype=cfg.dtype,
                                       stddev=cfg.d_model ** -0.5),
        "final_norm": layers.rmsnorm_init(cfg.d_model, gen.device),
        "layers": [_stacked_init(gen, spec, cfg.repeats)
                   for spec in cfg.period],
    }
    if cfg.shared is not None:
        params["shared"] = blocks.block_init(gen, cfg.shared)
    if not cfg.tie_embeddings:
        params["unembed"] = layers.linear_init(gen, cfg.d_model, cfg.vocab,
                                               dtype=cfg.dtype)
    return params


def lm_logical_specs(cfg: ModelConfig):
    specs = {
        "embed": {"table": ("vocab", "embed")},
        "final_norm": {"scale": ("embed",)},
        # the stacked repeats axis leads every per-layer leaf
        "layers": [stack_specs(blocks.block_logical_specs(spec))
                   for spec in cfg.period],
    }
    if cfg.shared is not None:
        specs["shared"] = blocks.block_logical_specs(cfg.shared)
    if not cfg.tie_embeddings:
        specs["unembed"] = {"w": ("embed", "vocab")}
    return specs


def _layer(stacked, r: int):
    return tree_map(lambda x: x[r], stacked)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------
def _add_aux(total, aux):
    if aux is not None:
        for name in total:
            total[name] = total[name] + aux[name]


def _dots_policy(ctx, op, *args, **kwargs):
    """The port of ``dots_with_no_batch_dims_saveable``: keep the outputs
    of matmuls without batch dims, recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, mode: str):
    """``fn`` recomputed in backward as ``mode`` says; ``fn`` itself when
    no gradient is taken (prefill, inference)."""
    if mode == "none" or not torch.is_grad_enabled():
        return fn
    if mode == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    if mode != "full":
        raise ValueError(f"remat must be none, full or dots, got {mode!r}")
    return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)


def forward(params, tokens, cfg: ModelConfig, *, cross_kv=None,
            positions=None, act_constraint=None):
    """tokens: (B, T) integer -> (final hidden states (B, T, d_model),
    aux), aux holding the MoE losses summed over each repeat's layers, then
    over the repeats (zero without MoE layers; the shared block's are
    dropped, as the reference's).

    ``act_constraint``: optional sharding constraint applied to the
    residual stream after the embedding and after every repeat (sequence
    parallelism: the carry between repeats, the only activation kept
    across the depth under ``remat="full"``, is stored sequence-sharded
    over the model axis)."""
    x = layers.embedding_lookup(params["embed"], tokens,
                                scale_by_sqrt_dim=cfg.embed_scale)
    if act_constraint is not None:
        x = act_constraint(x)
    shared_p = params.get("shared")

    def body(x, r):
        aux = {name: torch.zeros((), dtype=torch.float32, device=x.device)
               for name in ("load_balance", "z_loss")}
        if is_dtensor(x):
            aux = {k: replicated_scalar(v, x) for k, v in aux.items()}
        for j, spec in enumerate(cfg.period):
            x, a = blocks.block_apply(_layer(params["layers"][j], r), x, spec,
                                      cross_kv=cross_kv, positions=positions,
                                      use_flash=cfg.use_flash)
            _add_aux(aux, a)
        if shared_p is not None:
            x, _ = blocks.block_apply(shared_p, x, cfg.shared,
                                      cross_kv=cross_kv, positions=positions,
                                      use_flash=cfg.use_flash)
        if act_constraint is not None:
            x = act_constraint(x)
        return x, aux["load_balance"], aux["z_loss"]

    step = _remat_wrap(body, cfg.remat)
    auxs = []
    for r in range(cfg.repeats):
        x, lb, z = step(x, r)
        auxs.append((lb, z))
    x = layers.rmsnorm(params["final_norm"], x)
    aux = {name: torch.stack([a[i] for a in auxs]).sum()
           for i, name in enumerate(("load_balance", "z_loss"))}
    return x, aux


def logits_fn(params, x, cfg: ModelConfig):
    """Full logits (fp32). Only safe for small vocab/short sequences."""
    if cfg.tie_embeddings:
        logits = layers.embedding_logits(params["embed"], x)
    else:
        logits = layers.linear(params["unembed"], x).float()
    return layers.softcap(logits, cfg.final_softcap)


# ---------------------------------------------------------------------------
# Loss (chunked over sequence — never keeps (B, T, V))
# ---------------------------------------------------------------------------
def token_xent(params, x, labels, cfg: ModelConfig):
    """x: (B, T, d), labels: (B, T) -> per-token loss (B, T), fp32. Each
    ``loss_chunk`` of the sequence is recomputed in backward, as the
    reference's ``jax.checkpoint(f)`` under ``lax.map``."""
    t = x.shape[1]
    chunk = min(cfg.loss_chunk, t)
    if t % chunk != 0:
        chunk = t

    def f(xc, lc):
        logits = logits_fn(params, xc, cfg)            # (B, chunk, V) fp32
        if is_dtensor(logits):
            # vocab-parallel: a max and a sum reduced across the vocab
            # split (explicitly: the log's backward divides by its input,
            # which must not be a partial sum), never the (B, chunk, V)
            # logits gathered
            m = reduce_partial(torch.amax(logits, dim=-1,
                                          keepdim=True)).detach()
            s = reduce_partial(torch.sum(torch.exp(logits - m), dim=-1,
                                         keepdim=True))
            logz = (m + torch.log(s))[..., 0]
        else:
            logz = torch.logsumexp(logits, dim=-1)
        if is_dtensor(logits):
            gold = take_last(logits, lc)
        else:
            gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
        return logz - gold

    if torch.is_grad_enabled():
        f = functools.partial(ckpt.checkpoint, f, use_reentrant=False)
    return torch.cat([f(x[:, i:i + chunk], labels[:, i:i + chunk])
                      for i in range(0, t, chunk)], dim=1)


def lm_loss(params, batch, cfg: ModelConfig, *, lb_weight: float = 0.01,
            z_weight: float = 1e-3, cross_kv=None, act_constraint=None):
    """batch: dict(tokens=(B,T), labels=(B,T)[, cross_kv]). Returns (loss,
    metrics {xent, load_balance, z_loss})."""
    cross = batch.get("cross_kv", cross_kv)
    x, aux = forward(params, batch["tokens"], cfg, cross_kv=cross,
                     act_constraint=act_constraint)
    xent = token_xent(params, x, batch["labels"], cfg).mean()
    loss = xent + lb_weight * aux["load_balance"] + z_weight * aux["z_loss"]
    return loss, {"xent": xent, **aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def _stack(one, repeats: int):
    """``repeats`` copies of a cache on a leading axis (real tensors, not
    broadcasts: decode writes them in place)."""
    return tree_map(lambda a: a[None].repeat((repeats,) + (1,) * a.ndim),
                    one)


def init_caches(params, cfg: ModelConfig, batch: int, max_len: int,
                cross_src=None):
    """Stacked caches: one tree per period position, leading repeats axis.
    Cross-attention blocks hold K/V projected from ``cross_src`` once per
    layer."""
    device = params["embed"]["table"].device
    caches = []
    for j, spec in enumerate(cfg.period):
        if spec.mixer == "cross_attn":
            mixer = params["layers"][j]["mixer"]
            shape = cross_src.shape[:2] + (spec.attn.num_kv_heads,
                                           spec.attn.dh)
            caches.append({
                name: torch.stack([
                    layers.linear(_layer(mixer[name], r), cross_src)
                    .reshape(shape) for r in range(cfg.repeats)])
                for name in ("k", "v")})
        else:
            caches.append(_stack(blocks.init_block_cache(
                spec, batch, max_len, device=device), cfg.repeats))
    shared = None
    if cfg.shared is not None:
        shared = _stack(blocks.init_block_cache(cfg.shared, batch, max_len,
                                                device=device), cfg.repeats)
    return {"layers": caches, "shared": shared}


def cache_logical_specs(cfg: ModelConfig):
    """Logical-axis tree parallel to :func:`init_caches`'s output (stacked
    caches get a leading "layers" axis)."""
    layers_specs = [stack_specs(blocks.block_cache_logical_specs(s))
                    for s in cfg.period]
    shared = (stack_specs(blocks.block_cache_logical_specs(cfg.shared))
              if cfg.shared is not None else None)
    return {"layers": layers_specs, "shared": shared}


def _decode_cross(p, x, cache, spec):
    """Cross-attn decode against precomputed K/V."""
    p = unshard(p, x)
    h = layers.rmsnorm(p["norm1"], x)
    dh = spec.attn.dh

    def attend(qf, k, v):
        q = qf.reshape(qf.shape[0], 1, spec.attn.num_heads, dh)
        return attn_mod.attend(q, k, v, causal=False,
                               softcap=spec.attn.attn_softcap) \
            .reshape(qf.shape[0], 1, -1)

    qf = layers.linear(p["mixer"]["q"], h)
    if is_dtensor(qf):
        out = local_rows(attend, qf, cache["k"], cache["v"])
    else:
        out = attend(qf, cache["k"], cache["v"])
    h = layers.linear(p["mixer"]["o"], out)
    h = blocks._gate(p, "gate_attn", spec, h)
    return blocks._ffn(p, spec, x + h)[0]


def decode_step(params, token, caches, index: int, cfg: ModelConfig, *,
                logits_constraint=None):
    """token: (B, 1) integer, index: the absolute position (a Python int).
    Returns (logits (B, 1, V) fp32, caches); the caches are updated in
    place (the reference's serve step donates them).
    ``logits_constraint``: see ``nn.attention.decode_self_attention``."""
    x = layers.embedding_lookup(params["embed"], token,
                                scale_by_sqrt_dim=cfg.embed_scale)
    shared_p = params.get("shared")
    for r in range(cfg.repeats):
        for j, spec in enumerate(cfg.period):
            p, cache = _layer(params["layers"][j], r), \
                _layer(caches["layers"][j], r)
            if spec.mixer == "cross_attn":
                x = _decode_cross(p, x, cache, spec)
            else:
                x, _ = blocks.block_decode(
                    p, x, cache, index, spec,
                    logits_constraint=logits_constraint)
        if shared_p is not None:
            x, _ = blocks.block_decode(shared_p, x,
                                       _layer(caches["shared"], r), index,
                                       cfg.shared,
                                       logits_constraint=logits_constraint)
    x = layers.rmsnorm(params["final_norm"], x)
    return logits_fn(params, x, cfg), caches

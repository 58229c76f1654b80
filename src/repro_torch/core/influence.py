"""Approximate Influence Predictors (AIPs) — the port of
``repro/core/influence.py``.

The AIP estimates the posterior over the M binary influence sources given
the action-local-state history: an FNN trunk, a GRU for the recurrent
(warehouse) kind, and M independent Bernoulli heads, trained with
cross-entropy on (ALSH, u) pairs collected from the GS. Per-agent AIPs
are stacked along a leading agent axis A and trained together: every
function here takes params with leaves (A, ...) and data with a leading
A, where the reference writes one agent and vmaps.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch import random as R
from repro_torch.marl.policy import dense, dense_init
from repro_torch.nn import gru as gru_mod
from repro_torch.optim import adamw
from repro_torch.tree import leaves, take_rows, unflatten_like


@dataclasses.dataclass(frozen=True)
class AIPConfig:
    in_dim: int                 # ALSH feature dim: local obs + prev action
    n_sources: int              # M binary influence sources
    kind: str = "fnn"           # fnn (traffic) | gru (warehouse)
    hidden: Tuple[int, ...] = (128, 128)
    gru_hidden: int = 64
    lr: float = 1e-4
    epochs: int = 100
    batch: int = 128
    use_kernels: str = "auto"   # GRU scan in aip_sequence/train_aip/
    #                             aip_apply: auto (kernel on CUDA) | on | off
    eval_chunk: int = 64        # eval_ce sequence-chunk size (memory cap)


def aip_init(key, cfg: AIPConfig):
    """key (A, 2) -> per-agent params."""
    keys = R.split(key, 5)
    params = {}
    din = cfg.in_dim
    trunk = []
    for i, hdim in enumerate(cfg.hidden):
        trunk.append(dense_init(keys[..., i, :], din, hdim))
        din = hdim
    params["trunk"] = trunk
    if cfg.kind == "gru":
        params["gru"] = gru_mod.gru_init(
            keys[..., 3, :], gru_mod.GRUConfig(in_dim=din,
                                               hidden=cfg.gru_hidden))
        din = cfg.gru_hidden
    params["heads"] = dense_init(keys[..., 4, :], din, cfg.n_sources)
    return params


def initial_hidden(cfg: AIPConfig, *batch, device=None):
    return torch.zeros(tuple(batch) + (cfg.gru_hidden,), device=device)


def _trunk(params, x):
    for p in params["trunk"]:
        x = torch.relu(dense(p, x))
    return x


def aip_apply(params, feat, h, cfg: AIPConfig):
    """One step. feat (A, E, F); h (A, E, Hg). Returns (logits (A,E,M),
    h')."""
    x = _trunk(params, feat)
    if cfg.kind == "gru":
        h = gru_mod.gru_cell(params["gru"], h, x,
                             use_kernels=cfg.use_kernels)
        x = h
    return dense(params["heads"], x), h


def aip_sequence(params, feats, h0, resets, cfg: AIPConfig):
    """feats (A, B, T, F) -> logits (A, B, T, M). resets (A, B, T)
    restart the GRU at episode boundaries."""
    x = _trunk(params, feats)
    if cfg.kind == "gru":
        x, _ = gru_mod.gru_sequence(params["gru"], x, h0, reset_mask=resets,
                                    use_kernels=cfg.use_kernels)
    return dense(params["heads"], x)


def sample_sources(key, logits):
    """u ~ prod_m Bernoulli(sigmoid(logit_m)), one key per leading row."""
    return R.bernoulli(key, torch.sigmoid(logits)).float()


def _bce_elementwise(logits, targets):
    """Per-element stable sigmoid cross-entropy."""
    return torch.clamp(logits, min=0) - logits * targets + \
        torch.log1p(torch.exp(-torch.abs(logits)))


def bce_loss(params, feats, targets, resets, cfg: AIPConfig):
    """Expected cross-entropy per agent: feats (A,B,T,F), targets
    (A,B,T,M) -> (A,)."""
    h0 = initial_hidden(cfg, feats.shape[0], feats.shape[1],
                        device=feats.device)
    logits = aip_sequence(params, feats, h0, resets, cfg)
    ce = _bce_elementwise(logits, targets)
    return ce.reshape(ce.shape[0], -1).mean(-1)


def epoch_minibatch_indices(perm, batch: int):
    """Cover each agent's permutation (A, S) with ceil(S/batch) fixed-size
    minibatches, the last one wrapping around to the permutation's head.
    Returns (A, n_mb, batch)."""
    n_seq = perm.shape[-1]
    n_mb = -(-n_seq // batch)
    pad = n_mb * batch - n_seq
    if pad:
        perm = torch.cat([perm, perm[..., :pad]], dim=-1)
    return perm.reshape(perm.shape[:-1] + (n_mb, batch))


def train_aip(params, dataset, key, cfg: AIPConfig):
    """Minibatch Adam on BCE. dataset: {feats (A,S,T,F), u (A,S,T,M),
    resets (A,S,T)}; key (A, 2). Returns (params, final loss (A,))."""
    opt = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(b2=0.999, weight_decay=0.0)
    n_seq = dataset["feats"].shape[1]
    batch = min(cfg.batch, n_seq)
    ekeys = R.split(key, cfg.epochs)
    for e in range(cfg.epochs):
        perm = R.permutation(ekeys[..., e, :], n_seq)
        idxs = epoch_minibatch_indices(perm, batch)
        losses = []
        for j in range(idxs.shape[1]):
            mb = take_rows(dataset, idxs[:, j])
            flat = [p.detach().requires_grad_() for p in leaves(params)]
            with torch.enable_grad():
                loss = bce_loss(unflatten_like(params, flat), mb["feats"],
                                mb["u"], mb["resets"], cfg)
                grads = torch.autograd.grad(loss.sum(), flat)
            master, opt = adamw.update(unflatten_like(params, list(grads)),
                                       opt, cfg.lr, opt_cfg)
            params = adamw.cast_like(master, params)
            losses.append(loss.detach())
    return params, torch.stack(losses).mean(0)


@torch.no_grad()
def eval_ce(params, dataset, cfg: AIPConfig):
    """CE of each agent's AIP on held-out GS trajectories -> (A,).

    Evaluated in fixed-size sequence chunks (``cfg.eval_chunk``) so the
    activations stay bounded; S <= chunk takes the single-batch path."""
    feats, u, resets = dataset["feats"], dataset["u"], dataset["resets"]
    n_seq, t_len = feats.shape[1], feats.shape[2]
    chunk = max(1, cfg.eval_chunk)
    if n_seq <= chunk:
        return bce_loss(params, feats, u, resets, cfg)
    total = torch.zeros(feats.shape[0], device=feats.device)
    for s in range(0, n_seq, chunk):
        f, uu, rr = (x[:, s:s + chunk] for x in (feats, u, resets))
        logits = aip_sequence(params, f, initial_hidden(
            cfg, f.shape[0], f.shape[1], device=f.device), rr, cfg)
        total = total + _bce_elementwise(logits, uu).sum(dim=(1, 2, 3))
    return total / (n_seq * t_len * u.shape[-1])

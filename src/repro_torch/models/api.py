"""Uniform model API over the three backbone kinds (lm / encdec / vlm) —
the port of ``repro/models/api.py``.

``ArchSpec`` is what a config file in ``repro_torch.configs`` produces.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models import encdec, lm, vlm
from repro_torch.tree import leaves, leaves_with_path


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    kind: str                      # lm | encdec | vlm
    cfg: object                    # ModelConfig | EncDecConfig
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    sub_quadratic: bool = False    # eligible for the long_500k cell
    has_decode: bool = True
    source: str = ""
    # stub-frontend shapes
    n_frames: int = 0              # encdec stub frames
    n_patches: int = 0             # vlm stub patches
    vision_dim: int = 0


def init(gen, spec: ArchSpec):
    """Params on ``gen.device`` from a seeded ``torch.Generator``."""
    if spec.kind == "encdec":
        return encdec.init_encdec(gen, spec.cfg)
    return lm.init_lm(gen, spec.cfg)


def logical_specs(spec: ArchSpec):
    if spec.kind == "encdec":
        return encdec.encdec_logical_specs(spec.cfg)
    return lm.lm_logical_specs(spec.cfg)


def loss_fn(spec: ArchSpec, *, act_constraint=None):
    """``loss(params, batch) -> (loss, metrics)`` for the spec's kind."""
    if spec.kind == "encdec":
        return lambda p, b: encdec.encdec_loss(
            p, b, spec.cfg, act_constraint=act_constraint)
    if spec.kind == "vlm":
        return lambda p, b: vlm.vlm_loss(
            p, b, spec.cfg, act_constraint=act_constraint)
    return lambda p, b: lm.lm_loss(
        p, b, spec.cfg, act_constraint=act_constraint)


def init_caches(params, spec: ArchSpec, batch: int, max_len: int,
                batch_inputs: Optional[dict] = None):
    binp = batch_inputs or {}
    if spec.kind == "encdec":
        return encdec.init_decode_caches(params, spec.cfg, binp["frames"],
                                         batch, max_len)
    if spec.kind == "vlm":
        return vlm.init_decode_caches(params, spec.cfg, binp["patches"],
                                      batch, max_len)
    return lm.init_caches(params, spec.cfg, batch, max_len)


def decode_step(params, token, caches, index: int, spec: ArchSpec, *,
                logits_constraint=None):
    if spec.kind == "encdec":
        return encdec.decode_step(params, token, caches, index, spec.cfg,
                                  logits_constraint=logits_constraint)
    return lm.decode_step(params, token, caches, index, spec.cfg,
                          logits_constraint=logits_constraint)


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(params))


def active_param_count(params, spec: ArchSpec) -> int:
    """For MoE: count experts at top_k/num_experts weight (6·N_active·D).
    As the reference counts it: only a 3-D ``up``/``down``/``gate`` leaf
    is scaled, so a stacked expert weight (layers, E, d, f) counts in
    full."""
    moe_specs = [s.moe for s in _periods(spec) if s.moe is not None]
    total = 0
    for path, leaf in leaves_with_path(params):
        frac = 1.0
        if any(k in ("up", "down", "gate") for k in path) \
                and leaf.ndim == 3 and moe_specs:
            frac = moe_specs[0].top_k / moe_specs[0].num_experts
        total += int(leaf.numel() * frac)
    return total


def _periods(spec: ArchSpec):
    cfg = spec.cfg.decoder if spec.kind == "encdec" else spec.cfg
    out = list(cfg.period)
    if cfg.shared is not None:
        out.append(cfg.shared)
    return out

"""Uniform model API — the port of ``repro/models/api.py``, for
``kind="lm"`` only.

``ArchSpec`` is what a config file in ``repro_torch.configs`` produces.
The encdec and vlm kinds, ``loss_fn``, ``logical_specs`` and
``active_param_count`` are not ported (ROADMAP queue 1 item 12); a
non-lm spec raises.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models import lm
from repro_torch.tree import leaves


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    kind: str                      # lm | encdec | vlm
    cfg: object                    # ModelConfig
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    sub_quadratic: bool = False    # eligible for the long_500k cell
    has_decode: bool = True
    source: str = ""
    n_frames: int = 0              # encdec stub frames
    n_patches: int = 0             # vlm stub patches
    vision_dim: int = 0


def _lm_only(spec: ArchSpec) -> None:
    if spec.kind != "lm":
        raise NotImplementedError(
            f"kind={spec.kind!r} models are not ported yet (ROADMAP queue 1 "
            f"item 12)")


def init(gen, spec: ArchSpec):
    """Params on ``gen.device`` from a seeded ``torch.Generator``."""
    _lm_only(spec)
    return lm.init_lm(gen, spec.cfg)


def init_caches(params, spec: ArchSpec, batch: int, max_len: int):
    _lm_only(spec)
    return lm.init_caches(params, spec.cfg, batch, max_len)


def decode_step(params, token, caches, index: int, spec: ArchSpec):
    _lm_only(spec)
    return lm.decode_step(params, token, caches, index, spec.cfg)


def param_count(params) -> int:
    return sum(x.numel() for x in leaves(params))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(params))

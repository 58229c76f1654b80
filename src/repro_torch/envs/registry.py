"""Environment registry — the port of ``repro/envs/registry.py``.

Env modules self-register at import (the bottom of each env module);
``make(name, side=...)`` resolves a name to ``(module, cfg)``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """A registered environment: its module, default config, and sizer."""
    name: str
    module: Any                      # module following the base.py protocol
    default_cfg: Any                 # frozen dataclass with .info()
    sizer: Callable[[Any, int], Any]


_ENVS: dict = {}


def register(name: str, module, default_cfg, *,
             sizer: Optional[Callable] = None) -> None:
    """Register an env module under ``name``. Idempotent re-registration
    of the same module is allowed (module reloads); clashes raise."""
    prev = _ENVS.get(name)
    if prev is not None and prev.module.__name__ != module.__name__:
        raise ValueError(f"env {name!r} already registered "
                         f"by {prev.module.__name__}")
    if sizer is None:
        sizer = lambda cfg, side: cfg
    _ENVS[name] = EnvSpec(name, module, default_cfg, sizer)


def _ensure_builtins() -> None:
    # importing the package runs the built-in modules' register() calls
    import repro_torch.envs  # noqa: F401


def names() -> list:
    """Sorted names of every registered environment."""
    _ensure_builtins()
    return sorted(_ENVS)


def get(name: str) -> EnvSpec:
    _ensure_builtins()
    try:
        return _ENVS[name]
    except KeyError:
        raise KeyError(f"unknown env {name!r}; registered: {names()}") \
            from None


def make(name: str, *, side: Optional[int] = None, **overrides):
    """Resolve ``name`` to ``(module, cfg)``; ``side`` applies the env's
    sizer, ``overrides`` replace config fields after sizing."""
    spec = get(name)
    cfg = spec.default_cfg
    if side is not None:
        cfg = spec.sizer(cfg, side)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return spec.module, cfg

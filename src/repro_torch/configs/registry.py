"""Architecture registry — the port of ``repro/configs/registry.py``:
``get(arch_id, reduced=...)`` -> ArchSpec, over all ten architectures of
the reference.

Left out: ``input_specs``, ``concrete_inputs`` and ``cell_supported``
(the dry-run's ShapeDtypeStruct stand-ins and cells, the LM mesh, ROADMAP
queue 1 item 12d); callers draw tokens, frames and patches from a seeded
``torch.Generator``.
"""
from __future__ import annotations

from repro_torch.configs import (dbrx_132b, gemma2_9b, granite_moe_1b,
                                 llama32_vision_90b, mamba2_780m,
                                 qwen1_5_32b, tinyllama_1_1b, whisper_tiny,
                                 yi_34b, zamba2_1_2b)

ARCHS = {
    "yi-34b": yi_34b.make,
    "gemma2-9b": gemma2_9b.make,
    "tinyllama-1.1b": tinyllama_1_1b.make,
    "qwen1.5-32b": qwen1_5_32b.make,
    "zamba2-1.2b": zamba2_1_2b.make,
    "granite-moe-1b-a400m": granite_moe_1b.make,
    "dbrx-132b": dbrx_132b.make,
    "whisper-tiny": whisper_tiny.make,
    "llama-3.2-vision-90b": llama32_vision_90b.make,
    "mamba2-780m": mamba2_780m.make,
}


def get(arch_id: str, *, reduced: bool = False):
    return ARCHS[arch_id](reduced=reduced)


def list_archs():
    return sorted(ARCHS)

"""Architecture registry — the port of ``repro/configs/registry.py``:
``get(arch_id, reduced=...)`` -> ArchSpec over the ported archs.

Ported: gemma2-9b and tinyllama-1.1b (dense decoder LMs). Every other
arch of the reference raises ``NotImplementedError`` (ROADMAP queue 1 item
17). ``input_specs``/``concrete_inputs`` (JAX ShapeDtypeStruct stand-ins
for the dry-run) are not ported; callers draw tokens from a seeded
``torch.Generator``.
"""
from __future__ import annotations

from repro_torch.configs import gemma2_9b, tinyllama_1_1b

ARCHS = {
    "gemma2-9b": gemma2_9b.make,
    "tinyllama-1.1b": tinyllama_1_1b.make,
}
NOT_PORTED = ("yi-34b", "qwen1.5-32b", "zamba2-1.2b", "granite-moe-1b-a400m",
              "dbrx-132b", "whisper-tiny", "llama-3.2-vision-90b",
              "mamba2-780m")


def get(arch_id: str, *, reduced: bool = False):
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet (ROADMAP queue 1 item 12)")
    return ARCHS[arch_id](reduced=reduced)


def list_archs():
    return sorted(ARCHS)

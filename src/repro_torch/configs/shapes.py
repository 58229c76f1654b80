"""Assigned input shapes — 4 per LM-family architecture (the port of
``repro/configs/shapes.py``, unchanged).

``decode_*`` and ``long_*`` lower ``serve_step`` (one new token against a
KV cache of the given length), not ``train_step``. ``long_500k`` requires
sub-quadratic attention and runs only for ssm/hybrid/local-attention archs
(skips recorded in the roofline table).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

REDUCED_SHAPES = {
    "train_4k": Shape("train_4k", 128, 2, "train"),
    "prefill_32k": Shape("prefill_32k", 256, 2, "prefill"),
    "decode_32k": Shape("decode_32k", 256, 2, "decode"),
    "long_500k": Shape("long_500k", 512, 1, "decode"),
}

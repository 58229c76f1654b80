"""Deterministic synthetic data sources — the port of
``repro/data/synthetic.py``.

LM training drivers use a structured synthetic stream: a Zipf-distributed
unigram background plus a successor overlay on every odd position, a
learnable next-token structure. Token batches are the reference's bit for
bit: the key streams run through ``repro_torch.random`` (Threefry, as
``jax.random``), on whatever device the key is on. ``frames`` and
``patches`` follow the reference's construction through
``repro_torch.random.normal``, whose ``erfinv`` is torch's: close to the
reference's values, not equal to them.
"""
from __future__ import annotations

import torch

from repro_torch import random as R


def zipf_logits(vocab: int, alpha: float = 1.1, device="cpu"):
    ranks = torch.arange(1, vocab + 1, dtype=torch.float32, device=device)
    return -alpha * torch.log(ranks)


def lm_batch(key, batch: int, seq: int, vocab: int, *, alpha: float = 1.1):
    """Returns dict(tokens, labels) with labels = next-token shift (int64,
    (batch, seq), on the key's device).

    Tokens follow zipf(alpha) with a deterministic "grammar": every odd
    position takes (t*7+3) % vocab of the token before it with
    probability 1/2.
    """
    k1, k2 = R.split(key)
    base = R.categorical(k1, zipf_logits(vocab, alpha, key.device)[None, None],
                         shape=(batch, seq + 1))
    succ = (base * 7 + 3) % vocab
    coin = R.bernoulli(k2, 0.5, (batch, seq + 1))
    odd = base[:, 1::2]
    toks = base.clone()
    toks[:, 1::2] = torch.where(coin[:, 1::2],
                                succ[:, 0:seq:2][:, :odd.shape[1]], odd)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def frames(key, batch: int, n_frames: int, dim: int, dtype=torch.bfloat16):
    """Stub audio-frontend output (whisper): smooth random embeddings."""
    x = R.normal(key, (batch, n_frames, dim))
    x = (x + torch.roll(x, 1, dims=1) + torch.roll(x, 2, dims=1)) / 3.0
    return x.to(dtype)


def patches(key, batch: int, n_patches: int, dim: int, dtype=torch.bfloat16):
    """Stub vision-tower output (llama-vision): patch embeddings."""
    return R.normal(key, (batch, n_patches, dim)).to(dtype)

"""gemma2-9b [dense] — local+global alternating attention, logit softcaps,
post-norms, tied embeddings with sqrt(d) scaling. 42L d_model=3584 16H
(kv=8, head_dim=256) d_ff=14336 vocab=256000. [arXiv:2408.00118; hf]

long_500k eligibility: half the layers are sliding-window-4096 (O(T·w));
the global layers use a sequence-sharded KV cache (LONG_CONTEXT_RULES).
"""
from repro_torch.configs import common
from repro_torch.models import lm

WINDOW = 4_096


def make(reduced: bool = False):
    if reduced:
        local = common.dense_layer(64, 4, 2, 128, head_dim=16, window=32,
                                   softcap=50.0, post_norm=True,
                                   activation="gelu")
        glob = common.dense_layer(64, 4, 2, 128, head_dim=16,
                                  softcap=50.0, post_norm=True,
                                  activation="gelu")
        cfg = lm.ModelConfig(
            name="gemma2-9b-reduced", vocab=256, d_model=64, n_layers=2,
            period=(local, glob), tie_embeddings=True, final_softcap=30.0,
            embed_scale=True, loss_chunk=64)
    else:
        local = common.dense_layer(3_584, 16, 8, 14_336, head_dim=256,
                                   window=WINDOW, softcap=50.0,
                                   post_norm=True, activation="gelu")
        glob = common.dense_layer(3_584, 16, 8, 14_336, head_dim=256,
                                  softcap=50.0, post_norm=True,
                                  activation="gelu")
        cfg = lm.ModelConfig(
            name="gemma2-9b", vocab=256_000, d_model=3_584, n_layers=42,
            period=(local, glob), tie_embeddings=True, final_softcap=30.0,
            embed_scale=True, loss_chunk=1024)
    return common.lm_spec("gemma2-9b", "dense", cfg, sub_quadratic=True,
                          source="arXiv:2408.00118; hf")

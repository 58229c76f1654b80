"""dbrx-132b [moe] — 16 experts top-4. 40L d_model=6144 48H (kv=8)
d_ff=10752 vocab=100352. [hf:databricks/dbrx-base; unverified]"""
from repro_torch.configs import common
from repro_torch.models import lm


def make(reduced: bool = False):
    if reduced:
        cfg = lm.ModelConfig(
            name="dbrx-reduced", vocab=256, d_model=64, n_layers=2,
            period=(common.moe_layer(64, 4, 2, 64, 4, 2),),
            tie_embeddings=False, loss_chunk=64)
    else:
        cfg = lm.ModelConfig(
            name="dbrx-132b", vocab=100_352, d_model=6_144, n_layers=40,
            period=(common.moe_layer(6_144, 48, 8, 10_752, 16, 4,
                                     theta=500_000.0),),
            tie_embeddings=False, loss_chunk=1024)
    return common.lm_spec("dbrx-132b", "moe", cfg,
                          source="hf:databricks/dbrx-base; unverified")

"""granite-moe-1b-a400m [moe] — 32 experts top-8, fine-grained d_ff=512.
24L d_model=1024 16H (kv=8) vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from repro_torch.configs import common
from repro_torch.models import lm


def make(reduced: bool = False):
    if reduced:
        cfg = lm.ModelConfig(
            name="granite-moe-reduced", vocab=256, d_model=64, n_layers=2,
            period=(common.moe_layer(64, 4, 2, 64, 4, 2),),
            tie_embeddings=True, loss_chunk=64)
    else:
        cfg = lm.ModelConfig(
            name="granite-moe-1b-a400m", vocab=49_155, d_model=1_024,
            n_layers=24,
            period=(common.moe_layer(1_024, 16, 8, 512, 32, 8),),
            tie_embeddings=True, loss_chunk=2048)
    return common.lm_spec("granite-moe-1b-a400m", "moe", cfg,
                          source="hf:ibm-granite/granite-3.0-1b-a400m-base; hf")

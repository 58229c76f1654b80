"""yi-34b [dense] — llama-arch GQA. 60L d_model=7168 56H (kv=8)
d_ff=20480 vocab=64000. [arXiv:2403.04652; hf]"""
from repro_torch.configs import common
from repro_torch.models import lm


def make(reduced: bool = False):
    if reduced:
        cfg = lm.ModelConfig(
            name="yi-34b-reduced", vocab=256, d_model=64, n_layers=2,
            period=(common.dense_layer(64, 4, 2, 128),),
            tie_embeddings=False, loss_chunk=64)
    else:
        cfg = lm.ModelConfig(
            name="yi-34b", vocab=64_000, d_model=7_168, n_layers=60,
            period=(common.dense_layer(7_168, 56, 8, 20_480,
                                       theta=5_000_000.0),),
            tie_embeddings=False, loss_chunk=2048)
    return common.lm_spec("yi-34b", "dense", cfg,
                          source="arXiv:2403.04652; hf")

"""tinyllama-1.1b [dense] — llama2-arch small. 22L d_model=2048 32H (kv=4)
d_ff=5632 vocab=32000. [arXiv:2401.02385; hf]"""
from repro_torch.configs import common
from repro_torch.models import lm


def make(reduced: bool = False):
    if reduced:
        cfg = lm.ModelConfig(
            name="tinyllama-reduced", vocab=256, d_model=64, n_layers=2,
            period=(common.dense_layer(64, 8, 2, 128),),
            tie_embeddings=False, loss_chunk=64)
    else:
        cfg = lm.ModelConfig(
            name="tinyllama-1.1b", vocab=32_000, d_model=2_048, n_layers=22,
            period=(common.dense_layer(2_048, 32, 4, 5_632),),
            tie_embeddings=False, loss_chunk=2048)
    return common.lm_spec("tinyllama-1.1b", "dense", cfg,
                          source="arXiv:2401.02385; hf")

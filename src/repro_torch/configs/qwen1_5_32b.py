"""qwen1.5-32b [dense] — QKV bias, near-MHA (kv=40). 64L d_model=5120 40H
(kv=40) d_ff=27392 vocab=152064. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs import common
from repro_torch.models import lm


def make(reduced: bool = False):
    if reduced:
        cfg = lm.ModelConfig(
            name="qwen1.5-reduced", vocab=256, d_model=64, n_layers=2,
            period=(common.dense_layer(64, 4, 4, 128, bias=True),),
            tie_embeddings=False, loss_chunk=64)
    else:
        cfg = lm.ModelConfig(
            name="qwen1.5-32b", vocab=152_064, d_model=5_120, n_layers=64,
            period=(common.dense_layer(5_120, 40, 40, 27_392, bias=True,
                                       theta=1_000_000.0),),
            tie_embeddings=False, loss_chunk=1024)
    return common.lm_spec("qwen1.5-32b", "dense", cfg,
                          source="hf:Qwen/Qwen1.5-0.5B; hf")

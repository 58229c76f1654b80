"""mamba2-780m [ssm] — attention-free SSD. 48L d_model=1536 d_ff=0
vocab=50280, ssm_state=128. [arXiv:2405.21060; unverified]"""
from repro_torch.configs import common
from repro_torch.models import lm


def make(reduced: bool = False):
    if reduced:
        cfg = lm.ModelConfig(
            name="mamba2-reduced", vocab=256, d_model=64, n_layers=2,
            period=(common.ssm_layer(64, 16, head_dim=16, chunk=16),),
            tie_embeddings=True, loss_chunk=64)
    else:
        cfg = lm.ModelConfig(
            name="mamba2-780m", vocab=50_280, d_model=1_536, n_layers=48,
            period=(common.ssm_layer(1_536, 128, head_dim=64),),
            tie_embeddings=True, loss_chunk=2048)
    return common.lm_spec("mamba2-780m", "ssm", cfg, sub_quadratic=True,
                          source="arXiv:2405.21060; unverified")

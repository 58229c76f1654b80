"""zamba2-1.2b [hybrid] — Mamba2 backbone + SHARED attention block.
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]

Mapping note (DESIGN.md §Arch-applicability): zamba2 interleaves one
weight-shared attention(+MLP) block among its mamba layers; here the 38
mamba2 layers lower as 19 scan repeats of period (ssm, ssm), and the
shared block applies once per repeat — same weight-sharing structure,
compile-time O(period).

long_500k eligibility: O(1) SSM state; the shared attention block's KV
cache is sequence-sharded under LONG_CONTEXT_RULES.
"""
from repro_torch.configs import common
from repro_torch.models import blocks, lm


def make(reduced: bool = False):
    if reduced:
        period = (common.ssm_layer(64, 16, head_dim=16, chunk=16),
                  common.ssm_layer(64, 16, head_dim=16, chunk=16))
        shared = common.dense_layer(64, 4, 4, 128)
        cfg = lm.ModelConfig(
            name="zamba2-reduced", vocab=256, d_model=64, n_layers=2,
            period=period, shared=shared, tie_embeddings=True,
            loss_chunk=64)
    else:
        period = (common.ssm_layer(2_048, 64, head_dim=64),
                  common.ssm_layer(2_048, 64, head_dim=64))
        shared = common.dense_layer(2_048, 32, 32, 8_192)
        cfg = lm.ModelConfig(
            name="zamba2-1.2b", vocab=32_000, d_model=2_048, n_layers=38,
            period=period, shared=shared, tie_embeddings=True,
            loss_chunk=2048)
    return common.lm_spec("zamba2-1.2b", "hybrid", cfg, sub_quadratic=True,
                          source="arXiv:2411.15242; hf")

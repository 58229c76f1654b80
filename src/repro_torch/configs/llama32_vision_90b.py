"""llama-3.2-vision-90b [vlm] — cross-attn image layers; vision tower is a
STUB (input_specs provides patch embeddings). 100L d_model=8192 64H (kv=8)
d_ff=28672 vocab=128256. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Mapping: period of five = 4 self-attention blocks + 1 tanh-gated
cross-attention block (the released checkpoints' 4:1 self:cross ratio;
100 layers = 80 self + 20 cross).
"""
from repro_torch.configs import common
from repro_torch.models import api, blocks, lm

N_PATCHES = 1_601          # 1 tile × (224/14)² + cls, stubbed
VISION_DIM = 7_680


def make(reduced: bool = False):
    if reduced:
        d, h, kv, ff, vocab, vdim, patches = 64, 4, 2, 128, 256, 32, 16
        n_layers = 5
    else:
        d, h, kv, ff, vocab, vdim, patches = (8_192, 64, 8, 28_672,
                                              128_256, VISION_DIM, N_PATCHES)
        n_layers = 100
    self_l = common.dense_layer(d, h, kv, ff, theta=500_000.0)
    cross_l = blocks.LayerSpec(
        mixer="cross_attn", attn=common.attn_cfg(d, h, kv),
        ffn="mlp", mlp=common.mlp_cfg(d, ff), gated_cross=True,
        cross_kv_dim=vdim, d_model=d)
    cfg = lm.ModelConfig(
        name="llama-3.2-vision-90b" + ("-reduced" if reduced else ""),
        vocab=vocab, d_model=d, n_layers=n_layers,
        period=(self_l, self_l, self_l, self_l, cross_l),
        tie_embeddings=False, loss_chunk=1024)
    return api.ArchSpec(arch_id="llama-3.2-vision-90b", kind="vlm", cfg=cfg,
                        family="vlm", n_patches=patches, vision_dim=vdim,
                        source="hf:meta-llama/Llama-3.2-11B-Vision; unverified")

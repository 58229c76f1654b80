"""whisper-tiny [audio] — enc-dec; conv frontend is a STUB (input_specs
provides precomputed frame embeddings (B, 1500, 384)). 4L d_model=384 6H
(kv=6) d_ff=1536 vocab=51865. [arXiv:2212.04356; unverified]

Mapping note: each whisper decoder layer (self-attn + cross-attn + MLP)
lowers as a period of two blocks [self/no-ffn, cross/mlp] — identical
compute graph, scan-friendly. RMSNorm replaces LayerNorm uniformly across
the framework (DESIGN.md §Assumptions).
"""
from repro_torch.configs import common
from repro_torch.models import api, blocks, encdec, lm

N_FRAMES = 1_500


def _dec_period(d, h, kv, ff, dh):
    self_l = blocks.LayerSpec(
        mixer="attn", attn=common.attn_cfg(d, h, kv, head_dim=dh),
        ffn="none", d_model=d)
    cross_l = blocks.LayerSpec(
        mixer="cross_attn", attn=common.attn_cfg(d, h, kv, head_dim=dh),
        ffn="mlp", mlp=common.mlp_cfg(d, ff, activation="gelu"),
        cross_kv_dim=d, d_model=d)
    return (self_l, cross_l)


def make(reduced: bool = False):
    if reduced:
        d, h, kv, ff, dh, layers_, enc_l, frames = 64, 4, 4, 128, 16, 2, 2, 32
        vocab = 256
    else:
        d, h, kv, ff, dh, layers_, enc_l, frames = 384, 6, 6, 1_536, 64, 4, 4, N_FRAMES
        vocab = 51_865
    dec = lm.ModelConfig(
        name="whisper-dec", vocab=vocab, d_model=d, n_layers=2 * layers_,
        period=_dec_period(d, h, kv, ff, dh), tie_embeddings=True,
        loss_chunk=256)
    enc_layer = blocks.LayerSpec(
        mixer="attn", attn=common.attn_cfg(d, h, kv, head_dim=dh,
                                           causal=False),
        ffn="mlp", mlp=common.mlp_cfg(d, ff, activation="gelu"), d_model=d)
    cfg = encdec.EncDecConfig(
        name="whisper-tiny" + ("-reduced" if reduced else ""),
        encoder_period=(enc_layer,), encoder_layers=enc_l, decoder=dec,
        d_model=d)
    return api.ArchSpec(arch_id="whisper-tiny", kind="encdec", cfg=cfg,
                        family="audio", n_frames=frames,
                        source="arXiv:2212.04356; unverified")

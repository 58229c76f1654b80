"""Builders shared by the architecture config files — the port of
``repro/configs/common.py``."""
from __future__ import annotations

from repro_torch.models import api, blocks
from repro_torch.nn import attention as attn_mod
from repro_torch.nn import layers, moe as moe_mod, ssm as ssm_mod


def attn_cfg(d_model, heads, kv_heads, *, head_dim=None, bias=False,
             window=None, softcap=None, theta=10_000.0, causal=True):
    return attn_mod.AttentionConfig(
        d_model=d_model, num_heads=heads, num_kv_heads=kv_heads,
        head_dim=head_dim, use_qkv_bias=bias, sliding_window=window,
        attn_softcap=softcap, rope_theta=theta, causal=causal)


def mlp_cfg(d_model, d_ff, *, activation="swiglu"):
    return layers.MLPConfig(d_model=d_model, d_ff=d_ff, activation=activation)


def dense_layer(d_model, heads, kv_heads, d_ff, **kw):
    post_norm = kw.pop("post_norm", False)
    activation = kw.pop("activation", "swiglu")
    return blocks.LayerSpec(
        mixer="attn", attn=attn_cfg(d_model, heads, kv_heads, **kw),
        ffn="mlp", mlp=mlp_cfg(d_model, d_ff, activation=activation),
        post_norm=post_norm, d_model=d_model)


def moe_layer(d_model, heads, kv_heads, d_ff, n_experts, top_k, *,
              dispatch="gather", token_shards=16, **kw):
    # the gather dispatch with group-local routing (16 token groups) is the
    # reference's shipped default; dispatch="dense" is its Switch/Mesh-style
    # ablation (the same result, one global routing group)
    return blocks.LayerSpec(
        mixer="attn", attn=attn_cfg(d_model, heads, kv_heads, **kw),
        ffn="moe",
        moe=moe_mod.MoEConfig(d_model=d_model, d_ff=d_ff,
                              num_experts=n_experts, top_k=top_k,
                              dispatch=dispatch, token_shards=token_shards),
        d_model=d_model)


def ssm_layer(d_model, state, *, head_dim=64, chunk=128):
    return blocks.LayerSpec(
        mixer="ssm",
        ssm=ssm_mod.SSMConfig(d_model=d_model, state=state,
                              head_dim=head_dim, chunk=chunk),
        ffn="none", d_model=d_model)


def lm_spec(arch_id, family, cfg, *, sub_quadratic=False, source="",
            **extra):
    return api.ArchSpec(arch_id=arch_id, kind="lm", cfg=cfg, family=family,
                        sub_quadratic=sub_quadratic, source=source, **extra)

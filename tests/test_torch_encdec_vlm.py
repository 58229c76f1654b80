"""The port's enc-dec and VLM backbones (``repro_torch.models.{encdec,
vlm}``, cross-attention, ``launch.steps``) against the reference
(``repro.models.{encdec,vlm,lm}``) on reduced whisper-tiny (a non-causal
encoder over stub frames, a decoder of [self/no-ffn, cross/GELU-mlp]
periods) and reduced llama-3.2-vision (four self-attention blocks and one
tanh-gated cross-attention block over stub patches of another width),
with the reference's ``init`` parameters carried across. The gates are
zero at init, which would hide the cross-attention path, so both sides
set llama-vision's ``gate_attn``/``gate_ffn`` to 0.5 first.

Tolerances (|err| <= tol + tol·|reference|): float32, every config dtype
replaced, 1e-4 on encoder outputs, hidden states, logits and caches.
bfloat16 (the configs as shipped) 5e-2 times max(1, largest magnitude):
each side rounds activations to bf16 at the same points.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_close_scaled, layer_dtype, plain,
                           replace_model_dtype, to_torch)
from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models import vlm as jvlm
from repro_torch.configs import registry as tregistry
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.tree import leaves

ARCHS = ("whisper-tiny", "llama-3.2-vision-90b")
F32_TOL, BF16_TOL = 1e-4, 5e-2
GATE = 0.5
B, T_PROMPT, N_DECODE = 2, 24, 12


def replace_dtype(spec, dt, use_flash=False):
    cfg = spec.cfg
    if spec.kind == "encdec":
        dec = cfg.decoder
        if dt is not None:
            cfg = dataclasses.replace(
                cfg, dtype=dt, encoder_period=tuple(
                    layer_dtype(ls, dt) for ls in cfg.encoder_period))
            dec = replace_model_dtype(dec, dt)
        return dataclasses.replace(spec, cfg=dataclasses.replace(
            cfg, decoder=dataclasses.replace(dec, use_flash=use_flash)))
    if dt is not None:
        cfg = replace_model_dtype(cfg, dt)
    return dataclasses.replace(spec, cfg=dataclasses.replace(
        cfg, use_flash=use_flash))


def specs(arch, dtype, use_flash=False):
    f32 = dtype == "float32"
    return (replace_dtype(jregistry.get(arch, reduced=True),
                          jnp.float32 if f32 else None, use_flash),
            replace_dtype(tregistry.get(arch, reduced=True),
                          torch.float32 if f32 else None, use_flash))


def open_gates(params):
    """llama-vision's cross blocks with both tanh gates at GATE."""
    for layer in params["layers"]:
        for name in ("gate_attn", "gate_ffn"):
            if name in layer:
                layer[name] = jnp.full_like(layer[name], GATE)
    return params


_PARAMS = {}


def params_for(arch, dtype):
    if (arch, dtype) not in _PARAMS:
        js, _ = specs(arch, dtype)
        jp = jax.jit(lambda k: japi.init(k, js))(jax.random.PRNGKey(0))
        if js.kind == "vlm":
            jp = open_gates(jp)
        _PARAMS[arch, dtype] = (jp, to_torch(jp))
    return _PARAMS[arch, dtype]


def batch(spec, b, t, dtype, seed=0):
    """Tokens and the stub frontend's input, numpy from a seed: the
    reference's inputs and the port's tensors."""
    rs = np.random.RandomState(seed)
    cfg = spec.cfg.decoder if spec.kind == "encdec" else spec.cfg
    toks = rs.randint(0, cfg.vocab, (b, t)).astype(np.int32)
    if spec.kind == "encdec":
        name, shape = "frames", (b, spec.n_frames, spec.cfg.d_model)
    else:
        name, shape = "patches", (b, spec.n_patches, spec.vision_dim)
    src = rs.randn(*shape).astype(np.float32)
    jb = {"tokens": toks, name: jnp.asarray(src)}
    tb = {"tokens": torch.from_numpy(toks), name: torch.from_numpy(src)}
    if dtype == "bfloat16":
        jb[name] = jb[name].astype(jnp.bfloat16)
        tb[name] = tb[name].bfloat16()
    return jb, tb


def assert_dtype_close(got, want, dtype):
    got = np.asarray(got.float().numpy() if isinstance(got, torch.Tensor)
                     else got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert_close_scaled(got, want, BF16_TOL)


def reference_prefill(jp, jb, js):
    """The reference's models on a prefill batch: (hidden states, the
    last-position logits)."""
    if js.kind == "encdec":
        enc = jencdec.encode(jp, jb["frames"], js.cfg)
        jp, cfg = jp["decoder"], js.cfg.decoder
        x, _ = jlm.forward(jp, jb["tokens"], cfg, cross_kv=enc)
    else:
        cfg = js.cfg
        x, _ = jlm.forward(jp, jb["tokens"], cfg, cross_kv=jb["patches"])
    return x, jlm.logits_fn(jp, x[:, -1:], cfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_tree_match_reference(arch):
    js, ts = jregistry.get(arch, reduced=True), tregistry.get(arch,
                                                              reduced=True)
    assert plain(ts) == plain(js)
    jp = jax.eval_shape(lambda k: japi.init(k, js), jax.random.PRNGKey(0))
    tp = tapi.init(torch.Generator().manual_seed(0), ts)
    jl_, tl_ = jax.tree.leaves(jp), leaves(tp)
    assert len(jl_) == len(tl_)
    for a, b in zip(jl_, tl_):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert tapi.param_count(tp) == sum(x.size for x in jl_)
    assert tapi.active_param_count(tp, ts) == \
        japi.active_param_count(jp, js)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_encode_matches_reference(dtype):
    js, ts = specs("whisper-tiny", dtype)
    jp, tp = params_for("whisper-tiny", dtype)
    jb, tb = batch(ts, B, T_PROMPT, dtype)
    want = jax.jit(lambda p, f: jencdec.encode(p, f, js.cfg))(
        jp, jb["frames"])
    got = tencdec.encode(tp, tb["frames"], ts.cfg)
    assert got.dtype == ts.cfg.dtype
    assert_dtype_close(got, want, dtype)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype, use_flash):
    """The prefill step's last-position logits and the decoder's hidden
    states, with ``use_flash`` on both sides (the reference's Pallas
    kernel in interpret mode on the decoder's self-attention)."""
    js, ts = specs(arch, dtype, use_flash)
    jp, tp = params_for(arch, dtype)
    jb, tb = batch(ts, B, T_PROMPT, dtype)
    jx, want = jax.jit(lambda p, b: reference_prefill(p, b, js))(jp, jb)
    got = tsteps.make_prefill_step(ts)(tp, tb)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_dtype_close(got, want, dtype)
    cfg = tsteps.model_cfg(ts)
    with torch.inference_mode():
        if ts.kind == "encdec":
            enc = tencdec.encode(tp, tb["frames"], ts.cfg)
            tx, _ = tlm.forward(tp["decoder"], tb["tokens"], cfg,
                                cross_kv=enc)
        else:
            tx, _ = tlm.forward(tp, tb["tokens"], cfg,
                                cross_kv=tb["patches"])
    assert_dtype_close(tx, jx, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """N_DECODE serve steps from caches whose cross-attention K/V were
    projected once from the source: logits at every step and the final
    caches, the cross K/V included."""
    js, ts = specs(arch, dtype)
    jp, tp = params_for(arch, dtype)
    jb, tb = batch(ts, B, N_DECODE, dtype, seed=1)
    if js.kind == "encdec":
        jcaches = jencdec.init_decode_caches(jp, js.cfg, jb["frames"], B,
                                             N_DECODE)
        jstep = jax.jit(lambda p, t, c, i: jencdec.decode_step(
            p, t, c, i, js.cfg))
        binp = {"frames": tb["frames"]}
    else:
        jcaches = jvlm.init_decode_caches(jp, js.cfg, jb["patches"], B,
                                          N_DECODE)
        jstep = jax.jit(lambda p, t, c, i: jvlm.decode_step(
            p, t, c, i, js.cfg))
        binp = {"patches": tb["patches"]}
    with torch.inference_mode():
        tcaches = tapi.init_caches(tp, ts, B, N_DECODE, batch_inputs=binp)
    serve = tsteps.make_serve_step(ts)
    toks = jb["tokens"]
    for i in range(N_DECODE):
        want, jcaches = jstep(jp, toks[:, i:i + 1], jcaches,
                              jnp.asarray(i, jnp.int32))
        got, tcaches = serve(tp, torch.from_numpy(toks[:, i:i + 1]),
                             tcaches, i)
        assert_dtype_close(got, want, dtype)
    jl_, tl_ = jax.tree.leaves(jcaches["layers"]), leaves(tcaches["layers"])
    assert len(jl_) == len(tl_)
    for a, b in zip(jl_, tl_):
        assert_dtype_close(b, a, dtype)


def test_cross_attention_reaches_the_logits():
    """With the gates open, the source changes the decoder's logits (the
    tests above would pass on a model that ignored it only if the source
    were inert)."""
    for arch in ARCHS:
        _, ts = specs(arch, "float32")
        _, tp = params_for(arch, "float32")
        _, tb = batch(ts, B, T_PROMPT, "float32")
        step = tsteps.make_prefill_step(ts)
        name = "frames" if ts.kind == "encdec" else "patches"
        other = dict(tb, **{name: tb[name] * 2.0 + 1.0})
        assert float((step(tp, tb) - step(tp, other)).abs().max()) > 1e-3

"""The port's LM serving path (``repro_torch.models``, ``configs``,
``launch.steps``) against the reference (``repro.models.lm``): reduced
gemma2-9b (local/global attention, softcaps, post-norms, GELU, tied
embeddings scaled by sqrt(d)) and reduced tinyllama (GQA 4:1, SwiGLU,
untied), with the reference's ``init_lm`` parameters carried across.

Tolerances (|err| <= tol + tol·|reference|): float32, every config dtype
replaced, 1e-4 on hidden states, logits and caches (two layers of
matmuls, norms and softmaxes over the same f32 math). bfloat16 (the
configs as shipped) 5e-2 times max(1, largest magnitude): each side
rounds activations to bf16 at the same points, and a rounding flip of
2^-8 early in the stack propagates through both layers and the
unembedding. ``convert`` carries bf16 leaves bit for bit.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close_scaled, to_np, to_torch
from repro.configs import registry as jregistry
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.configs import common as tcommon
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gemma2-9b", "tinyllama-1.1b")
F32_TOL, BF16_TOL = 1e-4, 5e-2
T_PROMPT, N_DECODE = 48, 40      # both pass the reduced window of 32


def replace_dtype(spec, dt, **kw):
    """``spec`` with every config dtype set to ``dt`` (None keeps them)
    and the model config's fields ``kw`` replaced."""
    cfg = spec.cfg
    if dt is not None:
        period = tuple(dataclasses.replace(
            ls, dtype=dt, attn=dataclasses.replace(ls.attn, dtype=dt),
            mlp=dataclasses.replace(ls.mlp, dtype=dt)) for ls in cfg.period)
        cfg = dataclasses.replace(cfg, dtype=dt, period=period)
    return dataclasses.replace(spec, cfg=dataclasses.replace(cfg, **kw))


def specs(arch, dtype, use_flash=False):
    f32 = dtype == "float32"
    js = replace_dtype(jregistry.get(arch, reduced=True),
                       jnp.float32 if f32 else None, use_flash=use_flash)
    ts = replace_dtype(tregistry.get(arch, reduced=True),
                       torch.float32 if f32 else None, use_flash=use_flash)
    return js, ts


_PARAMS = {}


def params_for(arch, dtype):
    """The reference's init_lm params (cached per arch and dtype) and
    their port copy."""
    if (arch, dtype) not in _PARAMS:
        js, _ = specs(arch, dtype)
        jp = jax.jit(lambda k: jlm.init_lm(k, js.cfg))(jax.random.PRNGKey(0))
        _PARAMS[arch, dtype] = (jp, to_torch(jp))
    return _PARAMS[arch, dtype]


def tokens(b, t, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (b, t)).astype(
        np.int32)


def assert_dtype_close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    else:
        assert_close_scaled(got, want, BF16_TOL)


def as_np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else x


def test_convert_carries_bf16_bit_for_bit():
    x = jax.random.normal(jax.random.PRNGKey(0), (7, 5)).astype(jnp.bfloat16)
    t = convert.from_jax_params({"w": jax.device_get(x)}, "cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        t.view(torch.int16).numpy().view(np.uint16),
        np.asarray(x).view(np.uint16))
    np.testing.assert_array_equal(to_np({"w": t})["w"],
                                  np.asarray(x, np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_param_tree_match_reference(arch):
    js, ts = jregistry.get(arch, reduced=True), tregistry.get(arch,
                                                              reduced=True)
    for name in ("vocab", "d_model", "n_layers", "tie_embeddings",
                 "final_softcap", "embed_scale", "use_flash", "repeats"):
        assert getattr(js.cfg, name) == getattr(ts.cfg, name), name
    for jl, tl in zip(js.cfg.period, ts.cfg.period):
        assert (jl.mixer, jl.ffn, jl.post_norm, jl.d_model) == \
            (tl.mixer, tl.ffn, tl.post_norm, tl.d_model)
        ja, ta = dataclasses.asdict(jl.attn), dataclasses.asdict(tl.attn)
        ja.pop("dtype"), ta.pop("dtype")
        assert ja == ta
        assert (jl.mlp.d_ff, jl.mlp.activation) == (tl.mlp.d_ff,
                                                    tl.mlp.activation)
    # the port's own init: same tree, shapes and dtypes, leaf for leaf
    jp = jax.eval_shape(lambda k: jlm.init_lm(k, js.cfg),
                        jax.random.PRNGKey(0))
    tp = tapi.init(torch.Generator().manual_seed(0), ts)
    jl_, tl_ = jax.tree.leaves(jp), leaves(tp)
    assert len(jl_) == len(tl_)
    for a, b in zip(jl_, tl_):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert tapi.param_count(tp) == sum(x.size for x in jl_)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype, use_flash):
    """Hidden states and the prefill step's last-position logits, with
    ``use_flash`` on both sides (the reference's Pallas kernel in
    interpret mode; the port's kernel op over its plain version)."""
    js, ts = specs(arch, dtype, use_flash)
    jp, tp = params_for(arch, dtype)
    toks = tokens(2, T_PROMPT)
    jx, _ = jax.jit(lambda p, t: jlm.forward(p, t, js.cfg))(jp, toks)
    tx, _ = tlm.forward(tp, torch.from_numpy(toks), ts.cfg)
    assert_dtype_close(as_np(tx), jx, dtype)
    want = jax.jit(lambda p, x: jlm.logits_fn(p, x[:, -1:], js.cfg))(jp, jx)
    got = tsteps.make_prefill_step(ts)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 1, js.cfg.vocab)
    assert_dtype_close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype):
    """40 serve steps from empty caches: past the reduced window of 32, so
    the local layers' ring buffer wraps. Logits at every step and the
    final caches."""
    js, ts = specs(arch, dtype)
    jp, tp = params_for(arch, dtype)
    toks = tokens(2, N_DECODE, seed=1)
    jcaches = jlm.init_caches(jp, js.cfg, 2, N_DECODE)
    tcaches = tapi.init_caches(tp, ts, 2, N_DECODE)
    jstep = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, js.cfg))
    serve = tsteps.make_serve_step(ts)
    for i in range(N_DECODE):
        want, jcaches = jstep(jp, toks[:, i:i + 1], jcaches,
                              jnp.asarray(i, jnp.int32))
        got, tcaches = serve(tp, torch.from_numpy(toks[:, i:i + 1]),
                             tcaches, i)
        assert_dtype_close(got.numpy(), want, dtype)
    if arch == "gemma2-9b":   # local layer: a 32-slot ring after 40 steps
        pos = tcaches["layers"][0]["pos"]
        assert pos.shape[-1] == 32 and int(pos.max()) == N_DECODE - 1
    for a, b in zip(jax.tree.leaves(jcaches["layers"]),
                    [as_np(x) for x in leaves(tcaches["layers"])]):
        assert_dtype_close(b, a, dtype)


def test_decode_continues_prefill_hidden_states():
    """Inside the port: a token-by-token decode gives the prefill's
    last-position logits (float32, reduced gemma2)."""
    _, ts = specs("gemma2-9b", "float32")
    _, tp = params_for("gemma2-9b", "float32")
    toks = torch.from_numpy(tokens(2, T_PROMPT, seed=2))
    want = tsteps.make_prefill_step(ts)(tp, {"tokens": toks})
    caches = tapi.init_caches(tp, ts, 2, T_PROMPT)
    serve = tsteps.make_serve_step(ts)
    for i in range(T_PROMPT):
        got, caches = serve(tp, toks[:, i:i + 1], caches, i)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


def test_init_params_places_the_model():
    """The entry point runs on the card unless the caller asks for the
    CPU; the same seed gives the same parameters."""
    _, ts = specs("gemma2-9b", "bfloat16")
    a = tsteps.init_params(ts, seed=3, device="cpu")
    b = tsteps.init_params(ts, seed=3, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert a["embed"]["table"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsteps.init_params(ts)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="item 12"):
        tregistry.get("mamba2-780m", reduced=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        tblocks.block_init(torch.Generator(), tcommon.ssm_layer(64, 16))
    with pytest.raises(NotImplementedError, match="item 12"):
        tcommon.moe_layer(64, 4, 2, 128, 4, 2)
    assert tregistry.list_archs() == ["gemma2-9b", "tinyllama-1.1b"]


def test_serve_example_runs_on_cpu():
    """``examples/torch_serve_decode.py`` end to end at reduced size."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples",
                                      "torch_serve_decode.py"),
         "--device", "cpu", "--arch", "gemma2-9b", "--prompt-len", "8",
         "--new-tokens", "4"], capture_output=True, text=True, env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "decoded 4 tokens x 4 seqs" in out.stdout

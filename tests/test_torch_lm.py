"""The port's LM serving path (``repro_torch.models``, ``configs``,
``launch.steps``) against the reference (``repro.models.lm``) on the
reduced configs of the registry's eight decoder-only architectures:
gemma2-9b (local/global attention, softcaps, post-norms, GELU, tied
embeddings scaled by sqrt(d)), tinyllama (GQA 4:1, SwiGLU, untied),
yi-34b and qwen1.5-32b (QKV bias, MHA), mamba2-780m (SSM blocks),
zamba2-1.2b (SSM blocks and a shared attention block applied once per
repeat), granite-moe and dbrx (MoE, the gather dispatch over 16 token
groups), with the reference's ``init_lm`` parameters carried across.
Every full config equals the reference's, field for field.

Tolerances (|err| <= tol + tol·|reference|): float32, every config dtype
replaced, 1e-4 on hidden states, logits, caches and the MoE aux terms
(two layers of matmuls, norms, softmaxes and SSM scans over the same f32
math). bfloat16 (the configs as shipped) 5e-2 times max(1, largest
magnitude): each side rounds activations to bf16 at the same points, and
a rounding flip of 2^-8 early in the stack propagates through both
layers and the unembedding. ``convert`` carries bf16 leaves bit for bit.
The MoE architectures in bfloat16 are held row by row (a row: one token's
hidden state, logits or cache entry): a token whose router margin (the
gap between its k-th and (k+1)-th probability) fell under NEAR_TIE = 5e-3
in some layer may take another expert on the other side, since top-k is
discontinuous and a bf16 rounding flip upstream moves the probabilities
a little. Those rows are left out, at most a fifth of them; every other
row meets 5e-2 scaled. In float32 the MoE architectures meet 1e-4 on
every row.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import (assert_close_scaled, plain, replace_model_dtype,
                           to_np, to_torch)
from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import registry as tregistry
from repro_torch.launch import steps as tsteps
from repro_torch.models import api as tapi
from repro_torch.models import lm as tlm
from repro_torch.nn import moe as tmoe
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("gemma2-9b", "tinyllama-1.1b", "yi-34b", "qwen1.5-32b",
         "mamba2-780m", "zamba2-1.2b", "granite-moe-1b-a400m", "dbrx-132b")
MOE_ARCHS = ("granite-moe-1b-a400m", "dbrx-132b")
F32_TOL, BF16_TOL = 1e-4, 5e-2
# both pass gemma2's reduced window of 32 and the SSM conv window of 3;
# T_PROMPT is a multiple of the reduced SSM chunk of 16
T_PROMPT, N_DECODE = 48, 40
NEAR_TIE = 5e-3


def replace_dtype(spec, dt, **kw):
    """``spec`` with every config dtype set to ``dt`` (None keeps them)
    and the model config's fields ``kw`` replaced."""
    cfg = spec.cfg
    if dt is not None:
        cfg = replace_model_dtype(cfg, dt)
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


@pytest.fixture
def margins(monkeypatch):
    """The port's router margins, one (tokens,) tensor per ``moe_layer``
    call: each token's gap between its k-th and (k+1)-th probability."""
    calls = []
    layer = tmoe.moe_layer

    def recording(p, x, cfg):
        probs, _ = tmoe.router_probs(p, x, cfg)
        top = torch.sort(probs, dim=-1, descending=True).values
        calls.append((top[..., cfg.top_k - 1] - top[..., cfg.top_k])
                     .reshape(-1))
        return layer(p, x, cfg)

    monkeypatch.setattr(tmoe, "moe_layer", recording)
    return calls


def near_ties(calls, arch, dtype):
    """Tokens (bool (tokens,)) with a near-tie route in any of ``calls``;
    None where every row is held (float32, or no MoE layer)."""
    if dtype == "float32" or arch not in MOE_ARCHS:
        return None
    return (torch.stack(calls).min(0).values < NEAR_TIE).numpy()


def assert_rows_close(got, want, dtype, tied=None):
    """``assert_dtype_close`` over the rows (last axis) not ``tied``; at
    most a fifth of the rows may be left out."""
    if tied is None:
        return assert_dtype_close(got, want, dtype)
    got = np.asarray(got, np.float64)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    keep = ~tied.reshape(-1)
    assert keep.mean() >= 0.8, f"{int((~keep).sum())} near-tie rows"
    assert_dtype_close(got.reshape(keep.size, -1)[keep],
                       want.reshape(keep.size, -1)[keep], dtype)


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
    assert plain(ts) == plain(js)
    assert ts.cfg.repeats == js.cfg.repeats
    # the port's own init: same tree, shapes and dtypes, leaf for leaf
    jp = jax.eval_shape(lambda k: jlm.init_lm(k, js.cfg),
                        jax.random.PRNGKey(0))
    tp = tapi.init(torch.Generator().manual_seed(0), ts)
    assert jax.tree.structure(jp) == jax.tree.structure(
        jax.tree.map(lambda x: 0, to_np(tp)))
    jl_, tl_ = jax.tree.leaves(jp), leaves(tp)
    assert len(jl_) == len(tl_)
    for a, b in zip(jl_, tl_):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert tapi.param_count(tp) == sum(x.size for x in jl_)
    assert tapi.active_param_count(tp, ts) == \
        japi.active_param_count(jp, js)


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_reference(arch, dtype, use_flash, margins):
    """Hidden states and the prefill step's last-position logits, with
    ``use_flash`` on both sides (the reference's Pallas kernel in
    interpret mode; the port's kernel op over its plain version)."""
    js, ts = specs(arch, dtype, use_flash)
    jp, tp = params_for(arch, dtype)
    toks = tokens(2, T_PROMPT)
    jx, jaux = jax.jit(lambda p, t: jlm.forward(p, t, js.cfg))(jp, toks)
    tx, taux = tlm.forward(tp, torch.from_numpy(toks), ts.cfg)
    tied = near_ties(margins, arch, dtype)
    assert_rows_close(as_np(tx), jx, dtype, tied)
    for name in ("load_balance", "z_loss"):      # MoE: summed over layers
        assert_dtype_close(as_np(taux[name]), jaux[name], dtype)
        assert (float(taux[name]) > 0) == (arch in MOE_ARCHS)
    want = jax.jit(lambda p, x: jlm.logits_fn(p, x[:, -1:], js.cfg))(jp, jx)
    got = tsteps.make_prefill_step(ts)(tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == (2, 1, js.cfg.vocab)
    assert_rows_close(got.numpy(), want, dtype, tied if tied is None else
                      tied.reshape(2, T_PROMPT)[:, -1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch, dtype, margins):
    """40 serve steps from empty caches: past the reduced window of 32, so
    the local layers' ring buffer wraps, and past the SSM conv window.
    Logits at every step and the final caches (the shared block's too)."""
    js, ts = specs(arch, dtype)
    jp, tp = params_for(arch, dtype)
    toks = tokens(2, N_DECODE, seed=1)
    jcaches = jlm.init_caches(jp, js.cfg, 2, N_DECODE)
    tcaches = tapi.init_caches(tp, ts, 2, N_DECODE)
    jstep = jax.jit(lambda p, t, c, i: jlm.decode_step(p, t, c, i, js.cfg))
    serve = tsteps.make_serve_step(ts)
    tied = []                       # (step, batch) near-tie routes
    for i in range(N_DECODE):
        want, jcaches = jstep(jp, toks[:, i:i + 1], jcaches,
                              jnp.asarray(i, jnp.int32))
        got, tcaches = serve(tp, torch.from_numpy(toks[:, i:i + 1]),
                             tcaches, i)
        tied.append(near_ties(margins[-js.cfg.n_layers:], arch, dtype))
        assert_dtype_close(got.numpy(), want, dtype) if tied[-1] is None \
            else assert_dtype_close(got.numpy()[~tied[-1]],
                                    np.asarray(want)[~tied[-1]], dtype)
    if tied[0] is not None:
        # a cache entry (batch, slot = step) is held unless its token
        # took a near-tie route in some layer
        tied = np.stack(tied).T
        assert tied.mean() <= 0.2, f"{int(tied.sum())} near-tie rows"
    if arch == "gemma2-9b":   # local layer: a 32-slot ring after 40 steps
        pos = tcaches["layers"][0]["pos"]
        assert pos.shape[-1] == 32 and int(pos.max()) == N_DECODE - 1
    assert (tcaches["shared"] is None) == (jcaches["shared"] is None)
    for part in ("layers", "shared"):
        jl_ = jax.tree.leaves(jcaches[part])
        tl_ = leaves(tcaches[part]) if tcaches[part] is not None else []
        assert len(jl_) == len(tl_)
        for a, b in zip(jl_, tl_):
            assert tuple(a.shape) == tuple(b.shape)
            a, b = np.asarray(a.astype(jnp.float32)), as_np(b)
            if tied[0] is None or b.ndim != 5:
                assert_dtype_close(b, a, dtype)
            else:                   # k, v: (repeats, B, slots, Hkv, Dh)
                assert_dtype_close(b[:, ~tied], a[:, ~tied], dtype)


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


def test_registry_lists_every_architecture():
    assert tregistry.list_archs() == jregistry.list_archs()
    assert len(tregistry.list_archs()) == 10
    assert set(ARCHS) == {a for a in tregistry.list_archs()
                          if tregistry.get(a).kind == "lm"}


@pytest.mark.parametrize("arch", jregistry.list_archs())
def test_full_config_matches_reference(arch):
    """The shipped (full) config, field for field: no weights built."""
    assert plain(tregistry.get(arch)) == plain(jregistry.get(arch))


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

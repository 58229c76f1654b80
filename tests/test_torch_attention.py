"""``repro_torch.nn.attention`` and the flash-attention op's CPU path
against the reference (``repro.nn.attention``,
``repro.kernels.flash_attention``): the same numpy inputs through both.

Tolerances (|err| <= tol + tol·|reference|): float32 1e-5 for RoPE,
attend, attend_chunked and decode (one softmax, same f32 math; RoPE's
angles stay below 64 rad so a last-ulp difference in pow/sin/cos stays
below 1e-5); the flash op 2e-5 in float32 and 2e-2 in bfloat16, the
reference's own kernel-against-oracle tolerances
(``tests/test_kernels.py``). Masks bit for bit. The CUDA kernel itself is
held to its plain version on the card by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

import torch

from _torch_parity import to_np, to_torch
from repro.kernels.flash_attention import ops as jfa_ops
from repro.nn import attention as jattn
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.nn import attention as tattn

TOL = 1e-5
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def assert_close(actual, desired, tol):
    actual = np.asarray(actual, np.float64)
    desired = np.asarray(desired, np.float64)
    np.testing.assert_allclose(actual, desired, atol=tol, rtol=tol)


def qkv(seed, b, t, h, hkv, d, dtype="float32", scale=1.0):
    """The same inputs for both sides: numpy f32 -> each framework's
    dtype (bf16 rounding is round-to-nearest-even on both)."""
    rng = np.random.RandomState(seed)
    arrs = [scale * rng.randn(b, t, n, d).astype(np.float32)
            for n in (h, hkv, hkv)]
    jx = [jnp.asarray(a).astype(JDT[dtype]) for a in arrs]
    tx = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return jx, tx


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def test_apply_rope_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 12, 3, 16).astype(np.float32)
    for pos in (np.arange(12), rng.randint(0, 60, (2, 12))):
        want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32),
                                theta=10_000.0)
        got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta=10_000.0)
        assert_close(got.numpy(), want, TOL)


@pytest.mark.parametrize("causal,window,offset,kv_pos", [
    (True, None, 0, None), (True, 5, 0, None), (False, 7, 3, None),
    (True, 4, 9, [8, 9, -1, 6, 7, 5]), (False, None, 2, [0, -1, 1, 2, 3, 4])])
def test_make_mask_bitwise(causal, window, offset, kv_pos):
    kw = dict(causal=causal, sliding_window=window, q_offset=offset)
    jk = None if kv_pos is None else jnp.asarray(kv_pos, jnp.int32)
    tk = None if kv_pos is None else torch.tensor(kv_pos, dtype=torch.int32)
    want = jattn.make_mask(3, 6, kv_positions=jk, **kw)
    got = tattn.make_mask(3, 6, kv_positions=tk, **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 16, 50.0), (False, None, 5.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attend_matches_reference(causal, window, softcap, dtype):
    (jq, jk, jv), (tq, tk, tv) = qkv(1, 2, 40, 4, 2, 16, dtype, scale=2.0)
    kw = dict(causal=causal, sliding_window=window, softcap=softcap)
    want = jattn.attend(jq, jk, jv, **kw)
    got = tattn.attend(tq, tk, tv, **kw)
    assert got.dtype == TDT[dtype]
    assert_close(f32(got), f32(want), FLASH_TOL[dtype] if dtype ==
                 "bfloat16" else TOL)


@pytest.mark.parametrize("window,softcap", [(None, None), (100, 30.0)])
def test_attend_chunked_matches_reference(window, softcap):
    (jq, jk, jv), (tq, tk, tv) = qkv(2, 1, 256, 4, 1, 16, scale=2.0)
    kw = dict(causal=True, sliding_window=window, softcap=softcap,
              block_k=64)
    want = jattn.attend_chunked(jq, jk, jv, **kw)
    got = tattn.attend_chunked(tq, tk, tv, **kw)
    assert_close(got.numpy(), want, TOL)


def test_decode_self_attention_wraps_the_ring_buffer():
    """20 one-token steps through an 8-slot ring (window 8): every output
    and the final cache (keys, values, slot positions) as the
    reference's."""
    cfg_j = jattn.AttentionConfig(d_model=32, num_heads=4, num_kv_heads=2,
                                  head_dim=8, sliding_window=8,
                                  attn_softcap=20.0, dtype=jnp.float32)
    cfg_t = tattn.AttentionConfig(d_model=32, num_heads=4, num_kv_heads=2,
                                  head_dim=8, sliding_window=8,
                                  attn_softcap=20.0, dtype=torch.float32)
    params = jattn.attention_init(jax.random.PRNGKey(3), cfg_j)
    tparams = to_torch(params)
    xs = np.random.RandomState(3).randn(20, 2, 1, 32).astype(np.float32)
    jcache = jattn.init_kv_cache(cfg_j, 2, 8)
    tcache = tattn.init_kv_cache(cfg_t, 2, 8)
    step = jax.jit(lambda p, x, c, i: jattn.decode_self_attention(
        p, x, c, i, cfg_j))
    for i in range(20):
        want, jcache = step(params, jnp.asarray(xs[i]), jcache,
                            jnp.asarray(i, jnp.int32))
        got, tcache = tattn.decode_self_attention(
            tparams, torch.from_numpy(xs[i]), tcache, i, cfg_t)
        assert_close(got.numpy(), want, TOL)
    for name in ("k", "v", "pos"):
        assert_close(to_np(tcache)[name], np.asarray(jcache[name]), TOL)


FLASH_CASES = [
    # the reference's kernel test shapes (tests/test_kernels.py)
    ((1, 128, 4, 4, 64), "float32", dict(causal=True)),            # MHA
    ((2, 256, 8, 2, 64), "float32", dict(causal=True)),            # GQA 4:1
    ((1, 128, 4, 1, 128), "float32", dict(causal=True)),           # MQA
    ((2, 384, 6, 6, 64), "float32", dict(causal=True)),            # T=384
    ((2, 256, 8, 2, 64), "bfloat16", dict(causal=True)),
    ((2, 384, 6, 6, 64), "bfloat16", dict(causal=True)),
    ((1, 256, 4, 4, 64), "float32", dict(causal=True, sliding_window=64)),
    ((1, 256, 4, 4, 64), "float32", dict(causal=True, sliding_window=128)),
    ((1, 128, 2, 2, 64), "float32", dict(causal=True, softcap=50.0)),
    ((2, 128, 4, 4, 64), "float32", dict(causal=False)),
]


@pytest.mark.parametrize("shape,dtype,kw", FLASH_CASES)
def test_flash_op_cpu_path_matches_reference_kernel(shape, dtype, kw):
    """The port's ``ops.flash_attention`` on CPU tensors (the kernel's
    plain version) against the reference's Pallas kernel in interpret
    mode."""
    b, t, h, hkv, d = shape
    scale = 3.0 if "softcap" in kw else 1.0
    (jq, jk, jv), (tq, tk, tv) = qkv(4, b, t, h, hkv, d, dtype, scale)
    want = jfa_ops.flash_attention(jq, jk, jv, interpret=True, **kw)
    before = fa_kernel.LAUNCHES["flash_attention"]
    got = fa_ops.flash_attention(tq, tk, tv, **kw)
    assert fa_kernel.LAUNCHES["flash_attention"] == before  # no launch on CPU
    assert got.dtype == TDT[dtype] and got.shape == tq.shape
    assert_close(f32(got), f32(want), FLASH_TOL[dtype])


def test_flash_kernel_refuses_cpu_tensors():
    q = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kernel.forward(q, q, q)

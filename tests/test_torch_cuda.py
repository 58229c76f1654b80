"""The port's CUDA kernels against their plain torch versions, on the
card. Every test here is marked ``cuda`` and skips on a host without an
NVIDIA GPU. The file imports neither JAX nor the JAX package, so it runs
on a GPU machine without them:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: GRU 1e-5 times max(1, largest magnitude); GAE forward bit
for bit, its gradients 1e-6 likewise.
"""
import pytest
import torch

from repro_torch.kernels.gae import kernel as gae_kernel
from repro_torch.kernels.gae import ref as gae_ref
from repro_torch.kernels.gru import kernel as gru_kernel
from repro_torch.kernels.gru import ref as gru_ref

GRU_TOL, GAE_TOL = 1e-5, 1e-6


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test on a host without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels run only "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def assert_close_scaled(actual, desired, tol):
    actual, desired = actual.detach().double(), desired.detach().double()
    err = float((actual - desired).abs().max())
    scale = max(1.0, float(desired.abs().max()))
    assert err <= tol * scale, f"max abs err {err:.3e} > {tol} * {scale:.3g}"


@pytest.mark.cuda
@pytest.mark.parametrize("a,t,b,h", [(3, 17, 5, 16), (2, 9, 21, 64),
                                     (4, 1, 16, 64), (100, 128, 7, 64)])
def test_gru_kernels_match_plain(cuda_device, a, t, b, h):
    """Forward and backward, with resets, over one and several batch
    tiles (b=21 at h=64 spans three) and at the AIP training shape."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)
    ins = [rnd(a, t, b, 3 * h), rnd(a, h, 3 * h) / h ** 0.5,
           0.1 * rnd(a, 3 * h), rnd(a, b, h)]
    resets = (torch.rand(a, t, b, generator=gen, device=cuda_device)
              < 0.2).float()
    g = rnd(a, t, b, h)
    k_leaves = [x.clone().requires_grad_() for x in ins]
    p_leaves = [x.clone().requires_grad_() for x in ins]
    hs_k = gru_kernel.GRUScan.apply(*k_leaves, resets)
    hs_p = gru_ref.gru_scan(*p_leaves, resets)
    assert_close_scaled(hs_k, hs_p, GRU_TOL)
    for gk, gp in zip(torch.autograd.grad(hs_k, k_leaves, g),
                      torch.autograd.grad(hs_p, p_leaves, g)):
        assert_close_scaled(gk, gp, GRU_TOL)


@pytest.mark.cuda
def test_gru_backward_is_deterministic(cuda_device):
    """dW_h is reduced over batch tiles in a fixed order: two runs give
    the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    a, t, b, h = 4, 12, 40, 64
    rnd = lambda *s: torch.randn(*s, generator=gen, device=cuda_device)
    ins = (rnd(a, t, b, 3 * h), rnd(a, h, 3 * h) / 8, rnd(a, 3 * h),
           rnd(a, b, h), torch.zeros(a, t, b, device=cuda_device))
    hs = gru_kernel.forward(*ins)
    g = rnd(a, t, b, h)
    first = gru_kernel.backward(*ins, hs, g)
    second = gru_kernel.backward(*ins, hs, g)
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_gae_kernels_match_plain_bitwise(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    r, v, nv, g = (torch.randn(16, 1600, generator=gen, device=cuda_device)
                   for _ in range(4))
    d = (torch.rand(16, 1600, generator=gen, device=cuda_device)
         < 0.1).float()
    k_leaves = [x.clone().requires_grad_() for x in (r, v, nv)]
    p_leaves = [x.clone().requires_grad_() for x in (r, v, nv)]
    adv_k = gae_kernel.GAEScan.apply(*k_leaves, d, 0.99, 0.95)
    adv_p = gae_ref.gae_reverse_scan(*p_leaves, d, gamma=0.99, lam=0.95)
    assert torch.equal(adv_k, adv_p)
    for gk, gp in zip(torch.autograd.grad(adv_k, k_leaves, g),
                      torch.autograd.grad(adv_p, p_leaves, g)):
        assert_close_scaled(gk, gp, GAE_TOL)


@pytest.mark.cuda
def test_kernel_wrappers_refuse_bad_inputs(cuda_device):
    gi = torch.zeros(1, 2, 3, 24, device=cuda_device)
    wh, bh = torch.zeros(1, 8, 24, device=cuda_device), \
        torch.zeros(1, 24, device=cuda_device)
    h0, resets = torch.zeros(1, 3, 8, device=cuda_device), \
        torch.zeros(1, 2, 3, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        gru_kernel.forward(gi.double(), wh, bh, h0, resets)
    with pytest.raises(ValueError, match="contiguous"):
        gru_kernel.forward(gi.transpose(1, 2).contiguous().transpose(1, 2),
                           wh, bh, h0, resets)
    with pytest.raises(ValueError, match="shape"):
        gru_kernel.forward(gi, wh, bh, h0[:, :2], resets)
    r = torch.zeros(4, 5, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        gae_kernel.forward(r, r, r, r[:3], 0.9, 0.9)

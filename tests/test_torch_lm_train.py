"""LM training on the port, the losses (``repro_torch.models.{lm,api}``
``lm_loss``/``token_xent``/``loss_fn``) against
``jax.value_and_grad(repro.models.api.loss_fn(spec))`` on the reduced
configs of the registry's dense decoder-only architectures (gemma2-9b:
softcaps, local/global attention, tied embeddings scaled by sqrt(d);
tinyllama: GQA; yi; qwen1.5: QKV bias), the reference's ``api.init``
weights and ``repro.data.synthetic`` batch carried across.

Tolerances (``_torch_parity.check_loss_and_grads``): float32, every config
dtype replaced, 1e-4 on the loss and metrics (relative) and on every
gradient leaf (of the leaf's largest magnitude); the builder saw at most
3e-6. bfloat16 (the shipped configs) 2e-3 relative on the loss and
metrics (seen: at most 2.4e-4), each side rounding activations to bf16
at the same points.

The other six architectures are in ``test_torch_lm_train_mixers.py`` (a
file of its own, so that ``--dist loadfile`` spreads the JAX compiles).
"""
import pytest

from _torch_parity import check_loss_and_grads

ARCHS = ("gemma2-9b", "tinyllama-1.1b", "yi-34b", "qwen1.5-32b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    check_loss_and_grads(arch, dtype)

"""LM training on the port: the losses against
``jax.value_and_grad(repro.models.api.loss_fn(spec))`` on the reduced
configs of the registry's architectures with other mixers and heads:
mamba2-780m (SSM blocks, the plain chunked scan under autograd),
zamba2-1.2b (SSM blocks and the shared attention block, its gradient
summed over every repeat), granite-moe and dbrx (MoE: the routing, the
scatter/gather dispatch and the load-balance and z-loss terms weighed
into the loss), whisper-tiny (``encdec_loss``: the encoder over stub
frames, the decoder's cross-attention) and llama-3.2-vision
(``vlm_loss``: tanh-gated cross-attention over stub patches, the gates
set to 0.5 on both sides so the path carries gradient).

Tolerances as in ``test_torch_lm_train.py``: float32 1e-4 on the loss,
metrics and every gradient leaf; bfloat16 2e-3 relative on the loss and
metrics.
"""
import pytest

pytest.importorskip("torch")

from _torch_parity import check_loss_and_grads

ARCHS = ("mamba2-780m", "zamba2-1.2b", "granite-moe-1b-a400m", "dbrx-132b",
         "whisper-tiny", "llama-3.2-vision-90b")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype):
    check_loss_and_grads(arch, dtype)

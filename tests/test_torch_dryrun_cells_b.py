"""Reduced cells through the port's dry-run on a fake 256-rank group
(``tests/_torch_dryrun_cells.py``), the second half of the registry
(the other: ``tests/test_torch_dryrun_cells_a.py``): every
architecture's train cell, and the decode cell (the prefill cell where
there is no decode step) of those that stand for a family."""
import pytest

from repro_torch.configs import registry

from _torch_dryrun_cells import check_cells

# the serving cells of one architecture a family (dense, local/global
# attention, MoE, SSM, hybrid, enc-dec, VLM): the others differ in sizes
SERVE = ("tinyllama-1.1b", "gemma2-9b", "granite-moe-1b-a400m",
         "mamba2-780m", "zamba2-1.2b", "whisper-tiny",
         "llama-3.2-vision-90b")
ARCHS = sorted(registry.ARCHS)[1::2]


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_reduced_cells_run_on_the_fake_mesh(kind):
    if kind == "train":
        check_cells([(a, "train_4k") for a in ARCHS])
    else:
        check_cells([(a, "decode_32k" if registry.get(a).has_decode
                      else "prefill_32k") for a in ARCHS if a in SERVE])

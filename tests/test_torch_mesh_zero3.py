"""The ZeRO-3 train variants of ``launch.variants`` (batch over every
mesh axis, no tensor parallelism; with the dots remat; with 8
microbatches of the same global rows as on one device) on four gloo
ranks of the CPU as a (data=2, model=2) mesh, within 1e-5 of the
single-device port: loss, grad norm and every updated param (the other
variants and the serving steps: ``tests/test_torch_mesh_numerics.py``).
"""
import pytest

import _torch_mesh_jobs as jobs
from test_torch_mesh_numerics import check_train_variants


@pytest.mark.timeout(60)
def test_zero3_train_variants_on_the_mesh_match_one_device():
    check_train_variants(jobs.ZERO3_VARIANTS)

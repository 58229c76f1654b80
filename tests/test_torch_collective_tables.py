"""The sharded runtime's c10d tables (``repro_torch.distributed.runtime``)
against a torch whose functional collectives are imported: that import
(``torch.testing.assert_close`` makes it) registers
``_c10d_functional._wrap_tensor_autograd``, which communicates nothing
and must be classified, or ``validate_collective_tables`` fails in any
test process that imported it first. Imports no JAX."""
import importlib

import pytest

pytest.importorskip("torch")

from repro_torch.distributed import runtime


def test_tables_cover_the_functional_collectives():
    importlib.import_module("torch.distributed._functional_collectives")
    runtime.validate_collective_tables()
    assert "_c10d_functional._wrap_tensor_autograd" in \
        runtime.NON_COMMUNICATING
    assert "_c10d_functional._wrap_tensor_autograd" not in \
        runtime.live_collective_prims()


def test_tables_cover_dtensor_and_the_fake_group():
    """The LM mesh imports DTensor and the dry-run PyTorch's fake process
    group; neither registers a c10d op the tables do not classify."""
    importlib.import_module("torch.distributed.tensor")
    importlib.import_module("torch.distributed.tensor.experimental")
    importlib.import_module(
        "torch.testing._internal.distributed.fake_pg")
    runtime.validate_collective_tables()

"""The LM mesh's numbers on a real mesh: four gloo ranks on the CPU as a
(data=2, model=2) DeviceMesh (``tests/_torch_mesh_jobs.py``), reduced
tinyllama in float32, each within 1e-5 (relative to max(1, |value|)) of
the single-device port on the same weights and inputs:

* a train step with each train variant's rules (the baseline, no
  sequence parallelism, no FSDP, pod-local FSDP; ZeRO-3 with its dots
  remat and 8 microbatches in ``tests/test_torch_mesh_zero3.py``): loss,
  grad norm and every updated param;
* the prefill's last logits; four decode steps with the distributed
  softmax (the cache sequence split over ``model``) and without;
* ``shard_batch``'s layout and values, ``reshard`` from (2, 2) to (4, 1)
  and back with every value equal, and a dim split model-major holding
  the block a JAX mesh gives it.

Each test is one group of four spawned ranks (no group outlives it)."""
import pytest

pytest.importorskip("torch")

from repro_torch.distributed import bootstrap

import _torch_mesh_jobs as jobs

TOL = 1e-5


def check_train_variants(names):
    """One spawn of four ranks: each named variant's step within TOL of
    one device on every rank."""
    ranks = bootstrap.spawn_local(4, jobs.train_variants, names,
                                  timeout_s=120)
    for r, out in enumerate(ranks):
        assert set(out) == set(names)
        for name, (err, _) in out.items():
            assert err <= TOL, (r, name, err)


@pytest.mark.timeout(60)
def test_tp_train_variants_on_the_mesh_match_one_device():
    """The baseline (TRAIN_RULES, FSDP over data, sequence parallel), no
    sequence parallelism, no FSDP and pod-local FSDP (the ZeRO-3
    variants: ``tests/test_torch_mesh_zero3.py``)."""
    check_train_variants(jobs.TP_VARIANTS)


@pytest.mark.timeout(60)
def test_prefill_decode_and_placement_on_the_mesh():
    ranks = bootstrap.spawn_local(4, jobs.serve, timeout_s=120)
    for r, out in enumerate(ranks):
        for name in ("prefill", "decode_sharded", "decode_gathered"):
            assert out[name] <= TOL, (r, name, out[name])
        # the decode rules split the cache's sequence over model
        assert out["decode_sharded_cache_split"] == \
            "(Shard(dim=1), Shard(dim=2))", out
        assert out["shard_batch"] and out["reshard"] and out["strided"], \
            (r, out)

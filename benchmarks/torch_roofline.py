"""Roofline arithmetic for the H100 — the port of ``benchmarks/roofline.py``
with the card's constants.

The three terms (seconds) for one step on an N-rank mesh:

  compute_s    = FLOPs / (ranks * PEAK_FLOPS)
  memory_s     = bytes / (ranks * HBM_BW)
  collective_s = collective_bytes / (ranks * NVLINK_BW)

FLOPs, bytes and collective bytes come from the port's dry-run records
(``python -m repro_torch.launch.dryrun``, ``experiments/dryrun_torch``),
which hold one rank's numbers: pass them with ``n_devices=1``
(:func:`per_device`).

Constants: NVIDIA H100 SXM5 80GB HBM3, 700 W datasheet (dense rates,
no sparsity) — the figures ``PERF.md`` uses for every kernel bound.
"""
from __future__ import annotations

# NVIDIA H100 SXM5 80GB HBM3, 700 W datasheet
PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (tensor cores, dense)
PEAK_FLOPS_FP32 = 67e12      # fp32 FLOP/s per card (outside the tensor cores)
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, one direction


def terms(*, flops: float, bytes_accessed: float, collective_bytes: float,
          n_devices: int, peak_flops: float = PEAK_FLOPS) -> dict:
    """``peak_flops`` defaults to the bf16 peak; pass ``PEAK_FLOPS_FP32``
    when the FLOP count describes an fp32 program."""
    compute_s = flops / (n_devices * peak_flops)
    memory_s = bytes_accessed / (n_devices * HBM_BW)
    collective_s = collective_bytes / (n_devices * NVLINK_BW)
    bottleneck = max(
        (("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)), key=lambda kv: kv[1])[0]
    step_s = max(compute_s, memory_s, collective_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "bottleneck": bottleneck,
        "step_s": step_s,
        # the share of the step's bound the compute term takes: 1.0 is a
        # step bound by the tensor cores alone
        "roofline_fraction": compute_s / step_s if step_s > 0 else 0.0,
    }


def model_flops(n_params_active: float, tokens: float) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) for a train step;
    2·N·D for inference-only steps (pass the matching factor)."""
    return 6.0 * n_params_active * tokens


def per_device(rec: dict) -> dict:
    """One rank's roofline inputs from a dry-run record (its numbers are
    already one rank's: ``n_devices=1``)."""
    return {
        "flops": rec["cost"]["flops"],
        "bytes_accessed": rec["cost"]["bytes_accessed"],
        "collective_bytes": rec["collectives"]["total_bytes"],
        "n_devices": 1,
    }

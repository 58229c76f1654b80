"""Where one LM train step of the PyTorch/CUDA port spends its time on a
GPU: ``chip_smoke.py``'s training cell (tinyllama-1.1b at full width and
depth, bf16, ``remat="full"``, B=8 x T=4096 in 4 microbatches, batches
from ``data/pipeline.lm_iterator`` on the card).

Prints one JSON object:

* ``step_s``: host seconds of whole ``make_train_step`` calls (after an
  untimed one), ``tok_s``, peak device memory;
* ``batch_draw_ms``: one batch of the synthetic stream (Threefry and the
  Gumbel argmax over B x (T+1) x 32,000 draws), CUDA events;
* ``adamw_ms``: ``sanitize`` + the global-norm clip + AdamW + the cast
  back, on fp32 gradients of every leaf, CUDA events;
* ``microbatch``: one microbatch's ``make_value_and_grad`` (forward,
  per-repeat recompute, backward) traced under ``torch.profiler`` after a
  warm-up: host seconds, the device busy share (the union of kernel
  intervals over the host wall time), device ms by kernel class (bf16
  matmuls: the projections, the MLP and the unembedding; fp32 matmuls:
  the plain attention's score and value products, which run in fp32
  without TF32; everything else: elementwise, softmax, reductions,
  copies) and the top kernels by device time.

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 benchmarks/torch_train_profile.py [--steps 2]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def kernel_class(name: str) -> str:
    """cuBLAS's fp32 products (no TF32) run SIMT kernels named
    ``..._f32f32_f32f32_..._ffma_...`` or ``sgemm``; its bf16 products on
    sm_90 run ``nvjet`` (or ``xmma``/``cutlass``) kernels."""
    low = name.lower()
    if "f32f32_f32f32" in low or "sgemm" in low:
        return "fp32_matmul"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "nvjet")):
        return "bf16_matmul"
    return "other"


def events_ms(fn, iters: int = 20) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import registry
    from repro_torch.data import pipeline
    from repro_torch.kernels import dispatch
    from repro_torch.launch import steps
    from repro_torch.models import api
    from repro_torch.optim import adamw, clip, schedule
    from repro_torch.tree import tree_map

    device = dispatch.resolve_device("cuda")
    spec = registry.get(args.arch)
    cfg = steps.model_cfg(spec)
    b, t, m = args.batch, args.seq, args.microbatches
    out = {"arch": args.arch, "batch": b, "seq": t, "microbatches": m,
           "card": torch.cuda.get_device_name(0)}
    it = pipeline.lm_iterator(0, b, t, cfg.vocab, device=device)
    out["batch_draw_ms"] = events_ms(lambda: next(it), iters=3)

    params = steps.init_params(spec, seed=0, device=device)
    opt = adamw.init(params, per_agent=False)
    step = steps.make_train_step(spec, microbatches=m)
    torch.cuda.reset_peak_memory_stats()
    batches = [next(it) for _ in range(args.steps + 1)]
    times = []
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    out["first_step_s"], out["step_s"] = times[0], times[1:]
    out["tok_s"] = b * t * len(times[1:]) / sum(times[1:])
    out["peak_bytes"] = torch.cuda.max_memory_allocated()

    grads = tree_map(lambda p: torch.randn(p.shape, dtype=torch.float32,
                                           device=device) * 1e-3, params)
    lr_fn = schedule.warmup_cosine(3e-4, 2_000, 100_000)

    def update():
        g, _ = clip.clip_by_global_norm(clip.sanitize(grads), 1.0,
                                        per_agent=False)
        master, _ = adamw.update(g, opt, lr_fn(opt["step"]))
        adamw.cast_like(master, params)

    out["adamw_ms"] = events_ms(update, iters=3)
    del grads

    vg = steps.make_value_and_grad(api.loss_fn(spec))
    mb = tree_map(lambda x: x[:b // m], batches[0])
    vg(params, mb)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vg(params, mb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, reach, by_class, by_name = 0.0, float("-inf"), {}, {}
    for start, end, name in spans:
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
        ms = (end - start) / 1e3
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + ms, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    out["microbatch"] = {
        "host_s": wall, "kernels": len(spans),
        "device_ms": sum(by_class.values()),
        "busy_share": busy_us / 1e6 / wall, "ms_by_class": by_class,
        "top_kernels": [(name[:90], ms, n) for name, (ms, n) in top]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()

"""Production training driver — the port of ``repro/launch/train.py``.

Builds the architecture's train step and runs it over the synthetic data
pipeline with gradient clipping, the warmup-cosine schedule,
checkpoint/restart and the DIALS-outer reconciliation every
``--sync-every`` steps (one pod). As the reference does, it builds the
host mesh (``launch.mesh.make_host_mesh``: data=1, model=1) and the
params' shardings on it, prints the mesh, and runs the step on the one
device. Runs on the card unless ``--device cpu``.

Restart: with ``--ckpt`` every reconciliation saves ``{"params", "opt"}``
and, since the outer state and the compression error carry across syncs,
``"outer"`` and ``"err"``; a restart restores the newest valid step and
reads the data stream from that step on (each batch depends only on (seed,
step)), so a stopped and resumed run ends where an uninterrupted one does.
``--stop-after N`` ends the run after N steps of this invocation, as a
preempted job would (the schedule still spans ``--steps``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 100 --reduced --batch 4 --seq 128 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.distributed import bootstrap
from repro_torch.distributed import mesh as mesh_lib
from repro_torch.launch import mesh as prod_mesh
from repro_torch.launch import steps
from repro_torch.models import api
from repro_torch.optim import adamw, clip, compress, outer, schedule
from repro_torch.tree import leaves


def build(spec, *, peak_lr, total_steps, warmup):
    """``train_step(params, opt, batch, step) -> (params, opt, loss,
    gnorm)``: one monolithic step at ``warmup_cosine(peak_lr, warmup,
    total_steps)(step)``."""
    loss_fn = api.loss_fn(spec)
    lr_fn = schedule.warmup_cosine(peak_lr, warmup=warmup, total=total_steps)
    value_and_grad = steps.make_value_and_grad(loss_fn)

    def train_step(params, opt, batch, step):
        (loss, _), grads = value_and_grad(params, batch)
        grads, gnorm = clip.clip_by_global_norm(clip.sanitize(grads), 1.0,
                                                per_agent=False)
        master, opt = adamw.update(grads, opt, lr_fn(step))
        return adamw.cast_like(master, params), opt, loss, gnorm

    return train_step


def extras(spec, batch: int, device):
    """The stub frontend's zero inputs of an encdec or vlm batch."""
    if spec.kind == "encdec":
        return {"frames": torch.zeros((batch, spec.n_frames,
                                       spec.cfg.d_model),
                                      dtype=torch.bfloat16, device=device)}
    if spec.kind == "vlm":
        return {"patches": torch.zeros((batch, spec.n_patches,
                                        spec.vision_dim),
                                       dtype=torch.bfloat16, device=device)}
    return {}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--sync-every", type=int, default=0,
                    help=">0 enables DIALS-outer reconciliation")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--stop-after", type=int, default=0,
                    help=">0 ends this run after that many steps")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec = registry.get(args.arch, reduced=args.reduced)
    cfg = steps.model_cfg(spec)
    params = steps.init_params(spec, seed=0, device=args.device)
    device = leaves(params)[0].device
    n_params = api.param_count(params)
    try:
        mesh = prod_mesh.make_host_mesh(device_type=device.type)
        steps.param_shardings(spec, mesh)
        shape = dict(mesh_lib.mesh_shape(mesh))
    finally:
        bootstrap.release_solo_group()
    print(f"{args.arch}{' (reduced)' if args.reduced else ''}: "
          f"{n_params/1e6:.2f}M params on {device}, mesh {shape}",
          flush=True)
    opt = adamw.init(params, per_agent=False)
    out_state = outer.init(params) if args.sync_every else None
    err = None
    train_step = build(spec, peak_lr=args.lr, total_steps=args.steps,
                       warmup=args.steps // 10)

    mgr = CheckpointManager(args.ckpt, keep=2) if args.ckpt else None
    start = 0
    if mgr:
        tree = {"params": params, "opt": opt}
        if args.sync_every:
            tree.update(outer=out_state, err=compress.init_error(params))
        restored, start = mgr.restore_latest(tree)
        if restored is not None:
            params, opt = restored["params"], restored["opt"]
            if args.sync_every:
                out_state, err = restored["outer"], restored["err"]
            print(f"resumed from step {start}", flush=True)
        start = max(0, start)

    it = pipeline.lm_iterator(seed=0, batch=args.batch, seq=args.seq,
                              vocab=cfg.vocab, start_step=start,
                              device=device)
    end = args.steps if args.stop_after <= 0 \
        else min(args.steps, start + args.stop_after)
    t0 = time.time()
    for step in range(start, end):
        batch = {**next(it), **extras(spec, args.batch, device)}
        params, opt, loss, gnorm = train_step(
            params, opt, batch, torch.tensor(step, device=device))
        if args.sync_every and (step + 1) % args.sync_every == 0:
            params, out_state, err = outer.outer_step(
                params, out_state,
                outer.OuterConfig(sync_every=args.sync_every), err_tree=err)
            if mgr:
                mgr.save(step + 1, {"params": params, "opt": opt,
                                    "outer": out_state, "err": err})
        if step % args.log_every == 0 or step == args.steps - 1:
            tok_s = args.batch * args.seq * (step - start + 1) \
                / max(time.time() - t0, 1e-9)
            print(f"step {step:5d}  loss {float(loss):.4f}  "
                  f"gnorm {float(gnorm):.2f}  {tok_s:,.0f} tok/s", flush=True)
    if mgr:
        mgr.wait()
    return params, opt


if __name__ == "__main__":
    main()

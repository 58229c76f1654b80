"""End-to-end LM pretraining with the DIALS-outer optimizer on the
PyTorch port — the port of ``examples/train_lm_outer.py``: the paper's
pattern (local regions + periodic compact reconciliation) applied to the
training layer.

Trains a reduced tinyllama-family model on the synthetic zipf stream with
  * AdamW inner steps (the "local region" work),
  * every F steps a DIALS-outer reconciliation (int8-compressed delta
    + Nesterov outer step; one pod here, so no collective),
  * gradient clipping, the warmup-cosine schedule, checkpoint/restart of
    ``{"params", "opt", "outer"}`` (the reference's tree, so a checkpoint
    of either package restores in the other).

Runs on the card unless ``--device cpu``:
  PYTHONPATH=src python examples/torch_train_lm_outer.py --device cpu \\
      [--steps 200]
"""
import argparse
import math
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import registry
from repro_torch.data import pipeline
from repro_torch.launch import steps, train
from repro_torch.models import api
from repro_torch.optim import adamw, outer
from repro_torch.tree import leaves


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--sync-every", type=int, default=25)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    spec = registry.get(args.arch, reduced=True)
    cfg = steps.model_cfg(spec)
    params = steps.init_params(spec, seed=0, device=args.device)
    device = leaves(params)[0].device
    print(f"{args.arch} (reduced): {api.param_count(params)/1e6:.2f}M "
          f"params on {device}")

    opt = adamw.init(params, per_agent=False)
    out_state = outer.init(params)
    err = None
    # value_and_grad -> sanitize -> clip -> AdamW at warmup_cosine(step)
    train_step = train.build(spec, peak_lr=3e-3, total_steps=args.steps,
                             warmup=20)
    mgr = CheckpointManager(args.ckpt, keep=2)

    # restart support: resume from the newest valid checkpoint
    restored, start = mgr.restore_latest(
        {"params": params, "opt": opt, "outer": out_state})
    if restored is not None:
        params, opt, out_state = (restored["params"], restored["opt"],
                                  restored["outer"])
        print(f"resumed from step {start}")
    start = max(0, start)
    it = pipeline.lm_iterator(seed=0, batch=args.batch, seq=args.seq,
                              vocab=cfg.vocab, start_step=start,
                              device=device)

    t0 = time.time()
    for step in range(start, args.steps):
        params, opt, loss, gnorm = train_step(
            params, opt, next(it), torch.tensor(step, device=device))
        if (step + 1) % args.sync_every == 0:
            # DIALS-outer reconciliation (one pod: the compression and
            # outer math run; across pods this is the only collective)
            params, out_state, err = outer.outer_step(
                params, out_state, outer.OuterConfig(
                    sync_every=args.sync_every), err_tree=err)
            mgr.save(step + 1, {"params": params, "opt": opt,
                                "outer": out_state})
        if step % 20 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {float(loss):.4f}  "
                  f"gnorm {float(gnorm):.2f}  "
                  f"({(time.time()-t0):.0f}s)")
    mgr.wait()
    print("done — final loss should be well below ln(vocab) =",
          f"{math.log(float(cfg.vocab)):.2f}")


if __name__ == "__main__":
    main()

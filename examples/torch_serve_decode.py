"""Batched serving with the PyTorch/CUDA port: decode a prompt batch
token by token into the position-tracking KV cache, then decode new
tokens greedily — the counterpart of ``examples/serve_decode.py``.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py \\
          [--arch tinyllama-1.1b] [--device cuda|cpu] [--full]

``--full`` builds the architecture at its published widths instead of
the reduced config; ``--device`` defaults to ``cuda`` and raises without
a card.
"""
import argparse
import time

import torch

from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.models import api


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    choices=registry.list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true",
                    help="published widths instead of the reduced config")
    args = ap.parse_args()

    spec = registry.get(args.arch, reduced=not args.full)
    cfg = spec.cfg
    params = steps.init_params(spec, seed=0, device=args.device)
    device = params["embed"]["table"].device
    max_len = args.prompt_len + args.new_tokens
    caches = api.init_caches(params, spec, args.batch, max_len)
    decode = steps.make_serve_step(spec)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    # "prefill" by decoding the prompt token by token, as the reference
    # example does (the prefill step itself does not fill the cache)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=torch.Generator().manual_seed(1))
    prompt = prompt.to(device)
    t0 = time.time()
    logits = None
    for i in range(args.prompt_len):
        logits, caches = decode(params, prompt[:, i:i + 1], caches, i)
    sync()
    print(f"prefilled {args.prompt_len} positions in {time.time()-t0:.1f}s")

    # greedy decode
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [tok]
    t0 = time.time()
    for i in range(args.prompt_len, max_len - 1):
        logits, caches = decode(params, tok, caches, i)
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
    sync()
    dt = time.time() - t0
    seqs = torch.cat(out, dim=1)
    print(f"decoded {seqs.shape[1]} tokens x {args.batch} seqs "
          f"in {dt:.1f}s ({args.batch*seqs.shape[1]/max(dt, 1e-9):.0f} tok/s)")
    print("sample ids:", seqs[0, :12].tolist())


if __name__ == "__main__":
    main()

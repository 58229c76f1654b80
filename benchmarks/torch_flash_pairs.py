"""The float32 FFMA flash kernel of two trees, timed in alternating pairs.

Builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` of this
checkout (or of ``--this``) and of ``--other`` (the root of another
checkout, e.g. a ``git archive`` of the parent commit) with ``nvcc``
into two shared libraries, each behind a small C shim, and calls each
one's
``launch_flash_attention`` through ctypes on the same float32 inputs:
16 query heads over 8 KV heads, T=2,048, causal, window 1,024, softcap
50 (``torch_tree_times.py``'s ``flash_fwd`` shape) at head_dim 64, 128
and 256. Each time is the mean of CUDA events around ``--iters``
back-to-back launches; for each head_dim, ``--pairs`` pairs alternate
their order (other, this, then this, other, ...). The two outputs are
compared bit for bit. Run from the root of a checkout on a machine with
one NVIDIA GPU and ``nvcc``:

    python3 benchmarks/torch_flash_pairs.py --other DIR [--pairs 10]
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import os
import re
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join("src", "repro_torch", "kernels", "csrc",
                  "flash_attention.cu")
HEAD_DIMS = (64, 128, 256)
BH, BHKV, T, WINDOW, SOFTCAP = 16, 8, 2048, 1024, 50.0
ARGS = ("int BH, int BHkv, int Tq, int Tk, int D, int causal, int window, "
        "float softcap, float scale")
CALL = "BH, BHkv, Tq, Tk, D, causal, window, softcap, scale"
# the launcher's declaration: with a dtype flag (void pointers) or, in
# trees that took float32 only, without one
SHIMS = {
    True: ("cudaError_t launch_flash_attention(const void*, const void*, "
           "const void*, void*, bool, int, int, int, int, int, int, int, "
           "float, float, cudaStream_t);",
           f"launch_flash_attention(q, k, v, o, false, {CALL}, s)"),
    False: ("cudaError_t launch_flash_attention(const float*, const float*, "
            "const float*, float*, int, int, int, int, int, int, int, float, "
            "float, cudaStream_t);",
            "launch_flash_attention((const float*)q, (const float*)k, "
            f"(const float*)v, (float*)o, {CALL}, s)"),
}


def build(tree: str, out_dir: str) -> str:
    """``tree``'s flash_attention.cu and its shim as one shared library;
    returns its path."""
    from repro_torch.kernels.build import CUDA_FLAGS
    with open(os.path.join(tree, CU)) as f:
        src = f.read()
    sig = re.search(r"launch_flash_attention\(([^)]*)\)", src).group(1)
    decl, call = SHIMS["bool bf16" in sig]
    os.makedirs(out_dir, exist_ok=True)
    shim = os.path.join(out_dir, "shim.cu")
    with open(shim, "w") as f:
        f.write("#include <cuda_runtime.h>\n" + decl + "\n"
                'extern "C" int flash_f32(const void* q, const void* k, '
                f"const void* v, void* o, {ARGS}, void* stream) {{\n"
                "  cudaStream_t s = (cudaStream_t)stream;\n"
                f"  return (int){call};\n}}\n")
    lib = os.path.join(out_dir, "flash.so")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, *CUDA_FLAGS, "-shared", "-Xcompiler", "-fPIC",
                    "-o", lib, shim, os.path.join(tree, CU)], check=True)
    return lib


def load(lib: str):
    fn = ctypes.CDLL(lib).flash_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_float] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--this", default=ROOT,
                    help="root of the checkout to time (default: this one)")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("torch_flash_pairs: CUDA is not available", file=sys.stderr)
        return 2
    trees = {"other": os.path.abspath(args.other),
             "this": os.path.abspath(args.this)}
    out = os.path.join(ROOT, "build", "flash_pairs")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        libs = dict(zip(trees, pool.map(
            lambda kv: build(kv[1], os.path.join(out, kv[0])),
            trees.items())))
    fns = {name: load(lib) for name, lib in libs.items()}
    print(f"card: {chip_smoke.smi_line()}", flush=True)
    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(0)
    for d in HEAD_DIMS:
        q = torch.randn(BH, T, d, generator=gen, device=device)
        k, v = (torch.randn(BHKV, T, d, generator=gen, device=device)
                for _ in range(2))
        outs = {name: torch.empty_like(q) for name in fns}

        def call(name):
            rc = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           outs[name].data_ptr(), BH, BHKV, T, T, d, 1,
                           WINDOW, SOFTCAP, d ** -0.5,
                           torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"{name}: launch failed with {rc}")

        for name in fns:
            call(name)
        torch.cuda.synchronize()
        same = torch.equal(outs["this"], outs["other"])
        times = {name: [] for name in fns}
        for i in range(args.pairs):
            for name in (("other", "this") if i % 2 == 0
                         else ("this", "other")):
                times[name].append(chip_smoke.cuda_ms(lambda: call(name),
                                                      args.iters))
        ratio = [t / o for t, o in zip(times["this"], times["other"])]
        for name, ts in times.items():
            print(f"flash_fwd f32 ({BH}/{BHKV}, {T}, {d}) {name}: "
                  f"{' '.join(f'{t:.4f}' for t in ts)} ms; mean "
                  f"{statistics.mean(ts):.4f}, min {min(ts):.4f}, max "
                  f"{max(ts):.4f}", flush=True)
        print(f"flash_fwd f32 D={d}: this/other per pair "
              f"{' '.join(f'{r:.4f}' for r in ratio)}; mean "
              f"{statistics.mean(ratio):.4f}; outputs bit for bit the same: "
              f"{same}", flush=True)
        del q, k, v, outs
    return 0


if __name__ == "__main__":
    sys.exit(main())

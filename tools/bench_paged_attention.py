#!/usr/bin/env python3
"""Time builds of the paged decode-attention kernel (B4/B5) against each
other on one CUDA card, at chip_smoke.py phase 2's shapes and with its
method (R = 24 rows, H = 16, D = 64, P = 16, N = 1024 pages, Bp in {1,
8, 128}; float32, bf16 and int8 pools; a cold L2 before each call, by
a 128 MB write as chip_smoke.py's `ms` and by a 128 MB read as its
`ms_clean_l2`).

    python3 tools/bench_paged_attention.py [--src a.cu --src b.cu ...]
        [--rounds 2] [--out results.json]

Each --src (default: mxnet_tpu_torch/csrc/paged_attention.cu) is built
with the package's nvcc flags into mxnet_tpu_torch/_build/bench/, bound
through the wrapper's C interface and held to the plain version; then
the sources are timed in turns, forward and back (a, b, b, a for two),
`--rounds` times, so that every source sees the same card. Prints one
line per (row, source): the mean of both timings, and each turn's ms.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build(kernels, srcs):
    """Build the sources with the package's flags, one nvcc each, all
    started together; returns their libraries."""
    jobs = []
    for src in srcs:
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(kernels.NVCC_FLAGS).encode()).hexdigest()
        stem = os.path.splitext(os.path.basename(src))[0]
        jobs.append((stem, src, os.path.join(
            kernels.BUILD_DIR, "bench", f"lib{stem}-{digest[:16]}.so"),
            kernels.NVCC_FLAGS))
    with kernels._lock:
        kernels._compile(jobs)
    return [job[2] for job in jobs]


def profile(torch, fn, flush, label, reps=20):
    """Mean device time per call of each kernel fn launches, after a
    clean flush of L2 before each call."""
    act = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(reps):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if "paged" in e.key and e.self_device_time_total > 0:
            print(f"  profile {label}: {e.key[:60]} "
                  f"{e.self_device_time_total / reps:.2f} us a call "
                  f"(x{e.count})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append",
                    help="a kernel source (repeat to compare several)")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", help="also write the times as JSON here")
    ap.add_argument("--no-check", action="store_true",
                    help="time sources whose results are not checked "
                    "(diagnostic builds that skip part of the work)")
    ap.add_argument("--profile", action="store_true",
                    help="also print each kernel's mean device time per "
                    "call (torch.profiler, the first source, clean L2)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_paged_attention: needs a CUDA card")
    import chip_smoke as cs
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.decoding import attention, quant

    srcs = args.src or [os.path.join(kernels.CSRC_DIR,
                                     "paged_attention.cu")]
    libs, chunks = [], []
    for path in build(kernels, srcs):  # each may split by its own size
        lib = ctypes.CDLL(path)
        attention.CHUNK_PAGES = lib.paged_attention_chunk_pages()
        libs.append(attention.bind_library(lib))
        chunks.append(attention.CHUNK_PAGES)
    order = list(range(len(srcs))) + list(reversed(range(len(srcs))))
    dev = torch.device("cuda")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    smi = cs.subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    results = []
    for kv in ("float32", "bf16", "int8"):
        for bp in (1, 8, 128):
            case = cs._kernel_case(torch, quant, kv, bp, seed=bp, dev=dev)
            ref = attention.paged_attention_plain(*case)
            q, kp, _, table, lengths = case
            bound_ms = cs._bound(q, kp, table, lengths, kp.data.shape[1])[0]
            refs, distinct, ref_bytes = cs._page_refs(kp, table, lengths)
            print(f"{kv:7s} Bp={bp:3d} the rows read {refs} pages "
                  f"({distinct} distinct, {ref_bytes} B)", flush=True)
            times = [[] for _ in srcs]
            clean = [[] for _ in srcs]
            for i, lib in enumerate(libs):
                attention._lib, attention.CHUNK_PAGES = lib, chunks[i]
                err = (attention.paged_attention(*case) - ref).abs().max()
                if not args.no_check and not err.item() <= cs.TOL[kv]:
                    sys.exit(f"{srcs[i]} {kv} Bp={bp}: error {err.item()!r}")
            for _ in range(args.rounds):
                for i in order:
                    attention._lib = libs[i]
                    attention.CHUNK_PAGES = chunks[i]
                    times[i].append(cs._time_ms(
                        torch, lambda: attention.paged_attention(*case),
                        flush))
                    clean[i].append(cs._time_ms(
                        torch, lambda: attention.paged_attention(*case),
                        flush, clean=True))
            for i, src in enumerate(srcs):
                mean = sum(times[i]) / len(times[i])
                mean_clean = sum(clean[i]) / len(clean[i])
                results.append({"kv": kv, "bp": bp, "src": src,
                                "ms": times[i], "mean_ms": mean,
                                "ms_clean_l2": clean[i],
                                "mean_ms_clean_l2": mean_clean,
                                "bound_ms": bound_ms})
                print(f"{kv:7s} Bp={bp:3d} {os.path.basename(src):24s} "
                      f"mean {mean:.5f} ms, clean L2 {mean_clean:.5f} "
                      f"(bound {bound_ms:.5f}) turns "
                      + " ".join(f"{t:.5f}" for t in times[i]), flush=True)
            if args.profile:
                attention._lib, attention.CHUNK_PAGES = libs[0], chunks[0]
                profile(torch, lambda: attention.paged_attention(*case),
                        flush, f"{kv} Bp={bp}")
    attention._lib = None
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time builds of the port's hand-written kernels against each other on
one CUDA card, in turns forward and back (a, b, b, a for two) so that
every build sees the same card, with chip_smoke.py's method (`_time_ms`:
a cold L2 before each call, by a 128 MB write as its `ms` and by a
128 MB read as its `ms_clean_l2`):

    python3 tools/bench_kernels.py paged [--src a.cu --src b.cu ...]
        [--profile]
    python3 tools/bench_kernels.py softmax [--src a.cu[@BLOCK] ...]
    python3 tools/bench_kernels.py nms --inputs FILE [--src a.cu ...]
        [--phases]
    python3 tools/bench_kernels.py host [--root DIR --root DIR ...]
    (each also takes [--rounds 2] [--no-check] [--out results.json])

- paged: builds of the paged decode-attention kernel (B4/B5; default
  mxnet_tpu_torch/csrc/paged_attention.cu), each built with the
  package's nvcc flags into mxnet_tpu_torch/_build/bench/ and bound
  through the wrapper's C interface, at chip_smoke.py phase 2's shapes
  (R = 24 rows, H = 16, D = 64, P = 16, N = 1024 pages, Bp in {1, 8,
  128}; float32, bf16 and int8 pools). `--profile` also prints each
  kernel's device time a call (torch.profiler, the first source).
- softmax: builds of csrc/rtc/softmax_ce.cu (B7's head, compiled by
  NVRTC through rtc.CudaKernel; default the repo's) at chip_smoke.py
  phase 10's shapes ((32, 1000) and (8192, 32000)), forward and backward,
  at the head's geometry (rtc_ops.softmax_geometry and
  softmax_backward_block), or at BLOCK threads a row for a source given
  as PATH@BLOCK (an earlier tree's kernel at its own geometry); beside
  torch.softmax, torch.scatter_add and, at (32, 1000), the launch floor
  (an empty kernel through the same launcher at the forward's geometry).
- nms: builds of the NMS kernel (V1; default
  mxnet_tpu_torch/csrc/nms.cu), each with the library's flags, at
  chip_smoke.py phase 13's calls: the detection's (32 x 117,976), its
  image 0's first 4,096 candidates and Proposal's (1 x 6,000), read from
  FILE; where FILE is missing, chip_smoke.py's phase 13 runs first (its
  SSD trained for its 10 steps) and saves them there. A build of the
  mask-and-scan design (its C interface has nms_max_candidates) runs
  under that design's wrapper, any other under ops/nms.py's. Each time
  is a whole call of the wrapper, its host sync included; the ratio of
  the last source to the first, each call's bound, and each kernel's
  device time and the call's top host ops (torch.profiler) follow.
  `--phases` also builds a copy of the last source whose segment
  blocks count, in thread 0, the clock64 cycles of each phase of their
  tile loop (fill, gather, cross test, the cluster's OR, survivors,
  their mask, the scan, append), and prints each call's means.
- host: the host µs of a push, a push_into, a torch.mul and a
  torch.empty (chip_smoke.py's `_host_us`) with the package found under
  each --root (default this checkout), one process a turn.

Each source is first held to its plain version (the paged kernels at
chip_smoke.py's tolerances, the softmax forward at 1e-6 absolute and its
backward bit for bit, NMS's keep bits exactly at 4,096 candidates and
at Proposal's call) unless `--no-check` (diagnostic builds that skip
part of the work). Prints one line per (row, source): the mean over the
turns, then each turn. Variant sources and other trees go under a
directory that .gitignore lists (`_tree/`, `mxnet_tpu_torch/_build/`),
so that they stay out of commits.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """This checkout's chip_smoke.py, whichever tree's package is on the
    path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def turn_order(n, rounds):
    """Indices of n variants, forward and back each round."""
    return (list(range(n)) + list(reversed(range(n)))) * rounds


def time_turns(torch, cs, variants, flush, reps, rounds):
    """{name: ms, ms_clean_l2 (each turn) and their means} of each
    (name, fn), in turns a, b, ..., b, a."""
    out = {name: {"ms": [], "ms_clean_l2": []} for name, _ in variants}
    for i in turn_order(len(variants), rounds):
        name, fn = variants[i]
        out[name]["ms"].append(cs._time_ms(torch, fn, flush, reps))
        out[name]["ms_clean_l2"].append(
            cs._time_ms(torch, fn, flush, reps, clean=True))
    for t in out.values():
        for key in ("ms", "ms_clean_l2"):
            t[key + "_mean"] = sum(t[key]) / len(t[key])
    return out


def report(label, res, bound_ms):
    for name, t in res.items():
        print(f"{label} {name:>40s}: ms {t['ms_mean']!r} clean "
              f"{t['ms_clean_l2_mean']!r} (bound {bound_ms!r}); turns "
              f"{t['ms']} clean {t['ms_clean_l2']}", flush=True)


# ------------------------------------------------------------- paged B4/B5
def build_paged(kernels, srcs, flags=None):
    """Build the sources with the package's flags (or `flags`), one nvcc
    each, all started together; returns their libraries."""
    flags = tuple(flags or kernels.NVCC_FLAGS)
    jobs = []
    for src in srcs:
        with open(src, "rb") as f:
            digest = hashlib.sha256(
                f.read() + " ".join(flags).encode()).hexdigest()
        stem = os.path.splitext(os.path.basename(src))[0]
        jobs.append((stem, src, os.path.join(
            kernels.BUILD_DIR, "bench", f"lib{stem}-{digest[:16]}.so"),
            flags))
    with kernels._lock:
        kernels._compile(jobs)
    return [job[2] for job in jobs]


def profile_paged(torch, fn, flush, label, reps=20):
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


def run_paged(torch, cs, args, flush):
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.decoding import attention, quant

    srcs = args.src or [os.path.join(kernels.CSRC_DIR,
                                     "paged_attention.cu")]
    libs = []
    for path in build_paged(kernels, srcs):  # each may split by its own size
        lib = ctypes.CDLL(path)
        attention.CHUNK_PAGES = lib.paged_attention_chunk_pages()
        libs.append((attention.bind_library(lib), attention.CHUNK_PAGES))

    def use(i):
        attention._lib, attention.CHUNK_PAGES = libs[i]

    dev = torch.device("cuda")
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
            for i, src in enumerate(srcs):
                use(i)
                err = (attention.paged_attention(*case) - ref).abs().max()
                if not args.no_check and not err.item() <= cs.TOL[kv]:
                    sys.exit(f"{src} {kv} Bp={bp}: error {err.item()!r}")
            res = time_turns(torch, cs, [
                (os.path.relpath(src, ROOT), lambda i=i: (
                    use(i), attention.paged_attention(*case)))
                for i, src in enumerate(srcs)], flush, 20, args.rounds)
            report(f"{kv:7s} Bp={bp:3d}", res, bound_ms)
            results.append({"kv": kv, "bp": bp, "bound_ms": bound_ms,
                            "rows": res})
            if args.profile:
                use(0)
                profile_paged(torch, lambda: attention.paged_attention(
                    *case), flush, f"{kv} Bp={bp}")
    attention._lib = None
    return results


# ----------------------------------------------------------- softmax B7
def run_softmax(torch, cs, args, flush):
    from mxnet_tpu_torch import rtc, rtc_ops

    builds = []
    for spec in args.src or [rtc_ops.source_path("softmax_ce_forward")]:
        path, _, block = spec.partition("@")
        with open(path) as f:
            text = f.read()
        label = os.path.relpath(path, ROOT) + (f"@{block}" if block else "")
        builds.append((label, rtc.CudaKernel(f"{label}:fwd", text,
                                             "softmax_ce_forward"),
                       rtc.CudaKernel(f"{label}:bwd", text,
                                      "softmax_ce_backward"),
                       int(block) if block else None))
    floor = rtc.CudaKernel("launch_floor", cs.RTC_FLOOR_SRC, "launch_floor")
    dev = torch.device("cuda")
    out = {}
    for rows, cols in ((cs.TRAIN_BATCH, 1000), tuple(cs.RTC_VOCAB_SHAPE)):
        g = torch.Generator(device=dev).manual_seed(rows)
        x = torch.randn((rows, cols), generator=g, device=dev) * 5.0
        label = torch.randint(0, cols, (rows,), generator=g,
                              device=dev).float()
        ref = rtc_ops.softmax_plain(x)
        prob, grad = torch.empty_like(x), torch.empty_like(x)
        head_fwd = rtc_ops.softmax_geometry(cols)[0]
        head_bwd = rtc_ops.softmax_backward_block(cols)
        fwd, bwd = [], []
        for name, kf, kb, block in builds:
            bf, bb = block or head_fwd, block or head_bwd
            kf.push_into([x], [prob], grid=rows, block=bf)
            kb.push_into([prob, label], [grad], grid=rows, block=bb)
            torch.cuda.synchronize()
            err = (prob - ref).abs().max().item()
            if not args.no_check and not (
                    err <= cs.RTC_SOFTMAX_TOL and torch.equal(
                        grad, rtc_ops.softmax_ce_backward_plain(prob,
                                                                label))):
                sys.exit(f"{name} ({rows}, {cols}): forward error {err!r} "
                         "or a backward that is not bit-identical")
            fwd.append((f"{name} fwd {bf}", lambda k=kf, b=bf: k.push_into(
                [x], [prob], grid=rows, block=b)))
            bwd.append((f"{name} bwd {bb}", lambda k=kb, b=bb: k.push_into(
                [prob, label], [grad], grid=rows, block=b)))
        fwd.append(("torch.softmax", lambda: torch.softmax(x, dim=1)))
        if cols <= 4 * rtc_ops.SOFTMAX_MAX_BLOCK:
            fwd.append((f"launch floor {head_fwd}", lambda: floor.push_into(
                [x], [prob], grid=rows, block=head_fwd)))
        idx = label.long()[:, None]
        minus = torch.full_like(idx, -1.0, dtype=torch.float32)
        bwd.append(("torch.scatter_add", lambda: torch.scatter_add(
            prob, 1, idx, minus)))
        reps = 20 if rows * cols < 1 << 24 else 5
        for kind, variants, backward in (("forward", fwd, False),
                                         ("backward", bwd, True)):
            bound = cs._softmax_bound(rows, cols, backward)[0]
            res = time_turns(torch, cs, variants, flush, reps, args.rounds)
            report(f"{kind} ({rows}, {cols})", res, bound)
            out[f"{kind} ({rows}, {cols})"] = {"bound_ms": bound,
                                               "rows": res}
        del x, label, ref, prob, grad, idx, minus
        torch.cuda.empty_cache()
    for name, kf, _, _ in builds:
        print(f"build log of {name}:\n{kf.build_log}", flush=True)
    return out


# ---------------------------------------------------------------- nms V1
def mask_scan_nms(torch, lib, boxes, classes, valid, thresh, force,
                  cap=16 << 30):
    """The wrapper of csrc/nms.cu's mask-and-scan design (a K x K bit mask
    over the valid prefix, then one scan block an image; images grouped
    so that the mask stays under `cap` bytes), for a build of that
    source: its C interface has nms_max_candidates."""
    b, k = valid.shape
    dev = boxes.device
    keep = torch.empty((b, k), dtype=torch.uint8, device=dev)
    classes = classes.to(torch.int32).contiguous()
    nvalid = valid.sum(1, dtype=torch.int32)
    counts = nvalid.tolist()
    stream = torch.cuda.current_stream(dev).cuda_stream
    start = 0
    while start < b:
        rows, end = 0, start
        while end < b:
            r = max(rows, counts[end])
            if end > start and (end - start + 1) * r * -(-r // 64) * 8 > cap:
                break
            rows, end = r, end + 1
        words = -(-rows // 64)
        mask = torch.empty((end - start, rows, words), dtype=torch.int64,
                           device=dev)
        err = lib.nms_forward(
            ctypes.c_void_p(boxes[start].data_ptr()),
            ctypes.c_void_p(classes[start].data_ptr()),
            ctypes.c_void_p(nvalid[start:].data_ptr()),
            ctypes.c_void_p(mask.data_ptr()),
            ctypes.c_void_p(keep[start].data_ptr()), end - start, k, rows,
            words, float(thresh), int(bool(force)), ctypes.c_void_p(stream))
        if err:
            sys.exit(f"nms_forward (mask and scan) failed: {err}")
        del mask
        start = end
    return keep.view(torch.bool)


def nms_variants(torch, srcs):
    """(label, nms function) of each source's build: the package's
    wrapper over a build with its C interface, mask_scan_nms over one
    with the mask-and-scan interface."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import nms as tnms

    flags = kernels.NVCC_FLAGS + kernels.LIBRARIES[tnms.LIBRARY][1]
    out = []
    for src, path in zip(srcs, build_paged(kernels, srcs, flags)):
        lib = ctypes.CDLL(path)
        label = os.path.relpath(src, ROOT)
        if hasattr(lib, "nms_max_candidates"):
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.nms_forward.argtypes = ([ptr] * 5 + [i32] * 4
                                        + [ctypes.c_float, i32, ptr])
            lib.nms_forward.restype = i32
            out.append((label, lambda *a, lib=lib: mask_scan_nms(
                torch, lib, *a)))
        else:
            lib = tnms.bind_library(lib)

            def run(*a, lib=lib):
                tnms._lib = lib
                return tnms.nms(*a)
            out.append((label, run))
    return out


def profile_nms(torch, fn, args, label):
    """Device ms of each kernel in one call of fn, and the host µs of
    the call's torch ops with the most."""
    act = [torch.profiler.ProfilerActivity.CUDA,
           torch.profiler.ProfilerActivity.CPU]
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        fn(*args)
        torch.cuda.synchronize()
    events = prof.key_averages()
    for e in events:
        if "nms" in e.key and e.self_device_time_total > 0:
            print(f"  profile {label}: {e.key[:60]} "
                  f"{e.self_device_time_total / 1e3!r} ms (x{e.count})",
                  flush=True)
    host = sorted((e for e in events if e.key.startswith(("aten::", "cuda"))),
                  key=lambda e: -e.self_cpu_time_total)[:8]
    print(f"  host {label}: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total:.0f} us" for e in host), flush=True)


# the segment kernel's tile loop, by the comment that opens each phase:
# (name, marker); a phase's clock runs from its marker to the next one
NMS_PHASES = (("fill", "    // 1. the tile's members"),
              ("gather", "    // 2. the tile's boxes"),
              ("cross", "    // 3. cross test"),
              ("or", "    // every block's bits of this tile are final"),
              ("survivors", "    // 4. the survivors"),
              ("mask", "    // 5. the survivors' overlap"),
              ("scan", "    // 6. one warp walks"),
              ("append", "    // 7. the kept survivors"))


def nms_phase_source(src):
    """A copy of csrc/nms.cu whose segment blocks with at least
    nms_phase_reset(min) members add up, in thread 0, the clock64 cycles
    of each phase of their tile loop; nms_phase_read gets the sums and
    the blocks counted."""
    n = len(NMS_PHASES)
    out = src.replace("namespace {\n", f"""__device__ unsigned long long g_phase[{n + 1}];
__device__ int g_phase_min;
namespace {{
""", 1)
    out = out.replace("  if (cnt == 0) return;\n", f"""  if (cnt == 0) return;
  const bool prof = threadIdx.x == 0 && cnt >= g_phase_min;
  long long ph[{n}] = {{0}};
  long long t_last = clock64();
#define TICK(k) if (prof) {{ const long long now = clock64(); \\
    if (k >= 0) ph[k] += now - t_last; t_last = now; }}
""", 1)
    for k, (_, mark) in enumerate(NMS_PHASES):
        if out.count(mark) != 1:
            sys.exit(f"nms --phases: {mark.strip()!r} is not in the source")
        out = out.replace(mark, f"    TICK({k - 1})\n" + mark)
    tail = "    parity ^= 1;\n    __syncthreads();\n  }\n"
    if out.count(tail) != 1:
        sys.exit("nms --phases: the tile loop's end is not in the source")
    out = out.replace(tail, f"""    parity ^= 1;
    __syncthreads();
    TICK({n - 1})
  }}
  if (prof) {{
    for (int k = 0; k < {n}; ++k)
      atomicAdd(&g_phase[k], static_cast<unsigned long long>(ph[k]));
    atomicAdd(&g_phase[{n}], 1ull);
  }}
""")
    return out + f"""
extern "C" void nms_phase_reset(int min_members) {{
  unsigned long long z[{n + 1}] = {{0}};
  cudaMemcpyToSymbol(g_phase, z, sizeof z);
  cudaMemcpyToSymbol(g_phase_min, &min_members, sizeof(int));
}}
extern "C" void nms_phase_read(unsigned long long* out) {{
  cudaMemcpyFromSymbol(out, g_phase, {n + 1} * sizeof(unsigned long long));
}}
"""


def nms_phases(torch, src, calls):
    """Each call's mean clock64 cycles a segment block spends in each
    phase of its tile loop (csrc/nms.cu patched by nms_phase_source),
    over the blocks of at least 20,000 members and over all."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import nms as tnms

    with open(src) as f:
        text = nms_phase_source(f.read())
    path = os.path.join(kernels.BUILD_DIR, "bench", "nms_phases.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    flags = kernels.NVCC_FLAGS + kernels.LIBRARIES[tnms.LIBRARY][1]
    lib = tnms.bind_library(ctypes.CDLL(build_paged(kernels, [path],
                                                    flags)[0]))
    lib.nms_phase_reset.argtypes = [ctypes.c_int]
    tnms._lib = lib
    n = len(NMS_PHASES)
    out = {}
    for name, least in (("detection", 20000), ("detection", 0),
                        ("proposal", 0)):
        tnms.nms(*calls[name])
        torch.cuda.synchronize()
        lib.nms_phase_reset(least)
        tnms.nms(*calls[name])
        torch.cuda.synchronize()
        got = (ctypes.c_ulonglong * (n + 1))()
        lib.nms_phase_read(got)
        blocks = max(got[n], 1)
        cycles = {p: got[k] / blocks for k, (p, _) in enumerate(NMS_PHASES)}
        total = sum(cycles.values())
        print(f"nms phases {name}, blocks of >= {least} members: {got[n]} "
              f"blocks, mean cycles a block {total!r}: " + json.dumps(
                  {p: [c, round(c / max(total, 1), 4)]
                   for p, c in cycles.items()}), flush=True)
        out[f"{name} >= {least}"] = {"blocks": got[n], "cycles": cycles}
    tnms._lib = None
    return out


def run_nms(torch, cs, args, flush):
    from mxnet_tpu_torch.ops import nms as tnms

    if not args.inputs:
        sys.exit("nms: --inputs PATH is required")
    if not os.path.exists(args.inputs):
        # phase 13 writes them (its SSD trained for its 10 steps)
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import kernels

        torch.backends.cudnn.allow_tf32 = False
        kernels.build_all([tnms.LIBRARY])
        cs.NMS_SAVE = args.inputs
        cs.phase_vision(torch, mx)
        torch.cuda.empty_cache()
    srcs = args.src or [os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                                     "nms.cu")]
    variants = nms_variants(torch, srcs)
    dev = torch.device("cuda")
    saved = torch.load(args.inputs)
    calls = {name: [a.to(dev) if torch.is_tensor(a) else a for a in call]
             for name, call in saved.items()}
    det = calls["detection"]
    k = cs.NMS_CHECK_K[0]
    small = [det[0][:1, :k], det[1][:1, :k], det[2][:1, :k], det[3],
             det[4]]
    calls = {"detection": det, "small": small,
             "proposal": calls["proposal"]}
    for name in ("small", "proposal"):
        want = tnms.nms_plain(*calls[name])
        for label, fn in variants:
            diff = int((fn(*calls[name]) != want).sum())
            print(f"nms {name}: {label} against nms_plain: {diff} keep bits "
                  "differ", flush=True)
            if diff and not args.no_check:
                sys.exit(f"{label} differs from nms_plain at {name}")
    out = {}
    for name, a in calls.items():
        keep = variants[-1][1](*a)
        torch.cuda.synchronize()
        bound = cs._nms_bound(torch, keep, a[2], a[1], a[4])
        reps = 3 if name == "detection" else 20
        res = time_turns(torch, cs, [(label, lambda f=fn, a=a: f(*a))
                                     for label, fn in variants], flush,
                         reps, args.rounds)
        report(f"nms {name} {list(a[0].shape[:2])}", res,
               bound["bound_ms"])
        first, last = (res[label]["ms_mean"] for label in
                       (variants[0][0], variants[-1][0]))
        print(f"nms {name}: {variants[-1][0]} / {variants[0][0]} = "
              f"{last / first!r} (bound {bound['bound_ms']!r} ms, "
              f"{bound['pairs']!r} pairs; all classes' "
              f"{bound['bound_ms_all_pairs']!r} ms)", flush=True)
        for label, fn in variants:
            profile_nms(torch, fn, a, f"{name} {label}")
        out[name] = {"bound": bound, "rows": res}
    tnms._lib = None
    if args.phases:
        out["phases"] = nms_phases(torch, srcs[-1], calls)
    return out


# ------------------------------------------------------ host of a push
def host_turn(root):
    """One process's host µs with the package under `root`: the last
    line of its output is a JSON object."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    cs = load_chip_smoke()
    from mxnet_tpu_torch import rtc, rtc_ops

    dev = torch.device("cuda")
    small = torch.randn(4096, device=dev)
    out = torch.empty_like(small)
    k = rtc_ops.kernel("double_f32")
    res = cs._host_us(torch, {
        "push": lambda: k.push([small], [small.shape]),
        "push_into": lambda: k.push_into([small], [out]),
        "torch_mul": lambda: torch.mul(small, 2.0),
        "torch_empty": lambda: torch.empty((4096,), dtype=torch.float32,
                                           device=dev)})
    res["rtc"] = rtc.__file__
    print(json.dumps(res), flush=True)


def run_host(args):
    roots = args.root or [ROOT]
    turns = {root: [] for root in roots}
    for i in turn_order(len(roots), args.rounds):
        done = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "host-turn",
             roots[i]], capture_output=True, text=True, timeout=600)
        if done.returncode != 0:
            sys.exit(f"host turn of {roots[i]} failed:\n{done.stderr}")
        res = json.loads(done.stdout.strip().splitlines()[-1])
        turns[roots[i]].append(res)
        print(f"host {roots[i]}: " + " ".join(
            f"{k} {v!r}" for k, v in res.items() if k.endswith("host_us")),
            flush=True)
    out = {}
    for root, runs in turns.items():
        out[root] = {k: [r[k] for r in runs] for k in runs[0]
                     if k.endswith("host_us")}
        print(f"host {root} (each turn's median, in order): "
              + json.dumps(out[root]), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("paged", "softmax", "nms", "host",
                                     "host-turn"))
    ap.add_argument("root_of_turn", nargs="?", help=argparse.SUPPRESS)
    ap.add_argument("--src", action="append",
                    help="a kernel source (repeat to compare several)")
    ap.add_argument("--root", action="append",
                    help="host: a tree whose mxnet_tpu_torch is timed")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--no-check", action="store_true",
                    help="time sources whose results are not checked "
                    "(diagnostic builds that skip part of the work)")
    ap.add_argument("--profile", action="store_true",
                    help="paged: also print each kernel's device time a "
                    "call (torch.profiler, the first source, clean L2)")
    ap.add_argument("--phases", action="store_true",
                    help="nms: also the phase clocks of the last source's "
                    "segment blocks (a patched copy)")
    ap.add_argument("--inputs", help="nms: the file of phase 13's V1 "
                    "arguments (written first when missing)")
    ap.add_argument("--out", help="also write the numbers as JSON here")
    args = ap.parse_args()
    if args.mode == "host-turn":
        return host_turn(args.root_of_turn)

    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_kernels: needs a CUDA card")
    sys.path.insert(0, ROOT)
    cs = load_chip_smoke()
    res = {"card": card(), "torch": torch.__version__, "mode": args.mode}
    print(res["card"], flush=True)
    if args.mode == "host":
        res["host"] = run_host(args)
    else:
        flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                            device="cuda")
        run = {"paged": run_paged, "softmax": run_softmax,
               "nms": run_nms}[args.mode]
        res[args.mode] = run(torch, cs, args, flush)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1, default=str)


if __name__ == "__main__":
    main()

"""Phase 18's prefetch-on fit, several times, with each batch's timeline:
where DevicePrefetchIter's stager spends its time and how far ahead of
the consumer each batch is staged.

    python tools/prefetch_timeline.py [--fits 4] [--out timeline.json]

Needs one CUDA card. It builds the kernels, trains phase 6's module
(`chip_smoke.phase_training`: Inception-ResNet-v2, batch 32, a captured
step), writes phase 18's RecordIO file and runs `chip_smoke._pipeline_fit`
with prefetch 2 in turns of two arms, A B B A:

- `current`: DevicePrefetchIter as it is (the stager makes no CUDA call;
  `next()` issues the host-to-device copies);
- `stager_copies`: the same class with the copies issued by the stager
  thread as each batch is staged (the design before), for comparison.

Per fit it prints the stall count, each batch's stager ms (pull to
staged), slack ms (staged to asked) and next() ms (asked to served), the
host probe of `_pipeline_fit` (late wakes of a 1 ms sleeper, collector
pauses) and the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _stager_copies_class(dp):
    """DevicePrefetchIter whose stager thread issues each batch's copies
    as it stages it."""

    class StagerCopies(dp.DevicePrefetchIter):
        def _make_item(self, stop_evt):
            item = super()._make_item(stop_evt)
            if item is not None:
                item["issued"] = super()._issue(item)
            return item

        def _issue(self, item):
            return item["issued"] if "issued" in item else \
                super()._issue(item)

    return StagerCopies


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fits", type=int, default=4,
                    help="fits of each arm (in turns A B B A)")
    ap.add_argument("--out", default=None, help="JSON of every fit")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import data as mxdata
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.data import device_prefetch as dp

    torch.backends.cudnn.allow_tf32 = False
    caches = tempfile.mkdtemp(prefix="prefetch_timeline_")
    os.environ["MXNET_CALIBRATION_CACHE"] = os.path.join(caches, "c.json")
    os.environ["MXNET_TUNING_CACHE"] = os.path.join(caches, "t.json")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    kernels.build_all(generated=lambda: cs._ahead_sources(mx))
    _, _, _, mod = cs.phase_training(torch, mx)
    files = cs._pipeline_file(caches)
    arms = {"current": dp.DevicePrefetchIter,
            "stager_copies": _stager_copies_class(dp)}
    order = []
    for i in range(args.fits):
        order += ["stager_copies", "current"] if i % 2 == 0 else \
            ["current", "stager_copies"]
    fits = []
    for arm in order:
        mxdata.DevicePrefetchIter = arms[arm]
        try:
            r = cs._pipeline_fit(torch, mx, mod, files, cs.PIPE_PREFETCH)
        finally:
            mxdata.DevicePrefetchIter = dp.DevicePrefetchIter
        tl = r["timeline"]
        fit = {"arm": arm, "stalls": r["stats"]["stall_count"],
               "step_ms": r["step_ms"],
               "stager_ms": [m["staged"] - m["pull"] for m in tl],
               "slack_ms": [m["asked"] - m["staged"] for m in tl],
               "next_ms": [m["served"] - m["asked"] for m in tl],
               "ring": r["ring"], "host": r["host"]}
        fits.append(fit)
        print(json.dumps({k: (np.round(v, 2).tolist()
                              if isinstance(v, list) else v)
                          for k, v in fit.items() if k != "host"}),
              flush=True)
    summary = {}
    for arm in arms:
        mine = [f for f in fits if f["arm"] == arm]
        stager = [x for f in mine for x in f["stager_ms"][3:]]
        slack = [x for f in mine for x in f["slack_ms"][3:]]
        summary[arm] = {
            "fits": len(mine), "stalls": [f["stalls"] for f in mine],
            "stager_ms_p50_max": [float(np.percentile(stager, 50)),
                                  float(max(stager))],
            "batches_stager_over_100ms": sum(x > 100 for x in stager),
            "batches": len(stager),
            "slack_ms_min_p50": [float(min(slack)),
                                 float(np.percentile(slack, 50))],
            "late_wake_max_ms": max((w[1] for f in mine
                                     for w in f["host"]["late_wakes_ms"]),
                                    default=0.0),
            "gc_pauses": sum(len(f["host"]["gc_pauses_ms"]) for f in mine)}
    print("summary " + json.dumps(summary | {"card": card}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "fits": fits, "summary": summary}, f)


if __name__ == "__main__":
    main()

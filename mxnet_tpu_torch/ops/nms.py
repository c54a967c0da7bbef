"""Greedy non-maximum suppression: the CUDA kernel (csrc/nms.cu) and its
plain PyTorch versions.

The JAX package runs NMS as a `lax.fori_loop` over a dense K x K IoU
(mxnet_tpu/ops/vision.py `_nms_loop`), which MultiBoxDetection and
Proposal call. Here

- `nms_plain` is that loop in torch ops: a dense IoU and a K-step mask
  update. CPU tensors take it; nothing on the card's path calls it.
- `nms_segmented_plain` is the kernel's algorithm in torch ops: each
  (image, class) segment's candidates in tiles, each tile tested against
  the segment's kept boxes, then its survivors among themselves. The
  tests hold it to `nms_plain` and the JAX package's loop; no path calls
  it.
- `nms` takes CPU tensors to `nms_plain` and CUDA tensors to the kernel,
  and raises on any other device, type or shape, on a `valid` that is
  not a prefix of each row, or on a failed build or launch. Meta tensors (symbolic shape inference) get an empty keep
  of the right shape.

The candidates are sorted by descending score with a stable sort of
the negated score, and `valid` is `score > 0`: the valid candidates
are then a prefix of each row, which the kernel relies on (a score-0
candidate is never kept and suppresses nothing).
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError

LIBRARY = "nms"
# class ids of one call that the kernel partitions into (image, class)
# segments: a wider range takes one segment an image, each pair also
# comparing classes
PARTITION_SLOTS = 1024
# kept boxes a class segment holds in shared memory; the rest spill to a
# global area read back through L2 (an image segment holds as many as
# shared memory takes)
PARTITION_KEPT = 1024
# blocks a segment takes when there are few segments (Proposal's one):
# they share its kept boxes and each tile's cross test
CLUSTER = 8


def iou_matrix(a, b):
    """a (..., A, 4), b (..., G, 4) corner boxes -> (..., A, G) IoU, in
    the JAX package's `_iou_matrix` order of operations."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp_min(br - tl, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp_min(
        (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]), 0.0)
    area_b = torch.clamp_min(
        (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]), 0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms_plain(boxes, classes, valid, iou_thresh, force_suppress):
    """The reference's loop: boxes (B, K, 4) sorted by descending score,
    classes (B, K), valid (B, K) bool -> keep (B, K) bool."""
    k = boxes.shape[1]
    over = iou_matrix(boxes, boxes) > iou_thresh
    if not force_suppress:
        over &= classes[:, :, None] == classes[:, None, :]
    later = torch.arange(k, device=boxes.device)
    keep = valid.clone()
    for i in range(k):
        sup = keep & over[:, i] & (later > i)
        keep &= ~(keep[:, i:i + 1] & sup)
    return keep


def nms_segmented_plain(boxes, classes, valid, iou_thresh, force_suppress,
                        tile=256, by_class=True):
    """The kernel's algorithm in torch ops, same signature and result as
    `nms_plain`. A segment is one (image, class) (one image under
    force_suppress, or with by_class false, where each pair also compares
    classes); its members, in score order, go `tile` at a time: (a) each
    member against the segment's kept boxes (the kept box as the IoU's
    first argument), (b) the survivors of (a) among themselves, in order,
    (c) the kept survivors join the kept boxes."""
    b = boxes.shape[0]
    keep = torch.zeros_like(valid)
    for g in range(b):
        members = valid[g].nonzero().squeeze(1)
        if force_suppress or not by_class:
            segments = [members]
        else:
            mc = classes[g, members]
            segments = [members[mc == c] for c in torch.unique(mc)]
        for seg in segments:
            kept = seg[:0]
            for t0 in range(0, seg.numel(), tile):
                m = seg[t0:t0 + tile]
                over = iou_matrix(boxes[g, kept], boxes[g, m]) > iou_thresh
                if not force_suppress:
                    over &= classes[g, kept, None] == classes[g, None, m]
                surv = m[~over.any(0)]
                over = iou_matrix(boxes[g, surv], boxes[g, surv]) \
                    > iou_thresh
                if not force_suppress:
                    over &= classes[g, surv, None] == classes[g, None, surv]
                alive = torch.ones(surv.numel(), dtype=torch.bool,
                                   device=boxes.device)
                for s in range(surv.numel()):
                    if alive[s]:
                        alive[s + 1:] &= ~over[s, s + 1:]
                keep[g, surv[alive]] = True
                kept = torch.cat([kept, surv[alive]])
    return keep


# ------------------------------------------------------------------ cuda
_lib = None


def bind_library(lib):
    """Declare the C interface of a built csrc/nms.cu on its ctypes
    handle (tools/bench_kernels.py nms binds other builds the same
    way)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.nms_forward.argtypes = ([ptr] * 8 + [i32] * 4
                                + [ctypes.c_longlong] + [i32] * 4
                                + [ctypes.c_float, ptr])
    lib.nms_forward.restype = i32
    lib.nms_max_kept.argtypes = [i32]
    lib.nms_max_kept.restype = i32
    return lib


def _kernel_lib():
    global _lib
    if _lib is None:
        from .. import kernels

        _lib = bind_library(kernels.load(LIBRARY))
    return _lib


def _check_cuda(boxes, classes, valid):
    dev = boxes.device
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise MXNetError(f"nms: boxes (B, K, 4) expected, got "
                         f"{tuple(boxes.shape)}")
    if tuple(classes.shape) != tuple(boxes.shape[:2]) or \
            tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise MXNetError(
            f"nms: classes {tuple(classes.shape)} and valid "
            f"{tuple(valid.shape)} must be (B, K) of boxes "
            f"{tuple(boxes.shape)}")
    if boxes.dtype != torch.float32:
        raise MXNetError(f"nms kernel takes float32 boxes, got {boxes.dtype}")
    if valid.dtype != torch.bool:
        raise MXNetError(f"nms: valid must be bool, got {valid.dtype}")
    if classes.dtype.is_floating_point or classes.dtype == torch.bool:
        raise MXNetError(f"nms: classes must be integer, got "
                         f"{classes.dtype}")
    for name, t in (("classes", classes), ("valid", valid)):
        if t.device != dev:
            raise MXNetError(f"nms: {name} is on {t.device}, boxes on {dev}")


def _max_kept(class_test):
    if class_test not in _max_kept.cache:
        _max_kept.cache[class_test] = _kernel_lib().nms_max_kept(class_test)
    return _max_kept.cache[class_test]


_max_kept.cache = {}


def _sm_count(dev):
    if dev not in _sm_count.cache:
        _sm_count.cache[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_count.cache[dev]


_sm_count.cache = {}


def _plan(nvalid, lo, hi, force_suppress, k, sm_count, max_kept):
    """How the kernel takes one call, from the host's one read: nvalid
    (each image's valid count), lo and hi (the smallest and largest class
    id), K, the card's SM count and max_kept(class_test) (the kept boxes
    a block's shared memory holds). None when no candidate is valid.

    A segment is one (image, class) when the class ids span 2 to
    PARTITION_SLOTS values (`nslots` of them, `cls0` the first), else one
    image: under force_suppress or one class id, or with `class_test`
    (each pair compares classes) over a wider span. A segment takes a
    `cluster` of CLUSTER blocks of 512 `threads` when the segments are so
    few that clusters fill at most two blocks an SM, else one block of
    256. `cap` kept
    boxes a block stay in shared memory; `spill` when a segment may keep
    more than its blocks hold. `kp`: K rounded up to 16 (the class
    slots' row)."""
    most = max(nvalid)
    if most == 0:
        return None
    span = 1 if force_suppress else hi - lo + 1
    partition = 1 < span <= PARTITION_SLOTS
    class_test = span > PARTITION_SLOTS
    nslots = span if partition else 1
    cap = min(most, max_kept(int(class_test)))
    if partition:
        cap = min(cap, PARTITION_KEPT)
    cluster = CLUSTER if len(nvalid) * nslots * CLUSTER <= 2 * sm_count \
        else 1
    return {"nslots": nslots, "cls0": lo if partition else 0,
            "class_test": class_test, "kp": -(-k // 16) * 16, "cap": cap,
            "spill": cap * cluster < most, "cluster": cluster,
            "threads": 512 if cluster > 1 else 256}


def nms(boxes, classes, valid, iou_thresh, force_suppress):
    """Greedy NMS over candidates sorted by descending score: boxes
    (B, K, 4) float32, classes (B, K) integer, valid (B, K) bool (a
    prefix of each row) -> keep (B, K) bool. CPU tensors take the plain
    version; CUDA tensors the kernel."""
    dev = boxes.device
    if dev.type == "meta":
        return torch.empty(valid.shape, dtype=torch.bool, device=dev)
    if dev.type == "cpu":
        return nms_plain(boxes, classes, valid, iou_thresh, force_suppress)
    if dev.type != "cuda":
        raise MXNetError(f"nms runs on CPU or CUDA tensors, got {dev}")
    _check_cuda(boxes, classes, valid)
    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.uint8, device=dev)
    if keep.numel() == 0:
        return keep.view(torch.bool)
    lib = _kernel_lib()
    boxes = boxes.contiguous()
    if boxes.data_ptr() % 16:        # the kernel reads a box as a float4
        boxes = boxes.clone()
    classes = classes.to(torch.int64).contiguous()
    nvalid = valid.sum(1)
    broken = (valid != (torch.arange(k, device=dev) < nvalid[:, None])).any()
    # one host sync a call: the counts, whether valid is not a prefix and
    # (without force_suppress) the range of the class ids
    stats = [nvalid, broken.view(1)]
    if not force_suppress:
        stats += [x.view(1) for x in torch.aminmax(classes)]
    counts = torch.cat(stats).tolist()
    lo, hi = (0, 0) if force_suppress else (counts[-2], counts[-1])
    if counts[b]:
        raise MXNetError("nms kernel: valid must be a prefix of each row "
                         "(candidates sorted by descending score)")
    plan = _plan(counts[:b], lo, hi, force_suppress, k, _sm_count(dev),
                 _max_kept)
    if plan is None:
        return torch.zeros((b, k), dtype=torch.bool, device=dev)
    slots = seg_counts = None
    if plan["nslots"] > 1:
        slots = torch.empty((b, plan["kp"]), dtype=torch.int16, device=dev)
        seg_counts = torch.zeros((b, plan["nslots"]), dtype=torch.int32,
                                 device=dev)
    spill = torch.empty((b, k, 4) if plan["spill"] else (0,),
                        dtype=torch.float32, device=dev)
    spill_cls = torch.empty(
        (b, k) if plan["spill"] and plan["class_test"] else (0,),
        dtype=torch.int64, device=dev)
    scratch = [t for t in (slots, seg_counts, spill, spill_cls)
               if t is not None]
    nms.peak_scratch_bytes = max(nms.peak_scratch_bytes, sum(
        t.numel() * t.element_size() for t in scratch))

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None and t.numel()
                               else None)

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nms_forward(
            ptr(boxes), ptr(classes), ptr(nvalid), ptr(slots),
            ptr(seg_counts), ptr(spill), ptr(spill_cls), ptr(keep), b, k,
            plan["kp"], plan["nslots"], plan["cls0"],
            int(plan["class_test"]), plan["cluster"], plan["threads"],
            plan["cap"],
            float(iou_thresh), ctypes.c_void_p(stream))
    if err != 0:
        raise MXNetError(f"nms_forward launch failed: CUDA error {err}")
    nms.launches += 2                    # the prepare and segment kernels
    nms.groups += 1                      # every image in one launch group
    return keep.view(torch.bool)


nms.launches = 0
nms.groups = 0
nms.peak_scratch_bytes = 0


def reset_launch_counts():
    nms.launches = 0
    nms.groups = 0
    nms.peak_scratch_bytes = 0


def launch_counts():
    return {"nms": nms.launches}

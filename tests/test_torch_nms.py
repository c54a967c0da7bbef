"""The NMS kernel's algorithm (csrc/nms.cu) on the CPU: its torch model
`ops/nms.nms_segmented_plain` (each (image, class) segment in tiles,
each tile against the segment's kept boxes, then its survivors among
themselves) held bit for bit to `nms_plain` and to the JAX package's
`_nms_loop` (under jax.vmap), on seeded numpy inputs; and the wrapper's
launch plan (`ops/nms._plan`) at the port's two callers' shapes.

Boxes: random, integer corners on a small grid (IoUs that tie with the
threshold exactly), nested (all overlap), degenerate (zero-area and
inverted) and boxes with NaN corners; per-class and forced suppression;
thresholds 0.5 and 0.3; members at a tile's size less one, at it, one
past it and over several tiles, with one dominant class and with 20
classes; a segment an image with each pair comparing classes (the
kernel's route for a wide class range).
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from mxnet_tpu.ops.vision import _nms_loop  # noqa: E402
from mxnet_tpu_torch.ops import nms as tnms  # noqa: E402


def _boxes(rs, b, k, kind):
    if kind == "grid":         # integer corners: many exact IoU ties
        lo = rs.randint(0, 6, (b, k, 2))
        wh = rs.randint(1, 4, (b, k, 2))
        return np.concatenate([lo, lo + wh], -1).astype(np.float32)
    if kind == "nested":       # every box overlaps every other
        s = rs.uniform(0.3, 1.0, (b, k, 1))
        return np.concatenate([0.5 - s / 2, 0.5 - s / 2, 0.5 + s / 2,
                               0.5 + s / 2], -1).astype(np.float32)
    if kind == "degenerate":   # zero-area and inverted boxes among others
        boxes = _boxes(rs, b, k, "random")
        boxes[:, ::5, 2:] = boxes[:, ::5, :2]
        boxes[:, 1::7, 2:] = boxes[:, 1::7, :2] - 0.1
        return boxes
    if kind == "nan":          # a NaN corner in every sixth box
        boxes = _boxes(rs, b, k, "random")
        boxes[:, ::6, rs.randint(0, 4)] = np.nan
        return boxes
    c = rs.uniform(0, 1, (b, k, 2))
    wh = rs.uniform(0.05, 0.4, (b, k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _classes(rs, b, k, spread):
    if spread == "one":
        return np.zeros((b, k), np.int64)
    if spread == "dominant":   # nine in ten candidates of class 4
        return np.where(rs.uniform(size=(b, k)) < 0.9, 4,
                        rs.randint(0, 20, (b, k))).astype(np.int64)
    return rs.randint(0, spread, (b, k)).astype(np.int64)


def _jax_keep(boxes, classes, valid, thresh, force):
    """The JAX package's loop, one image a vmap lane; score 1 where valid
    and 0 where not (only score > 0 matters)."""
    run = jax.vmap(lambda bx, sc, cl: _nms_loop(bx, sc, cl, thresh, force))
    return np.asarray(run(jnp.asarray(boxes),
                          jnp.asarray(valid.astype(np.float32)),
                          jnp.asarray(classes.astype(np.int32))))


def _hold(boxes, classes, nvalid, thresh, force, tile):
    """Every model's keep bits equal: JAX's loop, nms_plain, the segmented
    model by class (or by image when forced) and by image with a class
    test. Returns the keep bits."""
    k = boxes.shape[1]
    valid = np.arange(k)[None, :] < np.asarray(nvalid)[:, None]
    want = _jax_keep(boxes, classes, valid, thresh, force)
    args = (torch.from_numpy(boxes), torch.from_numpy(classes),
            torch.from_numpy(valid), thresh, force)
    np.testing.assert_array_equal(tnms.nms_plain(*args).numpy(), want)
    np.testing.assert_array_equal(
        tnms.nms_segmented_plain(*args, tile=tile).numpy(), want)
    if not force:
        np.testing.assert_array_equal(
            tnms.nms_segmented_plain(*args, tile=tile,
                                     by_class=False).numpy(), want)
    return want


@pytest.mark.parametrize("kind", ["random", "grid", "nested",
                                  "degenerate", "nan"])
@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("thresh", [0.5, 0.3])
def test_segmented_model_matches_plain_and_jax(kind, force, thresh):
    rs = np.random.RandomState(len(kind) + 7 * force + int(10 * thresh))
    b, k = 3, 70
    boxes = _boxes(rs, b, k, kind)
    keep = _hold(boxes, _classes(rs, b, k, 3), [70, 33, 0], thresh, force,
                 tile=16)
    assert not keep[2].any() and keep[0].any()
    if kind == "nested" and force:
        assert keep[0].sum() < 70


@pytest.mark.parametrize("k", [31, 32, 33, 100])
@pytest.mark.parametrize("spread", ["one", "dominant", 20])
@pytest.mark.parametrize("force", [False, True])
def test_tile_boundaries(k, spread, force):
    """Tile 32: a segment of one class has k members (T - 1, T, T + 1,
    several tiles); a dominant class fills most of them; 20 classes give
    segments under one tile."""
    rs = np.random.RandomState(k + len(str(spread)) + 3 * force)
    boxes = _boxes(rs, 2, k, "random")
    keep = _hold(boxes, _classes(rs, 2, k, spread), [k, k - 1], 0.3, force,
                 tile=32)
    assert keep.any() and not keep.all()


@pytest.mark.parametrize("spread", ["dominant", 20])
def test_several_tiles_at_the_kernel_tile(spread):
    """The kernel's own tile (256) over 700 candidates of small boxes
    (many kept, so later tiles test against a long kept set)."""
    rs = np.random.RandomState(31)
    c = rs.uniform(0, 1, (1, 700, 2))
    wh = rs.uniform(0.01, 0.12, (1, 700, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    keep = _hold(boxes, _classes(rs, 1, 700, spread), [700], 0.5, False,
                 tile=tnms.nms_segmented_plain.__defaults__[0])
    assert keep.sum() > 256


def test_the_kept_box_is_the_first_argument_and_the_bit_is_symmetric():
    """The kernel computes IoU(kept, member); the reference's row i is
    IoU(i, later). Both orders give the same bit on every pair here."""
    rs = np.random.RandomState(5)
    for kind in ("random", "grid", "degenerate", "nan"):
        b = torch.from_numpy(_boxes(rs, 1, 60, kind)[0])
        iou = tnms.iou_matrix(b, b)
        for t in (0.3, 0.5):
            assert torch.equal(iou > t, (iou > t).T)


def _max_kept(class_test):
    return 8942 if class_test else 13541


@pytest.mark.parametrize("case,want", [
    # SSD300's detection: 32 images, 117,976 valid, classes 0..19
    (([117976] * 32, 0, 19, False, 117976),
     {"nslots": 20, "cls0": 0, "class_test": False, "kp": 117984,
      "cap": 1024, "spill": True, "cluster": 1, "threads": 256}),
    # Faster R-CNN's Proposal: one image, 6,000 candidates, forced
    (([6000], 0, 0, True, 6000),
     {"nslots": 1, "cls0": 0, "class_test": False, "kp": 6000,
      "cap": 6000, "spill": False, "cluster": 8, "threads": 512}),
    # one class id, not forced: one segment an image, no class test
    (([50, 3], 7, 7, False, 50),
     {"nslots": 1, "cls0": 0, "class_test": False, "kp": 64, "cap": 50,
      "spill": False, "cluster": 8, "threads": 512}),
    # class ids -2..5 in 3 images: 24 segments
    (([200, 137, 0], -2, 5, False, 200),
     {"nslots": 8, "cls0": -2, "class_test": False, "kp": 208,
      "cap": 200, "spill": False, "cluster": 8, "threads": 512}),
    # a span past PARTITION_SLOTS: one segment an image, classes compared
    (([20000], 0, 5000, False, 20000),
     {"nslots": 1, "cls0": 0, "class_test": True, "kp": 20000,
      "cap": 8942, "spill": False, "cluster": 8, "threads": 512}),
    # 40 images of 20 classes: a block a segment
    (([300] * 40, 0, 19, False, 300),
     {"nslots": 20, "cls0": 0, "class_test": False, "kp": 304,
      "cap": 300, "spill": False, "cluster": 1, "threads": 256}),
    # nothing valid: no launch
    (([0, 0], 0, 3, False, 5), None),
])
def test_launch_plan(case, want):
    nvalid, lo, hi, force, k = case
    assert tnms._plan(nvalid, lo, hi, force, k, 132, _max_kept) == want


def _decide(inter, uni, t):
    """csrc/nms.cu's `decide` in float32 numpy (IEEE products rounded to
    nearest, as the kernel's without contraction): 1 overlap, 0 apart,
    2 division needed; inter > 0 here."""
    f = np.float32
    p = f(t) * uni
    lo, hi = p * f(1 - 2.0 ** -20), p * f(1 + 2.0 ** -20)
    ok = (uni >= f(2.0 ** -100)) & (uni <= f(2.0 ** 100))
    return np.where(~ok, 2, np.where(inter <= lo, 0,
                                     np.where(inter >= hi, 1, 2)))


@pytest.mark.parametrize("t", [0.5, 0.3, 0.7, 0.45, 1e-3])
def test_the_division_free_test_settles_the_same_bit(t):
    """Where the kernel decides IoU > t by two products instead of the
    division, it gives the division's bit: random unions, and
    intersections at t * union and within a few ulps of it (where the
    rounded quotient ties with t or steps past it)."""
    rs = np.random.RandomState(int(t * 1000))
    f = np.float32
    uni = (10.0 ** rs.uniform(-6, 4, 200000)).astype(f)
    base = (f(t) * uni).astype(f)
    steps = rs.randint(-40, 41, uni.size).astype(f)
    near = (base + steps * np.spacing(base)).astype(f)
    wide = (uni * rs.uniform(0, 1, uni.size)).astype(f)
    for inter, share in ((near, 0.5), (wide, 0.999)):
        inter = np.maximum(inter, f(1e-30))
        want = (inter / uni).astype(f) > f(t)
        d = _decide(inter, uni, t)
        settled = d != 2
        assert settled.mean() > share
        np.testing.assert_array_equal(d[settled] == 1, want[settled])

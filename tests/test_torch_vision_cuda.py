"""The CUDA NMS kernel of mxnet_tpu_torch (csrc/nms.cu, V1) against its
plain PyTorch version, and the vision ops on the card against the same
ops on the CPU. Marked `cuda`: these skip where torch.cuda.is_available()
is false (the kernel has no CPU mode). This file imports neither jax nor
mxnet_tpu, so it runs on a machine with only the port installed:

    python -m pytest tests/test_torch_vision_cuda.py -q

Every NMS case compares keep bits exactly: random boxes, integer boxes
on a small grid (IoUs that tie with the threshold exactly), boxes that
all overlap, K not a multiple of 64, K = 1, images with no valid
candidate, per-class and forced suppression; segments at the kernel's
tile (256) less one, at it, one past it and over several tiles, with a
dominant class; kept sets past shared memory (the global spill, for an
image segment and for class segments, in a block and in a cluster of
8); class ids over a range too wide to partition (each pair compares
classes); Proposal's forced 6,000 candidates (a cluster); 32 images of
20 classes with mixed valid counts (a block a segment).
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import nms as tnms
from mxnet_tpu_torch.ops import registry as treg

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _random_boxes(rs, b, k, kind):
    if kind == "grid":         # integer corners: many exact IoU ties
        lo = rs.randint(0, 6, (b, k, 2))
        wh = rs.randint(1, 4, (b, k, 2))
        return np.concatenate([lo, lo + wh], -1).astype(np.float32)
    if kind == "nested":       # every box overlaps every other
        s = rs.uniform(0.3, 1.0, (b, k, 1))
        return np.concatenate([0.5 - s / 2, 0.5 - s / 2, 0.5 + s / 2,
                               0.5 + s / 2], -1).astype(np.float32)
    if kind == "degenerate":   # zero-area and inverted boxes among others
        boxes = _random_boxes(rs, b, k, "random")
        boxes[:, ::5, 2:] = boxes[:, ::5, :2]
        boxes[:, 1::7, 2:] = boxes[:, 1::7, :2] - 0.1
        return boxes
    c = rs.uniform(0, 1, (b, k, 2))
    wh = rs.uniform(0.02, 0.3, (b, k, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)


def _case(rs, b, k, kind, nvalid, classes=3):
    boxes = torch.from_numpy(_random_boxes(rs, b, k, kind))
    cls = torch.from_numpy(rs.randint(0, classes, (b, k)))
    valid = torch.arange(k)[None, :] < torch.tensor(nvalid)[:, None]
    return boxes, cls, valid


def _check(dev, boxes, cls, valid, thresh, force):
    want = tnms.nms_plain(boxes, cls, valid, thresh, force)
    before = tnms.nms.launches
    got = tnms.nms(boxes.to(dev), cls.to(dev), valid.to(dev), thresh, force)
    torch.cuda.synchronize()
    assert tnms.nms.launches > before or not valid.any()
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    return want


CASES = [
    ("random", 2, 200, [200, 137]),
    ("random", 1, 64, [64]),
    ("random", 3, 65, [65, 1, 0]),
    ("random", 1, 1, [1]),
    ("random", 2, 5, [0, 0]),
    ("grid", 2, 300, [300, 255]),
    ("nested", 1, 129, [129]),
    ("degenerate", 2, 190, [190, 100]),
]


@pytest.mark.parametrize("kind,b,k,nvalid", CASES)
@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("thresh", [0.5, 0.3])
def test_kernel_matches_plain(cuda_device, kind, b, k, nvalid, force,
                              thresh):
    rs = np.random.RandomState(k + b + int(force))
    boxes, cls, valid = _case(rs, b, k, kind, nvalid)
    keep = _check(cuda_device, boxes, cls, valid, thresh, force)
    if kind == "nested" and force:
        assert keep.sum() < k


def test_ties_at_the_threshold(cuda_device):
    """IoU exactly 1/3 against a threshold of 1/3 suppresses nothing; a
    threshold one float below it suppresses."""
    boxes = torch.tensor([[[0.0, 0.0, 2.0, 1.0], [1.0, 0.0, 3.0, 1.0],
                           [2.0, 0.0, 4.0, 1.0]]])
    cls = torch.zeros(1, 3, dtype=torch.int64)
    valid = torch.ones(1, 3, dtype=torch.bool)
    third = float(np.float32(1.0) / np.float32(3.0))
    below = float(np.nextafter(np.float32(third), np.float32(0)))
    assert _check(cuda_device, boxes, cls, valid, third, True).all()
    assert _check(cuda_device, boxes, cls, valid, below,
                  True).tolist() == [[True, False, True]]


def _classes(rs, b, k, spread):
    if spread == "dominant":   # nine in ten candidates of class 4
        return torch.from_numpy(np.where(
            rs.uniform(size=(b, k)) < 0.9, 4, rs.randint(0, 20, (b, k))))
    return torch.from_numpy(rs.randint(0, spread, (b, k)))


@pytest.mark.parametrize("k", [255, 256, 257, 1000])
@pytest.mark.parametrize("spread", [1, "dominant", 20])
@pytest.mark.parametrize("force", [False, True])
def test_tile_boundaries(cuda_device, k, spread, force):
    rs = np.random.RandomState(k + 3 * force)
    boxes, _, valid = _case(rs, 2, k, "random", [k, k - 1])
    boxes = boxes * 0.5        # smaller boxes: most of a tile kept
    before = tnms.nms.launches
    keep = _check(cuda_device, boxes, _classes(rs, 2, k, spread), valid,
                  0.4, force)
    assert tnms.nms.launches - before == 2 and keep.any()


def _disjoint(n):
    """n boxes on a grid, none touching another: all kept."""
    side = int(np.ceil(np.sqrt(n)))
    i = np.arange(n)
    lo = np.stack([i % side, i // side], -1).astype(np.float32)
    return torch.from_numpy(np.concatenate([lo, lo + 0.5], -1)[None])


@pytest.mark.parametrize("cluster", [1, 8])
def test_a_kept_set_past_shared_memory(cuda_device, monkeypatch, cluster):
    """16,384 disjoint boxes of one class: one segment keeps them all,
    past the 13,541 a block's shared memory holds (in one block), or
    shared by a cluster of 8."""
    monkeypatch.setattr(tnms, "CLUSTER", cluster)
    n = 16384
    boxes = _disjoint(n)
    cls = torch.zeros(1, n, dtype=torch.int64)
    valid = torch.ones(1, n, dtype=torch.bool)
    for force in (False, True):
        got = tnms.nms(boxes.to(cuda_device), cls.to(cuda_device),
                       valid.to(cuda_device), 0.1, force)
        torch.cuda.synchronize()
        assert bool(got.all())
    # boxes 2j and 2j + 1 coincide: every second box goes
    twin = _disjoint(n // 2).repeat_interleave(2, 1)
    got = tnms.nms(twin.to(cuda_device), cls.to(cuda_device),
                   valid.to(cuda_device), 0.5, False)
    assert torch.equal(got.cpu(), torch.arange(n)[None] % 2 == 0)


@pytest.mark.parametrize("spread", [3, "dominant"])
def test_class_segments_past_their_shared_memory(cuda_device, monkeypatch,
                                                 spread):
    """A class segment's block keeps 8 boxes in shared memory here; the
    rest go through the global spill area (9 segments: a cluster of 8
    blocks each; 60: a block each)."""
    monkeypatch.setattr(tnms, "PARTITION_KEPT", 8)
    rs = np.random.RandomState(11)
    boxes, _, valid = _case(rs, 3, 600, "random", [600, 599, 257])
    _check(cuda_device, boxes * 0.5, _classes(rs, 3, 600, spread), valid,
           0.3, False)


@pytest.mark.parametrize("force", [False, True])
@pytest.mark.parametrize("cluster", [1, 8])
def test_a_wide_class_range(cuda_device, monkeypatch, force, cluster):
    """Class ids 0, 5,000 and 10,000: too wide to partition, so a segment
    is an image and each pair compares classes (and, in one block past
    8,942 kept boxes, the spill holds their classes too)."""
    monkeypatch.setattr(tnms, "CLUSTER", cluster)
    rs = np.random.RandomState(12)
    boxes, _, valid = _case(rs, 2, 700, "grid", [700, 350])
    cls = torch.from_numpy(rs.randint(0, 3, (2, 700)) * 5000)
    _check(cuda_device, boxes, cls, valid, 0.3, force)
    # 7,000 pairs of coinciding boxes: the second of a pair goes when its
    # class is the first's (or under force_suppress), nothing else
    n = 14000
    cls = torch.from_numpy(rs.randint(0, 3, (1, n)) * 5000)
    twin = _disjoint(n // 2).repeat_interleave(2, 1)
    want = torch.ones(1, n, dtype=torch.bool)
    want[:, 1::2] = (cls[:, 1::2] != cls[:, ::2]) & (not force)
    assert want.sum() > 8994 or force
    got = tnms.nms(twin.to(cuda_device), cls.to(cuda_device),
                   want.new_ones(1, n).to(cuda_device), 0.5, force)
    assert torch.equal(got.cpu(), want)


def test_proposal_shape_and_a_batch_of_32(cuda_device):
    """Proposal's call (one image, 6,000 forced candidates at 0.7), and
    32 images of 1,000 candidates with mixed valid counts, 0 among them."""
    rs = np.random.RandomState(13)
    boxes, cls, valid = _case(rs, 1, 6000, "random", [6000])
    keep = _check(cuda_device, boxes * 0.3, cls * 0, valid, 0.7, True)
    assert 0 < keep.sum() < 6000
    nvalid = rs.randint(0, 1001, 32)
    nvalid[[3, 17]] = 0
    nvalid[5] = 1000
    boxes, _, valid = _case(rs, 32, 1000, "random", nvalid)
    _check(cuda_device, boxes * 0.5, _classes(rs, 32, 1000, 20), valid,
           0.5, False)


def test_refusals(cuda_device):
    boxes = torch.rand(1, 4, 4, device=cuda_device)
    cls = torch.zeros(1, 4, dtype=torch.int64, device=cuda_device)
    valid = torch.ones(1, 4, dtype=torch.bool, device=cuda_device)
    with pytest.raises(MXNetError, match="float32"):
        tnms.nms(boxes.double(), cls, valid, 0.5, False)
    with pytest.raises(MXNetError, match="on cpu"):
        tnms.nms(boxes, cls.cpu(), valid, 0.5, False)
    with pytest.raises(MXNetError, match="bool"):
        tnms.nms(boxes, cls, valid.int(), 0.5, False)
    with pytest.raises(MXNetError, match=r"\(B, K, 4\)"):
        tnms.nms(boxes[..., :3], cls, valid, 0.5, False)


def test_a_valid_mask_that_is_not_a_prefix_is_refused(cuda_device):
    """The kernel reads valid as a count of each row's prefix; any other
    mask raises rather than give other bits than nms_plain."""
    boxes = torch.rand(2, 4, 4, device=cuda_device)
    cls = torch.zeros(2, 4, dtype=torch.int64, device=cuda_device)
    valid = torch.tensor([[True, True, False, False],
                          [True, False, True, False]], device=cuda_device)
    before = tnms.nms.launches
    with pytest.raises(MXNetError, match="prefix"):
        tnms.nms(boxes, cls, valid, 0.5, False)
    assert tnms.nms.launches == before


def _op(name, ins, dev, **params):
    op = treg.get(name)
    res = op.fn(*[x.to(dev) for x in ins], **op.normalize_params(params))
    res = res if isinstance(res, tuple) else (res,)
    return [r.cpu() for r in res]


def test_detection_on_the_card_equals_the_cpu(cuda_device):
    rs = np.random.RandomState(5)
    a = 700
    c = rs.uniform(0.1, 0.9, (a, 2))
    wh = rs.uniform(0.05, 0.4, (a, 2))
    anchors = torch.from_numpy(np.concatenate(
        [c - wh / 2, c + wh / 2], -1)[None].astype(np.float32))
    logits = torch.from_numpy(rs.randn(3, 5, a).astype(np.float32))
    ins = [torch.softmax(logits, 1),
           torch.from_numpy((rs.randn(3, 4 * a) * 0.2).astype(np.float32)),
           anchors]
    for force in (False, True):
        (cpu,) = _op("MultiBoxDetection", ins, "cpu", force_suppress=force,
                     threshold=0.2)
        (card,) = _op("MultiBoxDetection", ins, cuda_device,
                      force_suppress=force, threshold=0.2)
        assert torch.equal(card[..., 0], cpu[..., 0])
        torch.testing.assert_close(card, cpu, rtol=1e-6, atol=1e-6)


def test_proposal_and_roi_pooling_on_the_card_equal_the_cpu(cuda_device):
    rs = np.random.RandomState(6)
    k, h, w = 12, 10, 12
    ins = [torch.from_numpy(rs.rand(2, 2 * k, h, w).astype(np.float32)),
           torch.from_numpy((rs.randn(2, 4 * k, h, w) * 0.2).astype(
               np.float32)),
           torch.tensor([[160.0, 192.0, 1.0], [150.0, 180.0, 1.0]])]
    params = dict(rpn_pre_nms_top_n=600, rpn_post_nms_top_n=50)
    cpu = _op("Proposal", ins, "cpu", **params)[0]
    card = _op("Proposal", ins, cuda_device, **params)[0]
    torch.testing.assert_close(card, cpu, rtol=1e-6, atol=1e-4)
    data = torch.from_numpy(rs.randn(2, 16, h, w).astype(np.float32))
    pooled = [_op("ROIPooling", [data, cpu], dev, pooled_size=(7, 7),
                  spatial_scale=1 / 16)[0] for dev in ("cpu", cuda_device)]
    assert torch.equal(pooled[1], pooled[0])


def test_multibox_target_on_the_card_equals_the_cpu(cuda_device):
    rs = np.random.RandomState(7)
    a, g = 900, 6
    c = rs.uniform(0.1, 0.9, (a, 2))
    wh = rs.uniform(0.05, 0.4, (a, 2))
    anchors = torch.from_numpy(np.concatenate(
        [c - wh / 2, c + wh / 2], -1)[None].astype(np.float32))
    label = np.full((3, g, 5), -1.0, np.float32)
    label[:, :4, 1:3] = rs.uniform(0.0, 0.5, (3, 4, 2))
    label[:, :4, 3:5] = label[:, :4, 1:3] + rs.uniform(0.1, 0.5, (3, 4, 2))
    label[:, :4, 0] = rs.randint(0, 4, (3, 4))
    ins = [anchors, torch.from_numpy(label),
           torch.from_numpy(rs.randn(3, 5, a).astype(np.float32))]
    params = dict(negative_mining_ratio=3.0)
    cpu = _op("MultiBoxTarget", ins, "cpu", **params)
    card = _op("MultiBoxTarget", ins, cuda_device, **params)
    assert torch.equal(card[1], cpu[1]) and torch.equal(card[2], cpu[2])
    torch.testing.assert_close(card[0], cpu[0], rtol=0,
                               atol=1e-5 * float(cpu[0].abs().max()))

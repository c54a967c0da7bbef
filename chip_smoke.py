#!/usr/bin/env python3
"""End-to-end check of mxnet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card and nvcc; exits non-zero without a result line when
torch.cuda.is_available() is false or the package is missing. Phases,
each of which exits non-zero on failure:

  1. environment  card name and power limit, torch/CUDA versions, TF32
                  off, the CUDA kernels built from csrc/ (one nvcc per
                  library, started together; the flash forward is three
                  libraries, one a dtype), and with them phase 5's three
                  generated fusion sources (found by binding its nets on
                  the CPU), so that phase 5's binds compile nothing
  2. kernels      each paged-attention kernel against its plain PyTorch
                  version at the serving shapes (B=24 rows, H=16, D=64,
                  P=16, N=1024 pages, Bp in {1, 8, 128}) over float32,
                  bf16 and int8 pools; kernel / plain / library time, the
                  kernel's time also after a clean (read) flush of L2, its
                  lower bound on this card and its share of it, the pages
                  the rows read (and how many are distinct) with their
                  rate, the split's chunk count, and each kernel instance's
                  registers, spills and shared memory (ptxas's report);
                  then batch invariance on the card: a row alone, in a
                  full batch, and at two table widths, bit-identical
  3. serving      DecodedModel at the docs/serving.md width (vocab 32000,
                  d_model 1024, 16 layers, 16 heads, d_ff 4096, max_len
                  2048; random weights from seed 0), max_batch 8, 1024
                  pages, float32 pool, prefix cache and merged step on:
                  10 concurrent greedy requests (prompts of 32..1024
                  tokens, several sharing a 256-token prefix, 64 new
                  tokens each) through submit/stream, each decode step a
                  replayed CUDA graph (two captured a cell at warmup,
                  greedy and sampling). Checks: all finish, the kernel
                  ran n_layers times per decode step, prefix hits > 0,
                  no capture after warmup; torch.profiler over 8
                  requests of 16 tokens (wall, device time, busy share);
                  with the prefix cache off every stream equals the same
                  request served alone; prefix-hit streams equal the
                  cold ones except at a near-tie (top-2 logit gap <
                  1e-3); a short stream equals dense greedy decoding
                  (same near-tie rule). The cache-off model stays open
                  for phase 14
  4. kv dtypes    the same model with int8 and bf16 pools on a shorter
                  script; top-1 agreement with float32 (quant_parity_probe)
  5. codegen      the Executor path of the three fusion-codegen template
                  nets (elementwise, scale_bias_act, reduction) at
                  (4096, 4096): simple_bind + forward + backward against
                  the plain chain under autograd, each template's
                  generated kernel launched; then each kernel against its
                  plain version in float32 and bf16, with its time, bound
                  and plain time
  6. training     Module.fit on Inception-ResNet-v2 at full width and
                  depth (1000 classes, batch 32, 3x299x299, NCHW,
                  float32, TF32 off), SGD lr 0.1 momentum 0.9 wd 1e-4,
                  Xavier(gaussian, in, 2), metrics acc and ce, 10 steps
                  on synthetic data from seed 0. Checks: 40 fusion groups
                  lowered and none fallen back, 40 generated-kernel
                  launches per step, finite loss, moved weights, and the
                  first step's outputs and gradients equal to a bind with
                  MXNET_FUSION_CODEGEN=0 (every group op by op)
  7. train kernels each of the bind's four group kernels (block35,
                  block17, block8, b8_final) against its plain version at
                  the training shapes in float32 and bf16, with its time,
                  bound, plain time and library time (b8_final's kernel
                  and torch.add also in turns after a clean L2 flush,
                  each time's spread beside it)
  8. attention    the long-context path, parallel.attention(impl="flash"):
                  forward and backward at the transformer's shape (8,
                  2048, 8, 64) float32 causal against autograd through
                  attention_reference, and a (1, 16384, 8, 64) causal
                  forward with its peak memory beside the plain
                  version's (the flash kernel launched on this path and
                  counted); then each kernel instance's registers, spills,
                  shared memory and tensor-core instructions (ptxas's
                  report, cuobjdump -sass; fails if a bf16/f16 instance
                  has no HMMA or HGMMA), and the kernel against its plain
                  version at the path's key block (128) at (8, 2048, 8,
                  64) causal and not in float32 and bf16, causal in f16,
                  bf16 causal at block_k 64, (1, 16384, 8, 64) bf16
                  causal, the test shape (2, 64, 4, 16) and Tq != Tk (256
                  vs 1024), with its time, bound (at the tensor-core
                  rate of the inputs' type: bf16/f16, or TF32 for
                  float32, beside the floor of float32's 3xTF32 route,
                  3x those flops), plain time and the time of
                  scaled_dot_product_attention with the same mask
  9. transformer  models.get_transformer at tools/bench_transformer.py's
                  width (d_model 512, 8 heads, d_ff 1024, 4 layers, causal;
                  8,388,608 parameters), batch 8 x 2048 tokens of seeded
                  randn data and labels, Module.bind / init_params(Xavier())
                  / init_optimizer(adam, lr 1e-4, kvstore local), 10 steps
                  of forward_backward + update in float32 (TF32 off).
                  Checks: finite MSE, moved weights, the first step's
                  outputs and gradients equal to a bind of the graph
                  without the pass pipeline (MXNET_GRAPH_PASSES=0), and no
                  flash-kernel launch (the tower's RingAttention op is
                  plain attention on one device, as in the JAX package)
 10. rtc          user device code: Inception-ResNet-v2 at full width with
                  its SoftmaxOutput replaced by the rtc_softmax_ce Custom
                  op (rtc_ops: csrc/rtc/softmax_ce.cu compiled by NVRTC,
                  two launches a step), trained through mx.FeedForward
                  (gpu(0), 1 epoch of 4 batches of 32 seeded 3x299x299
                  images, SGD lr 0.1 momentum 0.9 wd 1e-4, Xavier(), TF32
                  off). Checks: 2 launches a step and 1 a predict batch;
                  the first step against SoftmaxOutput's from the same
                  weights and batch (output 1e-5 of its max, gradients
                  1e-3 of max(the tensor's max, 1e-6 of the net's largest
                  gradient)); save -> load(gpu(0)) -> predict bit-identical;
                  score runs; each source compiled once. Then both head
                  kernels against their plain versions at (32, 1000) and
                  (8192, 32000), the three elementwise bodies
                  (csrc/rtc/elementwise.cu) at 2^26 float32 elements bit
                  for bit, each timed after a dirty and after a clean L2
                  flush beside its library call; the launch floor (an
                  empty kernel through CudaKernel); the head's registers
                  and spills (none allowed) from NVRTC's log; the cold
                  NVRTC compile and the host cost of a push against a
                  torch.mul's; and examples/numpy_ops/custom_softmax.py's
                  numpy CustomOp net through Module.fit on gpu(0)
                  (accuracy > 0.9)
 11. surface      the public surface on the card, with phase 6's trained
                  weights (Inception-ResNet-v2 at full width, dropout 0,
                  batch 32, 3x299x299, TF32 off): the net's forward built
                  op by op from its JSON graph through mx.nd.<op> under
                  autograd.train_section, every argument marked,
                  compute_gradient on the head, then a NAG step through
                  get_updater (two steps timed); the output and every
                  gradient within 1e-3 of each tensor's max of the
                  Executor's bind on the same weights and batch, and
                  BatchNorm's moving statistics as written back within
                  1e-4. Then Module.fit for 2 epochs of 2 batches over
                  PrefetchingIter(NDArrayIter(shuffle, seed=7)) (batches
                  staged through pinned memory) with RMSProp, a
                  CosineScheduler, module_checkpoint with optimizer
                  states, log_train_metric(1) and acc / top-5 / ce: each
                  epoch's order is Philox(key=[7, epoch]).permutation,
                  40 generated-kernel launches a step;
                  Module.load(prefix, 2, load_optimizer_states=True):
                  its updater's states bytes equal the file's, predict
                  of 64 images bit-identical to the trained module's,
                  iter_predict's batches to predict's rows, one more
                  step on both from one batch within 1e-3 of each
                  parameter's max, and after reshape to batch 8 predict
                  within 1e-4 of the batch-32 rows. The examples this
                  slice unblocks (dec_cluster, reinforce_cartpole,
                  sgld_regression, ae_mnist) run under the mxnet_tpu
                  alias on the card, each to its own gate, in one child
                  process started with phase 1's builds (host work) and
                  reaped before phase 2, so no timed part shares the
                  host or the card with it; their results are read here.
                  A summary line before the kernel line
 12. lm           the op library's path: models.get_lstm_lm at the large
                  PTB width of Zaremba et al. 2014 (vocabulary 10000,
                  embedding and 2 LSTM layers of 1500, 35 steps, batch
                  20; 66.0 M parameters; synthetic token ids from seed 0
                  with a learnable pattern) through Module, TF32 off:
                  the cold bind; the first forward_backward at dropout 0
                  against the phase's own plain torch composition (the
                  output and every gradient within 1e-4 of the tensor's
                  max); the RNN op's cuDNN route against its plain
                  version (forward, final states, gradients) in lstm at
                  this width and in gru and bidirectional lstm at 256,
                  each timed; the cost of the blob's weight views
                  against torch.nn.LSTM's packed buffer; Embedding's NaN
                  row for out-of-range ids and argsort/topk tie orders
                  on the card; then 10 SGD steps (lr 1.0, clip 10, the
                  gradient averaged over the batch's tokens) at
                  dropout 0.65: tokens/s, step ms p50/p95 (steps 2-10,
                  each ended by a synchronize), peak memory, the B1/B2
                  launches the pass pipeline made on the graph, and
                  perplexity at steps 1 and 10 (it must fall)
 13. vision       the vision ops and V1 (csrc/nms.cu): SSD at SSD300's
                  input and classes (models.get_ssd_train(num_classes=20)
                  at its own widths, 3x300x300, 117,976 anchors, 295,148
                  parameters, float32, TF32 off). First, at batch 2, the
                  first SGD step on the card against the same step on the
                  CPU (outputs and every gradient within 1e-4 of the
                  tensor's max) and MultiBoxTarget on both (class targets
                  and mask equal but at anchors whose best IoU is within
                  1e-6 of 0.5, loc_target 1e-5 of its max); then 10 SGD
                  steps at batch 32 through Module on seeded images of
                  1-8 bright rectangles, the gradient divided by the
                  first batch's valid anchors (images/s, step p50/p95, peak
                  memory above the bind's base, the mean loc loss at
                  steps 1 and 10, the fusion group's B1 launches, one
                  MultiBoxTarget's device ms); get_ssd_detect with the
                  trained weights at batch 32: output (32, 117,976, 6),
                  the forward's ms (median of 3), V1's ms, launches (one
                  group of every image), bound (the pairs of a kept box
                  and a later candidate of its class, and of every class),
                  scratch (under 256 MB), its segments, the kept rows an
                  image; every
                  keep bit of that counted call held exactly against
                  greedy NMS's defining property, and V1 against
                  nms_plain on image 0's first 4,096 and 16,384
                  candidates (identical keep bits); then Faster R-CNN's
                  Proposal at its defaults on a 600x1000 image's conv5
                  map (28,728 anchors; V1 against nms_plain, its ms
                  and bound) and
                  ROIPooling of its 300 rois to 7x7 over a (1, 512, 38,
                  63) map, card and CPU bit-identical
 14. decode tier  (runs after phase 4, on phase 3's model and its
                  cache-off twin) sampled decoding, speculative
                  decoding, the split tail-prefill grid and drain/resume
                  at the docs/serving.md width, max_batch 8, float32
                  pools. (b) phase 3's 10 prompts at temperature 0.8,
                  top_k 40, top_p 0.95, seeds 1000-1009, 64 new tokens:
                  concurrent on 1024 pages, one at a time, and on a
                  160-page pool that preempts, all equal; the card's
                  Gumbel noise for 8 rows bit-identical to the host's.
                  (e) those 10 sampled and 10 greedy requests on the
                  small pool, drain(timeout=0) after 160 tokens, each
                  handed-off record resumed by admit_resumed on the
                  1024-page model: delivered + resumed equals the
                  uninterrupted stream. (c) K = 4 speculation, a
                  self-draft (gate v: > 1.5 accepted tokens a target
                  step) and a real draft (vocab 32000, d_model 512, 4
                  layers, 8 heads, d_ff 2048, seed 1): greedy streams
                  equal phase 3's target-only ones, B4 launched K x
                  draft layers a target step; the sampled self-draft
                  finishes; on the self-draft engine one step of each
                  family (decode and draft+verify, greedy and sampling)
                  from its graph bit-identical to the same step run
                  eagerly. (d) prefix cache on, merged step off: hits
                  equal the cold streams. Every stream comparison passes
                  where equal or diverging first at a near tie of the
                  cache-off engine's logits (top-2 gap of filtered +
                  Gumbel, or of the logits, < 1e-3, or a preceding mass
                  within 1e-6 of top_p), each divergence counted. A
                  `decode: {...}` summary line before the kernel line

The last two lines of standard output are
one JSON object with every kernel's numbers and one JSON object naming
the device; the summary lines of phases 11, 12, 13 and 14 (`surface:
{...}`, `lm: {...}`, `vision: {...}`, `decode: {...}`) come before them.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

# H100 SXM figures (NVIDIA data sheet): HBM rate and the float32 rate
# outside the tensor cores, the rate the kernels' arithmetic runs at
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# dense bf16/fp16 tensor-core rate: the card's bound for work in those types
BF16_FLOPS_PER_S = 989e12
# dense TF32 tensor-core rate: the card's bound for float32 operands on
# the tensor cores (B6's float32 route, 3xTF32, runs three such products
# for each multiply)
TF32_FLOPS_PER_S = 495e12

# paged attention against its plain version; the generated fusion
# kernels are held to their plain chain by passes.codegen.parity_error
TOL = {"float32": 1e-4, "bf16": 2e-3, "int8": 1e-4}
# fused against op-by-op on the first training step: the fused kernels
# round exactly as the ops do, and cuDNN's weight gradients accumulate
# with atomics in an order that changes from run to run, so each tensor
# agrees to this share of its largest magnitude
TRAIN_PARITY_RTOL = 1e-3
# phase 5's template nets: each argument (CODEGEN_SIDE, CODEGEN_SIDE)
CODEGEN_SIDE = 4096
# a kernel against its library call after a clean flush: this many
# rounds of turns forward and back (B1 at b8_final's shape)
TURN_ROUNDS = 3

TRAIN_BATCH = 32
TRAIN_STEPS = 10
NEAR_TIE = 1e-3

# flash attention against its plain version (which repeats the kernel's
# blockwise rounding of p): the largest absolute difference beyond one ulp
# of the output's type at the element's magnitude, as a share of the plain
# output's largest magnitude. The kernel sums in another order, and each
# version casts its float32 result to the output type once, so where the
# two float32 values straddle a rounding boundary the casts differ by one
# ulp (2^-7 of the element in bf16), whatever the kernel's accuracy.
ATTN_TOL = {"float32": 1e-4, "bf16": 2e-3, "f16": 2e-3}
ATTN_SHAPE = (8, 2048, 8, 64)          # the transformer's (B, T, H, D)
LONG_SHAPE = (1, 16384, 8, 64)
# attention()'s default key block, and so the kernel's key tile on the path
ATTN_BLOCK_K = 128
# the transformer of tools/bench_transformer.py (docstring width, defaults)
TOWER_CFG = dict(d_model=512, num_heads=8, d_ff=1024, num_layers=4)
TOWER_BATCH, TOWER_SEQ, TOWER_STEPS = 8, 2048, 10
# Module against the op-by-op bind on the first step: the same ops on the
# same inputs (the pass pipeline only renames and reorders nodes), so each
# tensor agrees to this share of its largest magnitude
TOWER_PARITY_RTOL = 1e-4

# phase 10: 4 batches of the training shape through FeedForward; the head
# against SoftmaxOutput on the first step: its output within this share
# of the max (the kernel's softmax sums in another order than
# torch.softmax), the gradients within TRAIN_PARITY_RTOL
RTC_BATCHES = 4
RTC_IMAGE = 299
RTC_HEAD_TOL = 1e-5
# the leaves whose gradient is zero analytically: the last block has no
# ReLU, so b8_final_proj_bn's beta adds a per-channel constant that the
# 1x1 head_conv carries linearly into head_conv_bn, whose training-mode
# batch mean removes it. Both heads' readings of it are rounding noise,
# so instead of the relative check each side must be within
# RTC_ZERO_GRAD_TOL of the net's largest gradient; every other leaf is
# held to TRAIN_PARITY_RTOL of its own max
RTC_ZERO_GRAD_LEAVES = ("b8_final_proj_bn_beta",)
RTC_ZERO_GRAD_TOL = 1e-6
# softmax kernel against its plain version (absolute; values are <= 1)
RTC_SOFTMAX_TOL = 1e-6
RTC_VOCAB_SHAPE = (8192, 32000)        # a vocabulary-sized softmax, 1 GB
RTC_ELEMS = 1 << 26                    # 256 MB of float32
RTC_HOST_REPS = 1000                   # in RTC_HOST_ROUNDS turns
RTC_HOST_ROUNDS = 5
# an empty kernel through rtc.CudaKernel: the least time any launch takes
RTC_FLOOR_SRC = ('extern "C" __global__ void launch_floor(const float* x, '
                 'float* out, long long n) {}')

# phase 11: the public surface
SURFACE_IMAGES = 64                       # 2 batches an epoch
SURFACE_IMAGE = 299
SURFACE_EPOCHS = 2
SURFACE_SEED = 7
SURFACE_IMPERATIVE_STEPS = 2
SURFACE_AUX_RTOL = 1e-4
SURFACE_RESHAPE_RTOL = 1e-4
SURFACE_EXAMPLES = [("dec/dec_cluster.py", []),
                    ("reinforcement_learning/reinforce_cartpole.py",
                     ["--batches", "60", "--min-length", "40"]),
                    ("bayesian_methods/sgld_regression.py", []),
                    ("autoencoder/ae_mnist.py", [])]
SURFACE_EXAMPLES_TIMEOUT = 240

# phase 12: the large PTB model of Zaremba, Sutskever & Vinyals (2014),
# "Recurrent Neural Network Regularization": 2 LSTM layers of 1500,
# embedding 1500, 35 steps unrolled, batch 20, dropout 0.65, SGD lr 1.0
# with gradients clipped at 10; vocabulary 10,000 (66.0 M parameters)
LM_CFG = dict(vocab_size=10000, num_embed=1500, num_hidden=1500,
              num_layers=2, seq_len=35)
LM_DROPOUT = 0.65
LM_BATCH = 20
LM_STEPS = 10
# MXNet's clip_gradient clips each element, where the paper clipped the
# gradient's global norm; with Module's default rescale (1 / batch, the
# loss summed over the 35 steps) lr 1.0 diverged by the fourth step in a
# rehearsal at width 200, so the gradient is the mean over the batch's
# tokens
LM_OPT = (("learning_rate", 1.0), ("clip_gradient", 10.0),
          ("rescale_grad", 1.0 / (LM_BATCH * LM_CFG["seq_len"])))
LM_CYCLE = 500          # the synthetic stream's distinct tokens
# Module's first step at dropout 0 against the phase's own composition,
# and the RNN op's cuDNN route against its plain version: float32 with
# TF32 off, summed in other orders, so each tensor agrees to this share
# of its largest magnitude
LM_PARITY_RTOL = 1e-4
# gru and bidirectional lstm are held at this smaller width
LM_SMALL = dict(input_size=256, state_size=256, num_layers=2)
LM_TIME_REPS = 5
LM_DEVICE = "cuda"

# phase 13: SSD300's input and classes (Liu et al. 2016, "SSD: Single
# Shot MultiBox Detector", the model MXNet's example/ssd trains on VOC):
# 3x300x300 images and 20 classes, batch 32, on the JAX package's own SSD
# backbone at its widths (filters 32/64/128, 4 anchors a cell: 117,976
# anchors); SGD with example/ssd's train.py defaults (lr 0.004, momentum
# 0.9, wd 5e-4). The JAX graph's heads sum their loss over the anchors
# (SoftmaxOutput and MakeLoss with no normalization) where example/ssd
# normalizes by the valid count, and at Module's default rescale (1 /
# batch) lr 0.004 diverged by the third step, on the card and in a CPU
# run at batch 2; so, as example/ssd does, the gradient is divided by the
# anchors the loss counts (positives and mined negatives, class target
# >= 0), counted in the first batch's targets
SSD_CLASSES = 20
SSD_IMAGE = 300
SSD_ANCHORS = 4 * sum((SSD_IMAGE >> i) ** 2 for i in (1, 2, 3))
SSD_BATCH = 32
SSD_STEPS = 10
SSD_GT_ROWS = 16              # label rows an image, 1-8 of them boxes
SSD_OPT = (("learning_rate", 0.004), ("momentum", 0.9), ("wd", 5e-4))
SSD_SEED = 13
# the card against the CPU at batch 2, through the port: MultiBoxTarget's
# loc_target within this share of its max (log on two libms), its class
# targets and mask equal except at anchors whose best IoU lies within
# SSD_NEAR_HALF of the 0.5 threshold; the first step's outputs and
# gradients (float32, TF32 off, summed in other orders) within
# SSD_PARITY_RTOL of each tensor's max
SSD_PARITY_BATCH = 2
SSD_TARGET_TOL = 1e-5
SSD_NEAR_HALF = 1e-6
SSD_PARITY_RTOL = 1e-4
SSD_FORWARD_REPS = 3
# V1 against nms_plain on image 0's first sorted candidates
NMS_CHECK_K = (4096, 16384)
# the full-shape check of V1 takes an image's candidates against its kept
# boxes this many rows at a time (about 2 GB of float32 temporaries at
# 2,800 kept boxes)
NMS_CHECK_ROWS = 32768
# float operations each (kept box, later valid box) pair needs for the
# overlap test alone (csrc/nms.cu: 4 max/min, 2 subtractions, 2 clamps,
# 1 product, 1 test): V1's bound
NMS_PAIR_OPS = 10
# V1's scratch at the detection must stay under this (no K x K mask)
NMS_SCRATCH_LIMIT = 256 << 20
# where phase 13 saves the detection's and Proposal's V1 arguments when
# set (tools/bench_kernels.py nms sets it, then reads them)
NMS_SAVE = None
# Faster R-CNN's RPN at the reference's defaults (Proposal's own: pre
# 6000, post 300, threshold 0.7, stride 16, scales 4-32, ratios
# 0.5/1/2) on a 600x1000 image's VGG-16 conv5 map (38x63, 512 channels)
RPN_MAP = (38, 63)
RPN_IM_INFO = (600.0, 1000.0, 1.0)
RPN_CHANNELS = 512
ROI_POOLED = (7, 7)
VISION_REPS = 5
VISION_DEVICE = "cuda"

SERVE_CFG = dict(vocab=32000, d_model=1024, n_layers=16, n_heads=16,
                 d_ff=4096, max_len=2048)


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# ------------------------------------------------------------ phase 1
def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    check(torch.backends.cuda.matmul.allow_tf32 is False,
          "torch.backends.cuda.matmul.allow_tf32 must be False")
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels

    examples = _start_examples()
    found = {}

    def sources():
        t0 = time.perf_counter()
        found["items"] = _template_sources(mx)
        found["s"] = time.perf_counter() - t0
        return found["items"]

    try:
        secs = kernels.build_all(generated=sources)
        log(f"phase 1 ok: kernels {list(kernels.LIBRARIES)} and phase 5's "
            f"{len(found['items'])} generated sources (found by CPU binds "
            f"in {found['s']!r} s while the libraries compiled) built in "
            f"{secs!r} s")
        examples_res = _finish_examples(examples)
    finally:
        if examples.poll() is None:
            examples.kill()
            examples.communicate()
    log(f"surface: the examples passed on the card beside phase 1's "
        f"builds: {json.dumps(examples_res)}")
    return card, secs, examples_res


# ------------------------------------------------------------ phase 2
def _ptxas_info(report):
    """Registers, spill stores and loads and stack frame of each kernel
    entry in a ptxas -v report (a library's build_report)."""
    info, cur = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
            info[cur] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                      r"stores, (\d+) bytes spill loads", line)
        if m and cur:
            info[cur].update(stack=int(m.group(1)),
                             spill_stores=int(m.group(2)),
                             spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            info[cur]["registers"] = int(m.group(1))
    return info


_PAGED_NAME = re.compile(
    r"paged_split_kernelI(\w+?)Lb[01]ELi(\d+)ELi\d+ELi\d+ELi(\d+)E")
_PAGED_TYPES = {"f": "float32", "13__nv_bfloat16": "bf16", "a": "int8"}


def _paged_instances(torch, attention):
    """Each B4/B5 kernel in the built library: the split kernel's
    serving and generic instance for each page type, and the merge, with
    ptxas's registers, spills and stack; the serving instances' heads a
    block, stages and dynamic shared memory as the library reports
    them."""
    from mxnet_tpu_torch import kernels

    report = kernels.build_report("paged_attention")
    check(report is not None, "no ptxas report for paged_attention")
    dtypes = {"float32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}
    out = {}
    for fn, r in _ptxas_info(report).items():
        m = _PAGED_NAME.search(fn)
        if m:
            kv, serving = _PAGED_TYPES[m.group(1)], int(m.group(2)) > 0
            key = f"{kv} {'serving' if serving else 'generic'}"
            row = {"stages": int(m.group(3)), **r}
            if serving:
                inst = attention.kernel_instance(dtypes[kv], 16, 64, 16)
                check(inst["serving"] and inst["stages"] == row["stages"],
                      f"paged instance {key}: {inst} vs {fn}")
                row.update(heads_per_block=inst["heads_per_block"],
                           smem_bytes=inst["smem_bytes"])
        elif "paged_merge_kernel" in fn:
            key, row = "merge", dict(r)
        else:
            continue
        out[key] = row
        log(f"paged instance {key:16s}: {row.get('registers')} registers, "
            f"{row.get('spill_stores')} B spill stores, "
            f"{row.get('spill_loads')} B spill loads, {row.get('stack')} B "
            f"stack, {row.get('stages', '-')} stages, "
            f"{row.get('smem_bytes', '-')} B shared")
    check(len(out) == 7, f"paged instances in the report: {sorted(out)}")
    return out


def _batch_invariance(torch, attention, quant, dev):
    """A row's output on the card is bit-identical alone and in a full
    batch of 24, at two table widths: one chunk (8 pages, written by the
    split kernel) at Bp 8 and 128, and 40 pages (five chunks, merged) at
    Bp 64 and 128; per page type. Fails on any difference."""
    g = torch.Generator(device=dev).manual_seed(11)
    b, h, d, p, n = 24, 16, 64, 16, 256
    q = torch.randn(b, h, d, generator=g, device=dev)
    k = torch.randn(n, p, h, d, generator=g, device=dev)
    v = torch.randn(n, p, h, d, generator=g, device=dev)
    others = torch.randint(1, n, (b - 1, 128), generator=g, device=dev,
                           dtype=torch.int32)
    other_len = torch.randint(1, 128 * p + 1, (b - 1,), generator=g,
                              device=dev, dtype=torch.int32)
    checked = 0
    for kv in ("float32", "bf16", "int8"):
        if kv == "int8":
            kq, ks, _ = quant.quantize_values(k)
            vq, vs, _ = quant.quantize_values(v)
            kp, vp = quant.KVPool(kq, ks), quant.KVPool(vq, vs)
        else:
            dt = torch.bfloat16 if kv == "bf16" else torch.float32
            kp, vp = quant.KVPool(k.to(dt)), quant.KVPool(v.to(dt))
        for pages, widths in ((8, (8, 128)), (40, (64, 128))):
            ids = torch.randint(1, n, (pages,), generator=g, device=dev,
                                dtype=torch.int32)
            for length in ((pages - 1) * p + 1, pages * p):
                outs = []
                for bp in widths:
                    table = torch.zeros((1, bp), dtype=torch.int32,
                                        device=dev)
                    table[0, :pages] = ids
                    ln = torch.tensor([length], dtype=torch.int32,
                                      device=dev)
                    outs.append(attention.paged_attention(
                        q[:1], kp, vp, table, ln)[0])
                    table = torch.cat([table, others[:, :bp]])
                    ln = torch.cat([ln, other_len.clamp(max=bp * p)])
                    outs.append(attention.paged_attention(
                        q, kp, vp, table, ln)[0])
                for o in outs[1:]:
                    check(torch.equal(o, outs[0]),
                          f"batch invariance {kv}: a row of {length} "
                          f"tokens differs across batches/widths {widths} "
                          f"(max {(o - outs[0]).abs().max().item()!r})")
                checked += len(outs)
    log(f"batch invariance: {checked} outputs over float32, bf16 and int8 "
        "bit-identical alone, in a batch of 24 and across table widths")
    return checked


def _kernel_case(torch, quant, kv, bp, seed, dev, b=24, h=16, d=64,
                 p=16, n=1024):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, h, d, generator=g, device=dev)
    k = torch.randn(n, p, h, d, generator=g, device=dev)
    v = torch.randn(n, p, h, d, generator=g, device=dev)
    table = torch.randint(1, n, (b, bp), generator=g, device=dev,
                          dtype=torch.int32)
    lengths = torch.randint(1, bp * p + 1, (b,), generator=g, device=dev,
                            dtype=torch.int32)
    lengths[-1] = 0          # all-masked row: uniform over Bp*P positions
    if kv == "int8":
        kq, ks, _ = quant.quantize_values(k)
        vq, vs, _ = quant.quantize_values(v)
        kp, vp = quant.KVPool(kq, ks), quant.KVPool(vq, vs)
    else:
        dt = torch.bfloat16 if kv == "bf16" else torch.float32
        kp, vp = quant.KVPool(k.to(dt)), quant.KVPool(v.to(dt))
    return q, kp, vp, table, lengths


def _bound(q, kp, table, lengths, p):
    """Least time for the work these inputs need: every page a row
    uses read once (K and V, plus scale planes), q, table and lengths
    read once, out written once; 4*D flops per (position, head)."""
    b, h, d = q.shape
    bp = table.shape[1]
    tab = table.cpu().numpy()
    lens = lengths.cpu().numpy()
    used, positions = set(), 0
    for row in range(b):
        n_pages = min(-(-int(lens[row]) // p), bp) if lens[row] > 0 else bp
        used.update(tab[row, :n_pages].tolist())
        positions += n_pages * p
    page_elems = p * h * d
    nbytes = 2 * len(used) * page_elems * kp.data.element_size()
    if kp.scale is not None:
        nbytes += 2 * len(used) * p * h * 4
    nbytes += (q.numel() * 4 + tab.size * 4 + lens.size * 4
               + q.numel() * 4)
    flops = positions * h * 4 * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def _page_refs(kp, table, lengths):
    """(pages the rows read, distinct pages among them, bytes of K and V
    pages, scale planes included, the rows read): what the kernel's
    copies move, where the bound counts each distinct page once."""
    p = kp.data.shape[1]
    tab = table.cpu().numpy()
    lens = lengths.cpu().numpy()
    refs, used = 0, set()
    for row in range(tab.shape[0]):
        n = (min(-(-int(lens[row]) // p), tab.shape[1]) if lens[row] > 0
             else tab.shape[1])
        refs += n
        used.update(tab[row, :n].tolist())
    page = kp.data[0].numel() * kp.data.element_size()
    if kp.scale is not None:
        page += kp.scale[0].numel() * 4
    return refs, len(used), 2 * refs * page


def _time_ms(torch, fn, flush, reps=20, clean=False):
    """Mean device time of one call of fn with a cold L2: the calls are
    queued behind a GPU sleep (so the host's launch overhead is not on
    the device's clock), each after a 128 MB write that flushes L2, and
    each timed with its own pair of CUDA events. The write leaves L2
    dirty, so fn's first reads also write back up to 50 MB of the flush;
    `clean` flushes by reading the 128 MB instead (L2 holds clean lines,
    and fn's time is its own traffic)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    sink = torch.empty((), dtype=flush.dtype, device=flush.device)
    torch.cuda._sleep(50_000_000)     # ~25 ms of spinning: the host runs ahead
    for start, end in pairs:
        if clean:
            torch.sum(flush, dim=0, out=sink)
        else:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def phase_kernels(torch):
    from mxnet_tpu_torch.decoding import attention, quant

    dev = torch.device("cuda")
    instances = _paged_instances(torch, attention)
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    rows = []
    for kv in ("float32", "bf16", "int8"):
        for bp in (1, 8, 128):
            q, kp, vp, table, lengths = _kernel_case(
                torch, quant, kv, bp, seed=bp, dev=dev)
            args = (q, kp, vp, table, lengths)
            out = attention.paged_attention(*args)
            torch.cuda.synchronize()
            ref = attention.paged_attention_plain(*args)
            err = (out - ref).abs().max().item()
            check(torch.isfinite(out).all().item(),
                  f"kernel {kv} Bp={bp}: non-finite output")
            check(err <= TOL[kv],
                  f"kernel {kv} Bp={bp}: max abs err {err!r} > {TOL[kv]}")
            ms = _time_ms(torch, lambda: attention.paged_attention(*args),
                          flush)
            ms_clean = _time_ms(
                torch, lambda: attention.paged_attention(*args), flush,
                clean=True)
            plain_ms = _time_ms(
                torch, lambda: attention.paged_attention_plain(*args),
                flush)
            # library yardstick: SDPA over the context gathered (and
            # dequantized) beforehand; the gather is not in its time
            b, h, d = q.shape
            t = bp * kp.data.shape[1]
            kc = quant.gather_ctx(kp, table).reshape(b, t, h, d)
            vc = quant.gather_ctx(vp, table).reshape(b, t, h, d)
            kc, vc = kc.transpose(1, 2).contiguous(), \
                vc.transpose(1, 2).contiguous()
            mask = torch.where(
                torch.arange(t, device=dev)[None, :] < lengths[:, None],
                0.0, attention.NEG_INF).to(torch.float32)[:, None, None, :]
            qs = q[:, :, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_out = sdpa(qs, kc, vc, attn_mask=mask)[:, :, 0]
            lib_err = (lib_out - ref).abs().max().item()
            lib_ms = _time_ms(torch, lambda: sdpa(qs, kc, vc,
                                                  attn_mask=mask), flush)
            bound_ms, bound_by, nbytes = _bound(q, kp, table, lengths,
                                                kp.data.shape[1])
            inst = instances[f"{kv} serving"]
            chunks = -(-bp // attention.CHUNK_PAGES)
            refs, distinct, ref_bytes = _page_refs(kp, table, lengths)
            row = {"kv": kv, "bp": bp, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_max_abs_err": lib_err, "bound_ms": bound_ms,
                   "bound_by": bound_by, "bytes": nbytes,
                   "bound_share": bound_ms / ms, "ms_clean_l2": ms_clean,
                   "bound_share_clean_l2": bound_ms / ms_clean,
                   "chunks": chunks, "page_refs": refs,
                   "distinct_pages": distinct, "ref_bytes": ref_bytes,
                   "ref_tb_per_s_clean_l2": ref_bytes / ms_clean / 1e9,
                   "registers": inst["registers"],
                   "spill_bytes": inst["spill_stores"] + inst["spill_loads"],
                   "smem_bytes": inst["smem_bytes"]}
            rows.append(row)
            log(f"kernel {kv:7s} Bp={bp:3d}: err {err!r} ms {ms!r} "
                f"plain_ms {plain_ms!r} library_ms {lib_ms!r} bound_ms "
                f"{bound_ms!r} ({bound_by}, {nbytes} B) share of bound "
                f"{row['bound_share']!r}; after a clean flush ms "
                f"{ms_clean!r} share {row['bound_share_clean_l2']!r}; "
                f"the rows read {refs} pages ({distinct} distinct, "
                f"{ref_bytes} B: {row['ref_tb_per_s_clean_l2']!r} TB/s "
                f"after a clean flush); "
                f"{chunks} chunk(s), "
                f"{inst['registers']} registers, {row['spill_bytes']} B "
                f"spills, {inst['smem_bytes']} B shared")
            del q, kp, vp, table, lengths, kc, vc, mask, args
    del flush
    torch.cuda.empty_cache()
    _batch_invariance(torch, attention, quant, dev)
    torch.cuda.empty_cache()
    log("phase 2 ok: kernels agree with the plain version and are batch "
        "invariant")
    return rows


# ------------------------------------------------------------ phase 3
def _empty_cache(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _serve_concurrent(model, prompts, max_new, samplings=None):
    """Stream every prompt from its own thread (request i with
    samplings[i] when given); returns (streams, time to first token per
    request, wall seconds)."""
    n = len(prompts)
    streams, ttft, errors = [None] * n, [None] * n, []

    def run(i):
        try:
            t0 = time.perf_counter()
            toks = []
            for tok in model.stream(prompts[i], max_new_tokens=max_new,
                                    timeout=600, sampling=None
                                    if samplings is None else samplings[i]):
                if not toks:
                    ttft[i] = time.perf_counter() - t0
                toks.append(tok)
            streams[i] = toks
        except Exception as e:  # reported below, fails the phase
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(900)
    wall = time.perf_counter() - t0
    check(not errors, "; ".join(errors))
    check(all(s is not None for s in streams), "a request did not finish")
    return streams, ttft, wall


def _serve_script(seed, vocab, shared_len, specs):
    rs = np.random.RandomState(seed)
    shared = rs.randint(2, vocab, size=shared_len).tolist()
    prompts = []
    for kind, total in specs:
        if kind == "shared":
            prompts.append(shared + rs.randint(
                2, vocab, size=total - shared_len).tolist())
        else:
            prompts.append(rs.randint(2, vocab, size=total).tolist())
    return prompts


def _next_logits(engine, ctx):
    """Logits of the token after `ctx` on a quiet engine, without
    changing its pools beyond the pages it allocates and frees."""
    from mxnet_tpu_torch.decoding.blocks import pages_needed
    from mxnet_tpu_torch.serving.batcher import pick_bucket

    need = pages_needed(len(ctx), engine.page_size)
    table = engine.allocator.alloc(need)
    try:
        engine.prefill(ctx[:-1], table)
        width = pick_bucket(need, engine.page_buckets)
        tbl = np.zeros((1, width), np.int32)
        tbl[0, :need] = table
        return engine.probe_logits(
            np.asarray([ctx[-1]], np.int32), tbl,
            np.asarray([len(ctx) - 1], np.int32), np.asarray([True]))[0]
    finally:
        engine.allocator.free(table)


def _device_time(torch, prof, wall_us, top, label):
    """Device busy time of a profiled window, logged with its top
    kernels: the summed time of the events that ran on the card
    (kernels, copies, sets), not of the host operators that launched
    them, whose device time would count the same kernels again."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0]
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    out = {"wall_us": wall_us, "device_us": busy_us,
           "busy_share": busy_us / wall_us,
           "top": [{"name": n[:80], "device_us": t, "count": c}
                   for n, t, c in rows[:top]]}
    log(f"profile: {label} {wall_us!r} us, device busy {busy_us!r} us "
        f"({out['busy_share']!r})")
    for r in out["top"]:
        log(f"profile:   {r['device_us']!r:>12} us  x{r['count']:<6} "
            f"{r['name']}")
    return out


def _profile_window(torch, model, prompts):
    """torch.profiler over 8 concurrent requests of 16 new tokens on a
    warm model: device busy share of the window, the kernels with the
    most device time, and the host seconds of the window's calls into
    the engine: prefill (eager) and decode steps (graphs on the card)."""
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    eng = model.engine
    spent = {"prefill": 0.0, "step": 0.0}

    def timed(name):
        fn = getattr(eng, name)

        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    eng.prefill, eng.step = timed("prefill"), timed("step")
    try:
        with torch.profiler.profile(activities=act) as prof:
            t0 = time.perf_counter()
            _serve_concurrent(model, prompts, 16)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        del eng.prefill, eng.step
    out = _device_time(torch, prof, wall_us, 12, "window")
    out["prefill_us"] = spent["prefill"] * 1e6
    out["steps_us"] = spent["step"] * 1e6
    log(f"profile: the window's prefill calls {out['prefill_us']!r} us, "
        f"its decode steps {out['steps_us']!r} us (host clock)")
    return out


def _top2_gap(logits):
    top = np.sort(np.asarray(logits, np.float64))[-2:]
    return float(top[1] - top[0])


def _first_divergence(a, b):
    for j, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return j
    return None if len(a) == len(b) else min(len(a), len(b))


def phase_serving(torch, decoder, cfg, dev):
    from mxnet_tpu_torch import decoding as dec
    from mxnet_tpu_torch.decoding import attention

    specs = [("cold", 32), ("shared", 288), ("cold", 64),
             ("shared", 320), ("shared", 512), ("cold", 128),
             ("shared", 700), ("cold", 1024), ("shared", 1000),
             ("cold", 400)]
    prompts = _serve_script(1, cfg.vocab, 256, specs)
    max_new = 64
    res = {}

    # (a) prefix cache and merged step on: the main path
    t0 = time.perf_counter()
    model = dec.DecodedModel("lm", 1, decoder, cfg, max_batch=8,
                             num_pages=1024, kv_dtype="float32",
                             device=dev)
    res["warmup_s"] = time.perf_counter() - t0
    res["warmup_grid"] = grid = model.engine.trace_counts()
    res["captures"] = model.engine.traces()
    log(f"serving: warmup {res['warmup_s']!r} s, grid "
        f"{len(res['warmup_grid'])} shapes ({res['captures']} captures "
        f"and first calls), step rows {model.engine.step_rows}, buckets "
        f"{model.engine.page_buckets}")
    if torch.device(dev).type == "cuda":
        # each decode cell's two CUDA graphs (greedy, sampling)
        check(all(grid[f"decode@{b}"] == 2
                  for b in model.engine.page_buckets),
              f"decode cells not captured twice each: {grid}")
    attention.reset_launch_counts()
    hot, ttft, wall = _serve_concurrent(model, prompts, max_new)
    launches = attention.launch_counts()
    snap = model.stats.snapshot()
    # the busy share of a window of the graphed step (every run; PR 6's
    # eager step read 13.3% on the same window)
    res["profile"] = _profile_window(torch, model, prompts[:8])
    check(model.stats.snapshot()["traces_since_warmup"] == 0,
          "the profile window captured a graph")
    model.close()
    steps = snap["steps"]
    res.update({"launches": launches, "steps": steps, "stats": snap,
                "wall_s": wall, "ttft_s": ttft})
    check(launches["paged_attention_float"] == cfg.n_layers * steps,
          f"kernel launches {launches} != n_layers x steps "
          f"{cfg.n_layers} x {steps}")
    check(launches["paged_attention_float"] > 0, "the kernel never ran")
    check(snap["prefix_hits"] > 0, "no prefix-cache hit")
    check(snap["traces_since_warmup"] == 0,
          f"traces_since_warmup {snap['traces_since_warmup']}")
    check(snap["completed"] == len(prompts) and snap["failed"] == 0,
          f"completed {snap['completed']} failed {snap['failed']}")
    n_tok = sum(len(s) for s in hot)
    res["e2e_tokens_per_s"] = n_tok / wall
    log(f"serving: {len(prompts)} requests, {n_tok} tokens in {wall!r} s "
        f"({res['e2e_tokens_per_s']!r} tok/s end to end), "
        f"{steps} steps, launches {launches}, decode_tokens_per_s "
        f"{snap['decode_tokens_per_s']!r}, p50 token ms "
        f"{snap['p50_token_ms']!r}, ttft p50 "
        f"{float(np.median(ttft))!r} s, prefix hits "
        f"{snap['prefix_hits']} pages reused {snap['prefix_pages_reused']}")
    log("serving: pool " + json.dumps(
        {k: snap[k] for k in ("pages_total", "pages_free", "kv_occupancy",
                              "free_low_watermark", "pages_allocated",
                              "kv_dtype", "kv_bytes_per_token",
                              "pool_capacity_tokens")}))
    del model
    _empty_cache(torch, dev)

    # (b) prefix cache off: concurrent streams equal streams served alone
    cold_model = dec.DecodedModel("lm-cold", 1, decoder, cfg, max_batch=8,
                                  num_pages=1024, kv_dtype="float32",
                                  prefix_cache=False, device=dev)
    cold, _, _ = _serve_concurrent(cold_model, prompts, max_new)
    alone = [cold_model.generate(p, max_new_tokens=max_new, timeout=600)
             for p in prompts]
    check(cold_model.stats.snapshot()["traces_since_warmup"] == 0,
          "cache-off model left the warmed grid")
    for i, (c, a) in enumerate(zip(cold, alone)):
        check(c == a, f"request {i}: concurrent stream != served alone "
              f"(first divergence at {_first_divergence(c, a)})")
    log("serving: cache-off concurrent streams equal streams served alone")

    # (c) prefix-hit streams against cold streams: equal, or diverging
    # first at a near-tie of the cold run's logits
    engine = cold_model.engine
    agree, ties = [], []
    for i, (h, c) in enumerate(zip(hot, cold)):
        j = _first_divergence(h, c)
        same = sum(int(x == y) for x, y in zip(h, c))
        agree.append(same / max(len(c), 1))
        if j is None:
            continue
        gap = _top2_gap(_next_logits(engine, prompts[i] + c[:j]))
        ties.append({"request": i, "position": j, "top2_gap": gap})
        check(gap < NEAR_TIE,
              f"request {i}: prefix-hit stream diverges from the cold "
              f"one at {j} with top-2 gap {gap!r} >= {NEAR_TIE}")
    res["hit_vs_cold_agreement"] = agree
    res["hit_vs_cold_divergences"] = ties
    log(f"serving: prefix-hit vs cold token agreement {agree}, "
        f"divergences {ties}")

    # (d) a short stream against dense greedy decoding (reference_logits)
    n_ref = 16
    toks, ref, gaps = list(prompts[0]), [], []
    for _ in range(n_ref):
        lg = dec.reference_logits(engine.model, [toks], cfg)[0, -1]
        lg = lg.float().cpu().numpy()
        gaps.append(_top2_gap(lg))
        ref.append(int(lg.argmax()))
        toks.append(ref[-1])
    check(np.isfinite(lg).all(), "non-finite reference logits")
    j = _first_divergence(cold[0][:n_ref], ref)
    check(j is None or gaps[j] < NEAR_TIE,
          f"served stream diverges from dense greedy at {j} "
          f"(top-2 gap {gaps[j] if j is not None else None!r})")
    res["dense_reference_divergence"] = j
    log(f"serving: first {n_ref} tokens vs dense greedy: "
        f"{'equal' if j is None else f'near-tie divergence at {j}'}")
    res.update(prompts=prompts, cold=cold)
    log("phase 3 ok: serving at full width")
    # the cache-off model stays open: phase 14 serves on it
    return res, hot, cold_model


# ------------------------------------------------------------ phase 4
def phase_kv_dtypes(torch, decoder, cfg, dev):
    from mxnet_tpu_torch import decoding as dec
    from mxnet_tpu_torch.decoding import attention

    specs = [("cold", 48), ("shared", 160), ("shared", 200),
             ("cold", 96)]
    prompts = _serve_script(2, cfg.vocab, 128, specs)
    buckets = (1, 2, 4, 8, 16)
    res = {}
    for kv, kernel in (("int8", "paged_attention_int8"),
                       ("bf16", "paged_attention_float")):
        model = dec.DecodedModel(f"lm-{kv}", 1, decoder, cfg, max_batch=8,
                                 num_pages=1024, page_buckets=buckets,
                                 kv_dtype=kv, device=dev)
        attention.reset_launch_counts()
        streams, _, wall = _serve_concurrent(model, prompts, 32)
        launches = attention.launch_counts()
        snap = model.stats.snapshot()
        model.close()
        del model
        check(launches[kernel] == cfg.n_layers * snap["steps"]
              and launches[kernel] > 0,
              f"{kv}: launches {launches} != n_layers x steps "
              f"{cfg.n_layers} x {snap['steps']}")
        check(snap["traces_since_warmup"] == 0 and snap["failed"] == 0,
              f"{kv}: traces_since_warmup "
              f"{snap['traces_since_warmup']} failed {snap['failed']}")
        probe = dec.quant_parity_probe(
            decoder, cfg, prompts[1], max_new=32, kv_dtype=kv,
            num_pages=64, page_buckets=buckets, device=dev)
        check(probe["retraces"] == 0, f"{kv}: probe retraced")
        _empty_cache(torch, dev)
        res[kv] = {"launches": launches, "steps": snap["steps"],
                   "wall_s": wall,
                   "decode_tokens_per_s": snap["decode_tokens_per_s"],
                   "kv_bytes_per_token": snap["kv_bytes_per_token"],
                   "top1_agreement": probe["top1_agreement"],
                   "logit_drift_max": probe["logit_drift_max"],
                   "kv_pool_capacity_ratio":
                       probe["kv_pool_capacity_ratio"]}
        log(f"kv {kv}: {len(prompts)} requests, {snap['steps']} steps, "
            f"launches {launches}, top-1 agreement with float32 "
            f"{probe['top1_agreement']!r} over "
            f"{probe['positions_compared']} positions, logit drift max "
            f"{probe['logit_drift_max']!r}, capacity ratio "
            f"{probe['kv_pool_capacity_ratio']!r}")
    log("phase 4 ok: int8 and bf16 pools")
    return res


# ----------------------------------------------------------- phase 14
# the request mix of phase 14(b): docs/serving.md's "Sampling" example
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95)
SAMPLE_SEED = 1000                # request i draws from seed 1000 + i
SPEC_K = 4
# the real draft: docs/serving.md names no draft width; this one (a
# quarter of the target's layers and half its width, the target's
# vocabulary and context) is the decode tier's own choice
DRAFT_CFG = dict(vocab=32000, d_model=512, n_layers=4, n_heads=8,
                 d_ff=2048, max_len=2048)
SMALL_POOL = 160                  # pages: phase 3's script preempts here
DECODE_DEVICE = "cuda"
DRAIN_AFTER = 160                 # tokens delivered before drain()
NEAR_TIE_MASS = 1e-6


def _samplings(n):
    from mxnet_tpu_torch.decoding import SamplingParams

    return [SamplingParams(seed=SAMPLE_SEED + i, **SAMPLED)
            for i in range(n)]


def _draw_margins(logits, sp, position):
    """(top-2 gap, distance of a preceding mass to top_p) of the draw at
    `position` from these logits (host float32): the top-2 gap of
    filtered + g for a sampled request, of the logits for a greedy one
    (mass distance inf)."""
    import torch

    from mxnet_tpu_torch.decoding import sampling as samp

    if sp is None or sp.temperature <= 0:
        return _top2_gap(logits), float("inf")
    scaled = torch.from_numpy(np.asarray(logits, np.float32)) / \
        sp.temperature
    filt = samp.filter_logits(scaled, sp.top_k, sp.top_p)
    g = samp.gumbel(samp.stream_key(sp.seed, position, samp.SALT_TOKEN),
                    scaled.shape[-1])
    desc = np.sort(scaled.double().numpy())[::-1]
    e = np.exp(desc - desc[0])
    probs = e / e.sum()
    before = np.cumsum(probs) - probs
    return (_top2_gap((filt + g).numpy()),
            float(np.abs(before - sp.top_p).min()))


def _divergences(engine, prompts, got, want, samplings, label):
    """The first divergence of each pair of streams, each of which must
    be a near tie of the cache-off engine's logits (the top-2 gap under
    NEAR_TIE, or a preceding mass within NEAR_TIE_MASS of top_p);
    returns them, counted and logged."""
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        j = _first_divergence(a, b)
        if j is None:
            continue
        sp = samplings[i] if samplings else None
        ctx = prompts[i] + list(b[:j])
        gap, margin = _draw_margins(_next_logits(engine, ctx), sp, len(ctx))
        out.append({"request": i, "position": j, "top2_gap": gap,
                    "mass_margin": margin})
        check(gap < NEAR_TIE or margin < NEAR_TIE_MASS,
              f"{label}: request {i} diverges at {j} with top-2 gap "
              f"{gap!r} and mass margin {margin!r}: not a near tie")
    log(f"decode tier: {label}: {len(out)} near-tie divergences of "
        f"{len(got)} streams {out}")
    return out


def _graph_vs_eager(torch, engine, prompts):
    """One step of each family (decode and the draft+verify pair, each
    greedy and sampling) from its graph against the same step run
    eagerly on the same pool state: equal tokens and equal written
    pages. Rows hold phase 3's first prompts, prefilled."""
    from mxnet_tpu_torch.decoding.blocks import pages_needed
    from mxnet_tpu_torch.serving.batcher import pick_bucket

    rows, p = engine.max_batch, engine.page_size
    ps = prompts[:rows]
    tables = [engine.allocator.alloc(pages_needed(len(x) + SPEC_K + 1, p))
              for x in ps]
    try:
        last = [engine.prefill(x, t[:pages_needed(len(x), p)])
                for x, t in zip(ps, tables)]
        bucket = pick_bucket(max(len(t) for t in tables),
                             engine.page_buckets)
        table = np.zeros((rows, bucket), np.int32)
        for r, t in enumerate(tables):
            table[r, :len(t)] = t
        lengths = np.asarray([len(x) for x in ps], np.int32)
        step_rows = (np.asarray(last, np.int32), table, lengths,
                     np.ones((rows,), bool))
        sps = _samplings(rows)
        temps = np.asarray([0.0 if r % 4 == 0 else SAMPLED["temperature"]
                            for r in range(rows)], np.float32)
        samp = (np.asarray([sp.seed for sp in sps], np.uint32), temps,
                np.full((rows,), SAMPLED["top_k"], np.int32),
                np.full((rows,), SAMPLED["top_p"], np.float32))
        written = torch.as_tensor(np.unique(np.concatenate(
            [t[len(x) // p:] for x, t in zip(ps, tables)])),
            device=engine.device)
        out = {}
        for family in ("decode", "spec"):
            for sampled in (False, True):
                sarr = samp if sampled else \
                    samp[:1] + (np.zeros_like(temps),) + samp[2:]

                def step():
                    if family == "spec":
                        return engine.spec_step(*step_rows,
                                                np.ones((rows,), bool),
                                                *sarr)
                    return (engine.step(*step_rows, *sarr),)

                with engine.eager():
                    eager = step()
                pages = [pool.data[:, written].clone()
                         for pool in (engine._k, engine._v)]
                graphed = step()
                same = all(np.array_equal(a, b)
                           for a, b in zip(eager, graphed)) and all(
                    torch.equal(a, pool.data[:, written])
                    for a, pool in zip(pages, (engine._k, engine._v)))
                key = f"{family}{'_sampled' if sampled else ''}"
                out[key] = same
                check(same, f"{key}: the graphed step differs from the "
                      "eager one")
        log(f"decode tier: graphed vs eager steps bit-identical: {out}")
        return out
    finally:
        for t in tables:
            engine.allocator.free(t)


def _drain_resume(src, dst, prompts, samplings, max_new):
    """Greedy and sampled requests streaming on `src`; drain(timeout=0)
    once DRAIN_AFTER tokens are out; every unfinished request hands off
    and `admit_resumed` on `dst` finishes it. Returns (handed-off
    records, per-request delivered + resumed streams)."""
    from mxnet_tpu_torch.decoding import RequestHandedOff

    n = len(prompts)
    delivered, states, errors = [[] for _ in range(n)], [None] * n, []

    def run(i):
        try:
            for tok in src.stream(prompts[i], max_new_tokens=max_new,
                                  timeout=600, sampling=samplings[i]):
                delivered[i].append(tok)
        except RequestHandedOff as e:
            states[i] = e.state
        except Exception as e:  # reported below, fails the phase
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for th in threads:
        th.start()
    t_end = time.perf_counter() + 300
    while (sum(map(len, delivered)) < DRAIN_AFTER
           and any(th.is_alive() for th in threads)
           and time.perf_counter() < t_end):
        time.sleep(0.005)
    records = src.drain(timeout=0)
    for th in threads:
        th.join(120)
    check(not errors, "; ".join(errors))
    handed = [i for i in range(n) if states[i] is not None]
    check(len(records) == len(handed) > 0,
          f"{len(records)} handoff records for {len(handed)} handed-off "
          "requests")
    full = []
    for i in range(n):
        if states[i] is None:
            full.append(delivered[i])
            continue
        check(states[i]["generated"] == delivered[i],
              f"request {i}: record's tokens are not the delivered ones")
        fut = dst.admit_resumed(states[i])
        full.append(delivered[i] + list(fut.stream(timeout=600)))
    return records, full


def phase_decode_tier(torch, decoder, cfg, serving, hot, cold_model):
    """Phase 14 (module docstring): the decode tier at the docs/serving.md
    width on the graphed step."""
    from mxnet_tpu_torch import decoding as dec
    from mxnet_tpu_torch.decoding import attention
    from mxnet_tpu_torch.decoding import sampling as samp

    prompts, cold = serving["prompts"], serving["cold"]
    max_new = 64
    n = len(prompts)
    sps = _samplings(n)
    res, parts = {}, {}
    quiet = cold_model.engine     # the near-tie oracle: idle between runs
    kw = dict(max_batch=8, num_pages=1024, kv_dtype="float32",
              device=DECODE_DEVICE)

    def part(name, t0):
        parts[name] = time.perf_counter() - t0

    # (b) sampled: the 1024-page pool, the same requests one at a time,
    # a pool small enough to preempt, and the noise against the host's
    t0 = time.perf_counter()
    s_big, ttft, wall = _serve_concurrent(cold_model, prompts, max_new, sps)
    snap = cold_model.stats.snapshot()
    res["sampled"] = {"tokens_per_s": sum(map(len, s_big)) / wall,
                      "ttft_p50_s": float(np.median(ttft)),
                      "p50_token_ms": snap["p50_token_ms"],
                      "p95_token_ms": snap["p95_token_ms"]}
    alone = [cold_model.generate(x, max_new_tokens=max_new, timeout=600,
                                 sampling=sp) for x, sp in zip(prompts, sps)]
    check(cold_model.stats.snapshot()["traces_since_warmup"] == 0,
          "sampled serving captured a graph after warmup")
    small = dec.DecodedModel("lm-small", 1, decoder, cfg,
                             **dict(kw, num_pages=SMALL_POOL),
                             prefix_cache=False)
    s_small, _, _ = _serve_concurrent(small, prompts, max_new, sps)
    small_snap = small.stats.snapshot()
    check(small_snap["preemptions"] > 0, "the small pool preempted nothing")
    check(small_snap["traces_since_warmup"] == 0,
          "the small pool's model captured a graph after warmup")
    res["sampled"]["preemptions_small_pool"] = small_snap["preemptions"]
    res["sampled"]["small_vs_big"] = _divergences(
        quiet, prompts, s_small, s_big, sps, "sampled, small pool vs 1024")
    res["sampled"]["alone_vs_big"] = _divergences(
        quiet, prompts, alone, s_big, sps, "sampled, alone vs concurrent")
    seeds = torch.tensor([sp.seed for sp in sps[:8]])
    pos = torch.tensor([len(x) for x in prompts[:8]])
    host = samp.gumbel(samp.stream_key(seeds, pos, samp.SALT_TOKEN),
                       cfg.vocab)
    dev = torch.device(DECODE_DEVICE)
    card = samp.gumbel(samp.stream_key(seeds.to(dev), pos.to(dev),
                                       samp.SALT_TOKEN), cfg.vocab).cpu()
    check(torch.equal(host.view(torch.int32), card.view(torch.int32)),
          "the card's Gumbel noise differs from the host's")
    res["sampled"]["gumbel_rows_bit_identical"] = 8
    log("decode tier: sampled " + json.dumps(
        {k: v for k, v in res["sampled"].items()
         if k not in ("small_vs_big", "alone_vs_big")}))
    part("sampled", t0)

    # (e) drain and resume: greedy and sampled requests on the small
    # pool's model, handed off mid-decode and finished on the 1024 one
    t0 = time.perf_counter()
    d_prompts = prompts + prompts
    d_samp = [None] * n + sps
    records, full = _drain_resume(small, cold_model, d_prompts, d_samp,
                                  max_new)
    res["drain"] = {"handed_off": len(records),
                    "with_tokens": sum(1 for r in records if r["generated"]),
                    "divergences": _divergences(
                        quiet, d_prompts, full, cold + s_big, d_samp,
                        "drain + resume vs uninterrupted")}
    small.close()
    del small
    part("drain", t0)

    # (c) speculative, K = 4: a self-draft, then a real draft
    t0 = time.perf_counter()
    res["spec"] = {}
    draft_cfg = dec.DecoderConfig(**DRAFT_CFG)
    draft = dec.params_from_jax(dec.init_decoder_params(draft_cfg, seed=1),
                                draft_cfg, torch.device(DECODE_DEVICE))
    for name, spec_kw in (("self", dict(draft="self")),
                          ("real", dict(draft=draft, draft_cfg=draft_cfg))):
        t1 = time.perf_counter()
        model = dec.DecodedModel(f"lm-spec-{name}", 1, decoder, cfg, **kw,
                                 prefix_cache=False, spec_k=SPEC_K,
                                 **spec_kw)
        warm = time.perf_counter() - t1
        dlayers = model.engine.draft_cfg.n_layers
        if name == "self":
            res["graph_vs_eager"] = _graph_vs_eager(torch, model.engine,
                                                    prompts)
        attention.reset_launch_counts()
        streams, ttft, wall = _serve_concurrent(model, prompts, max_new)
        launches = attention.launch_counts()["paged_attention_float"]
        snap = model.stats.snapshot()
        check(launches == SPEC_K * dlayers * snap["steps"],
              f"spec {name}: B4 launches {launches} != K x draft layers x "
              f"steps {SPEC_K} x {dlayers} x {snap['steps']}")
        check(snap["traces_since_warmup"] == 0,
              f"spec {name}: a graph was captured after warmup")
        row = {"warmup_s": warm, "captures": model.engine.traces(),
               "acceptance": snap["spec_acceptance_rate"],
               # gate (v) of ci/check_decode.py: accepted drafts over
               # target steps; and tokens emitted over target steps
               "accepted_per_target_step": snap["spec_accepted"]
               / snap["steps"],
               "tokens_per_target_step": snap["tokens_per_target_step"],
               "b4_launches": launches, "steps": snap["steps"],
               "b4_launches_per_step": launches / snap["steps"],
               "tokens_per_s": sum(map(len, streams)) / wall,
               "ttft_p50_s": float(np.median(ttft)),
               "p50_token_ms": snap["p50_token_ms"],
               "p95_token_ms": snap["p95_token_ms"],
               "vs_target_only": _divergences(
                   quiet, prompts, streams, cold, None,
                   f"speculative {name}-draft greedy vs target-only")}
        if name == "self":
            check(row["accepted_per_target_step"] > 1.5,
                  f"self-draft: {row['accepted_per_target_step']} accepted "
                  "tokens a target step, not > 1.5")
            s_spec, _, _ = _serve_concurrent(model, prompts, max_new, sps)
            snap = model.stats.snapshot()
            check(snap["failed"] == 0 and all(s_spec),
                  "sampled self-draft requests did not finish")
            check(snap["traces_since_warmup"] == 0,
                  "sampled self-draft captured a graph after warmup")
            row["sampled_tokens"] = sum(map(len, s_spec))
        res["spec"][name] = row
        log(f"decode tier: spec {name}-draft " + json.dumps(
            {k: v for k, v in row.items() if k != "vs_target_only"}))
        model.close()
        del model
        _empty_cache(torch, DECODE_DEVICE)
    del draft
    part("speculative", t0)

    # (d) the split grid: prefix cache on, merged step off
    t0 = time.perf_counter()
    split = dec.DecodedModel("lm-split", 1, decoder, cfg, **kw,
                             prefix_cache=True, merged_step=False)
    check(not split.engine.merged_step_enabled, "the split grid is off")
    streams, _, _ = _serve_concurrent(split, prompts, max_new)
    snap = split.stats.snapshot()
    check(snap["prefix_hits"] > 0, "split grid: no prefix-cache hit")
    check(snap["traces_since_warmup"] == 0,
          "split grid: a call outside the warmed grid")
    res["split"] = {"prefix_hits": snap["prefix_hits"],
                    "pages_reused": snap["prefix_pages_reused"],
                    "vs_cold": _divergences(quiet, prompts, streams, cold,
                                            None, "split-grid hits vs cold"),
                    "vs_merged": sum(a == b for a, b in zip(streams, hot))}
    split.close()
    del split
    cold_model.close()
    _empty_cache(torch, DECODE_DEVICE)
    part("split", t0)
    res["parts_s"] = parts
    log("phase 14 ok: the decode tier at full width")
    return res


# ------------------------------------------------------------ phase 5
def _template_nets(mx):
    """The template nets of the JAX package's codegen tests
    (tests/test_pallas_codegen.py:49-68)."""
    sym = mx.sym
    x = sym.Variable("x")
    elem = sym.square(sym.sigmoid(x)) * 0.5
    x, g, b = sym.Variable("x"), sym.Variable("g"), sym.Variable("b")
    sba = sym.Activation(sym.elemwise_add(sym.elemwise_mul(x, g), b),
                         act_type="tanh")
    x, y = sym.Variable("x"), sym.Variable("y")
    red = sym.sum(sym.relu(x) * y)
    return {"elementwise": elem, "scale_bias_act": sba, "reduction": red}


def _template_sources(mx):
    """The generated sources phase 5's binds compile, as (tag, text):
    each template net bound on the CPU at phase 5's shape gives its
    group's spec and signature, and the codegen emits the same text a
    card bind does (its library is named by a digest of the text)."""
    from mxnet_tpu_torch.passes import codegen

    out = []
    for net in _template_nets(mx).values():
        exe = net.simple_bind(mx.cpu(), **{
            n: (CODEGEN_SIDE, CODEGEN_SIDE) for n in net.list_arguments()})
        for group, _ in exe._codegen_plan.fused.values():
            status, emitted = codegen._prepare(
                group.spec, list(group.in_avals), group.digest,
                group.template)
            if status == "emit":
                out.append((f"fusion_{group.template}_{group.digest}",
                            emitted[0]))
    return out


def _group_bound(torch, group, ins):
    """Least time for one launch: each input read once and the output
    written once over the HBM rate, or one float32 operation per op of
    the chain per element over the float32 rate."""
    n = ins[0].numel()
    out_bytes = (int(np.prod(group.out_shape))
                 * torch.finfo(group.out_dtype).bits // 8)
    nbytes = sum(x.numel() * x.element_size() for x in ins) + out_bytes
    flops = n * len(group.spec)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def _library_call(torch, group, ins):
    """One PyTorch call computing the group's function, where there is
    one: `net + s * proj` is torch.add(net, proj, alpha=s)."""
    ops = [op for op, _, _ in group.spec]
    if ops == ["_mul_scalar", "elemwise_add"]:
        (_, mul_p, mul_w), (_, _, add_w) = group.spec
        other = next(w for w in add_w if w[0] == "x")
        alpha = float(mul_p["scalar"])
        return lambda: torch.add(ins[other[1]], ins[mul_w[0][1]],
                                 alpha=alpha)
    return None


def _seeded(torch, avals, seed, dev, dtype=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev,
                        dtype=torch.float32).to(dtype or d)
            for s, d in avals]


def _bf16_twins(torch, passes, groups):
    """The bf16 build of each group, all compiled together (one nvcc a
    source, started at once)."""
    return passes.build_groups(
        [(g.spec, [(s, torch.bfloat16) for s, _ in g.in_avals])
         for g in groups], torch.device("cuda"))


def _turns_clean(torch, fns, flush, rounds=TURN_ROUNDS):
    """Each fn's `_time_ms` after a clean (read) flush, in turns forward
    and back (a, b, b, a, ...): its times, their mean and spread."""
    names = list(fns)
    times = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            times[n].append(_time_ms(torch, fns[n], flush, clean=True))
    return {n: {"ms": t, "mean": sum(t) / len(t), "min": min(t),
                "max": max(t)} for n, t in times.items()}


def _kernel_row(torch, passes, name, group, bf, flush, seed):
    """One group's kernel against its plain version in float32 and, as
    `bf`, bf16 at its bind shapes, with its times and bound."""
    dev = torch.device("cuda")
    row = {"name": name, "digest": group.digest,
           "template": group.template,
           "shapes": [list(s) for s, _ in group.in_avals]}
    ins = _seeded(torch, group.in_avals, seed, dev)
    got = group.kernel(*ins, out_shape=group.out_shape, count=False)
    torch.cuda.synchronize()
    check(torch.isfinite(got).all().item(), f"{name}: non-finite output")
    err, ok = passes.parity_error(group, ins, got)
    check(ok, f"{name} float32: max abs err {err!r} beyond the parity "
          "tolerance (passes.codegen.parity_error)")
    ins_bf = [x.to(torch.bfloat16) for x in ins]
    got_bf = bf.kernel(*ins_bf, out_shape=bf.out_shape, count=False)
    err_bf, ok = passes.parity_error(bf, ins_bf, got_bf)
    check(ok, f"{name} bf16: max abs err {err_bf!r} beyond the parity "
          "tolerance")
    row["ms"] = _time_ms(torch, lambda: group.kernel(
        *ins, out_shape=group.out_shape, count=False), flush)
    row["plain_ms"] = _time_ms(torch, lambda: group.plain_fn(*ins), flush)
    row["bf16_ms"] = _time_ms(torch, lambda: bf.kernel(
        *ins_bf, out_shape=bf.out_shape, count=False), flush)
    lib = _library_call(torch, group, ins)
    row["library_ms"] = None if lib is None else _time_ms(torch, lib, flush)
    if lib is not None:
        row["library_max_abs_err"] = (lib() - got).abs().max().item()
        row["turns_clean_l2"] = _turns_clean(torch, {
            "kernel": lambda: group.kernel(*ins, out_shape=group.out_shape,
                                           count=False),
            "library": lib}, flush)
        log(f"codegen {name}: kernel against its library call after a "
            f"clean flush, in turns: {json.dumps(row['turns_clean_l2'])}")
    row["bound_ms"], row["bound_by"], row["bytes"] = _group_bound(
        torch, group, ins)
    row["bf16_bound_ms"] = _group_bound(torch, bf, ins_bf)[0]
    row["max_abs_err"] = err
    row["bf16_max_abs_err"] = err_bf
    log(f"codegen {name:15s} {group.template:14s} {row['shapes'][0]}: "
        f"err {err!r} bf16 err {err_bf!r} ms {row['ms']!r} plain_ms "
        f"{row['plain_ms']!r} bf16_ms {row['bf16_ms']!r} library_ms "
        f"{row['library_ms']!r} bound_ms {row['bound_ms']!r} "
        f"({row['bound_by']})")
    return row


def phase_codegen(torch, mx, side=CODEGEN_SIDE):
    """The Executor path of the template nets, then their kernels."""
    from mxnet_tpu_torch import passes
    from mxnet_tpu_torch.symbol import _topo

    dev = torch.device("cuda")
    passes.clear_memo()
    nets = _template_nets(mx)
    res, groups = {}, {}
    t0 = time.perf_counter()
    execs = {name: net.simple_bind(mx.gpu(0), **{
        n: (side, side) for n in net.list_arguments()})
        for name, net in nets.items()}
    res["bind_s"] = time.perf_counter() - t0
    stats = passes.fusion_stats()
    check(stats["groups_lowered"] == 3 and stats["groups_fallback"] == 0,
          f"template nets: {stats}")
    passes.reset_launch_counts()
    for seed, (name, exe) in enumerate(execs.items()):
        names = exe._arg_names
        vals = _seeded(torch, [((side, side), torch.float32)] * len(names),
                       100 + seed, dev)
        for n, v in zip(names, vals):
            exe.arg_dict[n][:] = v
        exe.forward(is_train=True)
        exe.backward()
        torch.cuda.synchronize()
        (group, ext), = exe._codegen_plan.fused.values()
        groups[name] = group
        # the group's external inputs are the net's variables
        nodes = _topo(exe._opt_symbol._outputs)
        by_name = dict(zip(names, vals))
        ext_names = [nodes[i].name for i, _ in ext]
        ins = [by_name[n] for n in ext_names]
        out = exe.outputs[0].data
        err, ok = passes.parity_error(group, ins, out)
        check(ok, f"{name}: executor output != plain chain ({err!r})")
        # the backward is the plain chain's own, recomputed: the same ops
        # on the same inputs
        leaves = [v.clone().requires_grad_(True) for v in ins]
        want = group.plain_fn(*leaves)
        grads = torch.autograd.grad(want, leaves, torch.ones_like(want))
        for n, g in zip(ext_names, grads):
            check(torch.allclose(exe.grad_dict[n].data, g, rtol=1e-6,
                                 atol=1e-6),
                  f"{name}: gradient of {n} != plain chain's")
    launches = passes.launch_counts()
    res["launches"] = launches
    check(all(launches[t] >= 1 for t in nets),
          f"a template's kernel never launched on the Executor path: "
          f"{launches}")
    log(f"codegen: Executor path of the template nets at ({side}, {side}):"
        f" bind {res['bind_s']!r} s, launches {launches}")
    del execs
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    twins = _bf16_twins(torch, passes, groups.values())
    res["rows"] = [_kernel_row(torch, passes, name, g, bf, flush, 7)
                   for (name, g), bf in zip(groups.items(), twins)]
    del flush
    torch.cuda.empty_cache()
    log("phase 5 ok: codegen templates agree with the plain chain")
    return res


# ------------------------------------------------------------ phase 6
def _train_data(mx, n_batches, batch):
    """Synthetic ImageNet batches as examples/image_classification/
    train_imagenet.py builds them (seed 0)."""
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (n_batches * batch, 3, 299, 299)).astype(
        np.float32)
    y = rs.randint(0, 1000, (n_batches * batch,)).astype(np.float32)
    return mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False,
                             label_name="softmax_label")


_INIT = dict(rnd_type="gaussian", factor_type="in", magnitude=2)
_OPT = (("learning_rate", 0.1), ("momentum", 0.9), ("wd", 1e-4))


def _reference_step(torch, mx, net, batch, shapes):
    """Outputs and gradients of the first step with every fusion group
    run op by op (MXNET_FUSION_CODEGEN=0), from the same initial
    weights."""
    os.environ["MXNET_FUSION_CODEGEN"] = "0"
    try:
        mod = mx.mod.Module(net, context=mx.gpu(0))
        mod.bind(*shapes)
        check(all(d.startswith("fallback:disabled") for _, d in
                  mod._exec_group.execs[0]._codegen_plan.cache_component),
              "MXNET_FUSION_CODEGEN=0 left a group fused")
        mx.random.seed(0)
        mod.init_params(initializer=mx.init.Xavier(**_INIT))
        mod.forward(batch, is_train=True)
        mod.backward()
        exe = mod._exec_group.execs[0]
        outs = [o.data.clone() for o in exe.outputs]
        grads = {n: g.data.clone() for n, g in exe.grad_dict.items()
                 if g is not None and exe._grad_req.get(n) != "null"}
    finally:
        del os.environ["MXNET_FUSION_CODEGEN"]
    del mod, exe
    torch.cuda.empty_cache()
    return outs, grads


def _profile_step(torch, mod, batch):
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    for _ in range(2):
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return _device_time(torch, prof, wall_us, 15, "step")


def phase_training(torch, mx, profile=False):
    from mxnet_tpu_torch import passes
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    res = {}
    net = get_inception_resnet_v2(num_classes=1000)
    data = _train_data(mx, TRAIN_STEPS, TRAIN_BATCH)
    shapes = (data.provide_data, data.provide_label)
    first = next(iter(data))
    data.reset()
    ref_outs, ref_grads = _reference_step(torch, mx, net, first, shapes)

    passes.reset_fusion_stats()
    passes.clear_memo()
    torch.cuda.reset_peak_memory_stats()
    mod = mx.mod.Module(net, context=mx.gpu(0))
    t0 = time.perf_counter()
    mod.bind(*shapes)
    res["cold_bind_s"] = time.perf_counter() - t0
    exe = mod._exec_group.execs[0]
    plan = exe._codegen_plan
    stats = passes.fusion_stats()
    res["fusion_stats"] = stats
    lowered = [d for _, d in plan.cache_component if d.startswith("kernel:")]
    check(len(plan.cache_component) == 40 and len(lowered) == 40,
          f"expected 40 fusion groups lowered, plan {plan.cache_component}")
    check(stats["groups_fallback"] == 0 and stats["parity_failures"] == 0,
          f"fusion stats {stats}")
    log(f"training: cold bind {res['cold_bind_s']!r} s (passes, nvcc, "
        f"parity), {len(lowered)} groups lowered, fusion stats {stats}")
    mx.random.seed(0)
    mod.init_params(initializer=mx.init.Xavier(**_INIT))
    w0 = exe.arg_dict["b35_1_proj_conv_weight"].data.clone()

    step_ends, captured = [], {}

    def on_batch(param):
        if param.nbatch == 0:
            captured["outs"] = [o.data.clone() for o in exe.outputs]
            captured["grads"] = {n: exe.grad_dict[n].data.clone()
                                 for n in ref_grads}
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())

    metric = mx.metric.create(["acc", "ce"])
    speedometer = mx.callback.Speedometer(TRAIN_BATCH, frequent=5)
    passes.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(data, num_epoch=1, eval_metric=metric, optimizer="sgd",
            optimizer_params=_OPT, initializer=mx.init.Xavier(**_INIT),
            batch_end_callback=[on_batch, speedometer])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = passes.launch_counts()
    res["launches"] = launches
    n_steps = len(step_ends)
    check(n_steps == TRAIN_STEPS, f"fit ran {n_steps} steps")
    check(sum(launches.values()) == 40 * n_steps,
          f"generated-kernel launches {launches} != 40 x {n_steps} steps")
    check(launches["scale_bias_act"] == 39 * n_steps
          and launches["elementwise"] == n_steps,
          f"launches per template {launches}")

    values = dict(metric.get_name_value())
    res["metrics"] = values
    check(np.isfinite(values["cross-entropy"]),
          f"non-finite loss {values}")
    w1 = exe.arg_dict["b35_1_proj_conv_weight"].data
    moved = (w1 - w0).abs().max().item()
    check(moved > 0, "b35_1_proj_conv_weight did not move")

    def rel_err(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    worst = {"outputs": max(rel_err(a, b) for a, b in
                            zip(captured["outs"], ref_outs))}
    worst.update({n: rel_err(captured["grads"][n], g)
                  for n, g in ref_grads.items()})
    bad = {n: r for n, r in worst.items() if not r <= TRAIN_PARITY_RTOL}
    name = max(worst, key=lambda n: worst[n] if n not in bad else np.inf)
    rel = worst[name] if not bad else next(iter(bad.values()))
    res["fused_vs_op_by_op_worst"] = {"tensor": name, "rel": rel}
    check(not bad, f"first step fused vs op by op: {len(bad)} tensors "
          f"differ by more than {TRAIN_PARITY_RTOL} of their max "
          f"magnitude, e.g. {dict(list(bad.items())[:5])}")

    starts = [t0] + step_ends[:-1]
    step_ms = [(e - s) * 1e3 for s, e in zip(starts, step_ends)]
    steady = step_ms[1:]
    res.update({
        "fit_s": fit_s, "step_ms": step_ms,
        "step_ms_p50": float(np.percentile(steady, 50)),
        "step_ms_p95": float(np.percentile(steady, 95)),
        "images_per_s": TRAIN_BATCH * len(steady) / (sum(steady) / 1e3),
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
        "params": int(sum(a.size for n, a in exe.arg_dict.items()
                          if n not in ("data", "softmax_label"))),
        "weight_moved_max": moved})
    log(f"training: {n_steps} steps in {fit_s!r} s, first step "
        f"{step_ms[0]!r} ms, steady step p50 {res['step_ms_p50']!r} ms p95 "
        f"{res['step_ms_p95']!r} ms, {res['images_per_s']!r} images/s, "
        f"peak memory {res['peak_mem_bytes']} B, {res['params']} "
        f"parameters, metrics {values}, launches {launches}, fused vs op "
        f"by op worst {name} {rel!r}")
    groups = {}
    for group, _ in plan.fused.values():
        groups.setdefault(group.digest, group)
    res["launches_per_step_by_digest"] = {
        d: g.kernel.launches / n_steps for d, g in groups.items()}
    if profile:
        res["profile"] = _profile_step(torch, mod, first)
    log("phase 6 ok: Inception-ResNet-v2 trains through Module.fit")
    return res, groups, mod.get_params()


# ------------------------------------------------------------ phase 7
def phase_train_kernels(torch, groups, launches_per_digest):
    from mxnet_tpu_torch import passes

    dev = torch.device("cuda")
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device=dev)
    names = {320: "block35", 1088: "block17"}
    rows = []
    ordered = sorted(groups.items())
    twins = _bf16_twins(torch, passes, [g for _, g in ordered])
    for seed, ((digest, group), bf) in enumerate(zip(ordered, twins)):
        ch = group.in_avals[0][0][1]
        name = ("b8_final" if group.template == "elementwise"
                else names.get(ch, "block8"))
        row = _kernel_row(torch, passes, name, group, bf, flush, 200 + seed)
        row["launches_per_step"] = launches_per_digest[digest]
        rows.append(row)
    del flush
    torch.cuda.empty_cache()
    log("phase 7 ok: training kernels agree with the plain chain")
    return rows


# ------------------------------------------------------------ phase 8
def _attn_inputs(torch, b, tq, tk, h, d, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, t, h, d, generator=g, device="cuda").to(dtype)
            for t in (tq, tk, tk)]


def _attn_bound(q, k, causal):
    """Least time of one forward: q, k, v read once and o written once
    over the HBM rate, or the 4 D flops per (query, key) pair the
    top-left causal mask keeps over the card's tensor-core rate for the
    inputs' type (989 TFLOP/s bf16/f16, 495 TF32 for float32). Returns
    {"ms", "by": "bytes" or "operations", "bytes", "flops", "rate", and
    "route_ms"}: the floor of B6's float32 route, 3xTF32, which does three
    TF32 products for each (3x the flops at 495 TFLOP/s); null in
    bf16/f16, whose route is the bound's."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if causal:
        n = min(tq, tk)
        pairs = n * (n + 1) // 2 + max(tq - tk, 0) * tk
    else:
        pairs = tq * tk
    flops = 4 * b * h * d * pairs
    nbytes = (2 * tq + 2 * tk) * b * h * d * q.element_size()
    if q.element_size() == 4:
        rate = TF32_FLOPS_PER_S
        rate_name = "TF32 tensor cores at 495 TFLOP/s"
        route_ms = 3 * flops / rate * 1e3
    else:
        rate = BF16_FLOPS_PER_S
        rate_name = "bf16/f16 tensor cores at 989 TFLOP/s"
        route_ms = None
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return {"ms": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "rate": rate_name,
            "route_ms": route_ms}


def _bound_text(bound):
    route = ("" if bound["route_ms"] is None else
             f"; 3xTF32 route's floor {bound['route_ms']!r} ms")
    return (f"bound_ms {bound['ms']!r} ({bound['by']}, {bound['rate']}; "
            f"{bound['flops']} flops, {bound['bytes']} B{route})")


def _sdpa(torch, q, k, v, causal):
    """The library yardstick: scaled_dot_product_attention on (B, H, T, D)
    views, is_causal (top-left, the kernel's mask); timed only."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal)


def _rel(torch, out, ref):
    """max|out - ref| / max|ref| (0 when both are all zeros)."""
    out, ref = out.float(), ref.float()
    return ((out - ref).abs().max()
            / ref.abs().max().clamp_min(1e-30)).item()


def _rel_beyond_ulp(torch, out, ref):
    """max(|out - ref| - ulp(ref), 0) / max|ref|, ulp in out's type."""
    eps = torch.finfo(out.dtype).eps
    ref32 = ref.float()
    mag = ref32.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = eps * torch.exp2(torch.floor(torch.log2(mag)))
    excess = ((out.float() - ref32).abs() - ulp).clamp_min(0)
    return (excess.max() / ref32.abs().max()).item()


_ATTN_DTYPES = {"float32": "float32", "bf16": "bfloat16", "f16": "float16"}


def _attn_row(torch, tattn, name, shape, causal, kv, flush, seed,
              block_k=ATTN_BLOCK_K):
    b, tq, tk, h, d = shape
    dtype = getattr(torch, _ATTN_DTYPES[kv])
    q, k, v = _attn_inputs(torch, b, tq, tk, h, d, dtype, seed)
    out = tattn.flash_forward(q, k, v, causal, block_k=block_k)
    torch.cuda.synchronize()
    ref = tattn.flash_forward_plain(q, k, v, causal, block_k=block_k)
    check(torch.isfinite(out).all().item(), f"flash {name}: non-finite")
    rel = _rel_beyond_ulp(torch, out, ref)
    err = (out.float() - ref.float()).abs().max().item()
    check(rel <= ATTN_TOL[kv], f"flash {name} {kv} causal={causal}: error "
          f"beyond one ulp {rel!r} of the output's max > {ATTN_TOL[kv]}")
    lib_err = _rel(torch, _sdpa(torch, q, k, v, causal).transpose(1, 2),
                   ref)
    del ref
    reps = 20 if tq * tk <= 2048 * 2048 else 5
    row = {"name": name, "shape": [b, tq, tk, h, d], "causal": causal,
           "kv": kv, "block_k": block_k, "max_abs_err": err,
           "rel_err": rel, "library_rel_err": lib_err,
           "instance": tattn.kernel_instance(dtype, d, tattn.kernel_block_k(
               block_k, tk)),
           "ms": _time_ms(torch, lambda: tattn.flash_forward(
               q, k, v, causal, block_k=block_k), flush, reps),
           "plain_ms": _time_ms(torch, lambda: tattn.flash_forward_plain(
               q, k, v, causal, block_k=block_k), flush, reps),
           "library_ms": _time_ms(torch, lambda: _sdpa(
               torch, q, k, v, causal), flush, reps)}
    bound = row["bound"] = _attn_bound(q, k, causal)
    row["bound_ms"], row["bound_by"] = bound["ms"], bound["by"]
    log(f"flash {name:11s} {kv:7s} causal={causal!s:5s} {row['shape']} "
        f"block_k {block_k} {row['instance']}: err {err!r} (beyond one "
        f"ulp, of the max: {rel!r}) ms {row['ms']!r} plain_ms "
        f"{row['plain_ms']!r} library_ms {row['library_ms']!r} (rel err "
        f"{lib_err!r}) {_bound_text(bound)}")
    return row


def _flash_instances(torch, tattn):
    """Each B6 instance in the built libraries (one a dtype): registers,
    spill stores and loads and stack frame (the ptxas report kept at
    build), warps, stages and dynamic shared memory (as the library
    reports them), and its tensor-core instructions (HMMA, mma.sync's,
    and HGMMA, wgmma's, lines of cuobjdump -sass). Fails when a report is
    missing or a bf16/f16 instance has no tensor-core instruction."""
    from mxnet_tpu_torch import kernels

    name_re = re.compile(r"flash_fwd_kernelI\w+?Li(\d+)ELi(\d+)ELi(\d+)E")
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()),
                             "cuobjdump")
    rows, sass_runs = [], {}
    for name in _ATTN_DTYPES.values():          # the three disassemble at once
        lib = tattn.KERNEL_LIBRARIES[getattr(torch, name)]
        tattn.kernel_instance(getattr(torch, name), 64)   # built and loaded
        sass_runs[lib] = subprocess.Popen(
            [cuobjdump, "-sass", kernels.library_path(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for kv, name in _ATTN_DTYPES.items():
        dtype = getattr(torch, name)
        lib = tattn.KERNEL_LIBRARIES[dtype]
        report = kernels.build_report(lib)
        check(report is not None, f"no ptxas report for {lib}")
        info = _ptxas_info(report)
        sass_out, sass_err = sass_runs[lib].communicate(timeout=300)
        check(sass_runs[lib].returncode == 0,
              f"cuobjdump -sass {lib} failed: {sass_err}")
        tensor, cur = {}, None
        for line in sass_out.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = m.group(1)
                tensor[cur] = {"HMMA": 0, "HGMMA": 0}
                continue
            m = re.search(r"\b(HG?MMA)\b", line)
            if m and cur:
                tensor[cur][m.group(1)] += 1
        for fn, r in info.items():
            m = name_re.search(fn)
            if not m:
                continue
            d, tile_k, stages = (int(x) for x in m.groups())
            inst = tattn.kernel_instance(dtype, d, tile_k)
            check(inst["stages"] == stages,
                  f"{lib} D={d} tile_k={tile_k}: {inst} vs {fn}")
            counts = tensor.get(fn, {"HMMA": 0, "HGMMA": 0})
            row = {"kv": kv, "d": d, "tile_k": tile_k, "stages": stages,
                   "warps": inst["warps"], "smem_bytes": inst["smem_bytes"],
                   "hmma": counts["HMMA"], "hgmma": counts["HGMMA"], **r}
            rows.append(row)
            log(f"flash instance {kv:7s} D={d:3d} tile_k={tile_k:3d} "
                f"warps={row['warps']} stages={stages}: "
                f"{r.get('registers')} registers, {r.get('spill_stores')} B "
                f"spill stores, {r.get('spill_loads')} B spill loads, "
                f"{r.get('stack')} B stack, {row['smem_bytes']} B shared, "
                f"{row['hmma']} HMMA, {row['hgmma']} HGMMA")
    check(len(rows) == 29, f"flash instances in the reports: {len(rows)}")
    bare = [(r["kv"], r["d"], r["tile_k"]) for r in rows
            if r["kv"] != "float32" and r["hmma"] + r["hgmma"] == 0]
    check(not bare, f"bf16/f16 flash instances without tensor-core "
          f"instructions: {bare}")
    return rows


def _peak_bytes(torch, fn):
    """fn()'s result and the device memory it took above what was
    allocated before it."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def phase_attention(torch):
    import importlib

    tattn = importlib.import_module("mxnet_tpu_torch.parallel.attention")
    res = {}
    b, t, h, d = ATTN_SHAPE
    tattn.reset_launch_counts()
    # (a) the main path: forward and backward through attention(impl=
    # "flash") at the transformer's shape, against autograd through the
    # reference; then a long-context forward
    q, k, v = _attn_inputs(torch, b, t, t, h, d, torch.float32, 11)
    g = torch.Generator(device="cuda").manual_seed(12)
    head = torch.randn(q.shape, generator=g, device="cuda")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = tattn.attention(*leaves, causal=True, impl="flash")
    (out * head).sum().backward()
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    ref = tattn.attention_reference(*ref_leaves, causal=True)
    (ref * head).sum().backward()
    grad = {"out": _rel(torch, out.detach(), ref.detach())}
    grad.update({n: _rel(torch, a.grad, r.grad)
                 for n, a, r in zip("qkv", leaves, ref_leaves)})
    res["gradient_rel_err"] = grad
    check(all(e <= ATTN_TOL["float32"] for e in grad.values()),
          f"flash attention forward/backward vs reference: {grad}")
    log(f"attention: attention(impl='flash') {list(ATTN_SHAPE)} float32 "
        f"causal, forward and backward vs the reference: {grad}")
    del q, k, v, head, leaves, out, ref_leaves, ref
    torch.cuda.empty_cache()

    lb, lt, lh, ld = LONG_SHAPE
    q, k, v = _attn_inputs(torch, lb, lt, lt, lh, ld, torch.float32, 13)
    with torch.no_grad():
        out, flash_peak = _peak_bytes(torch, lambda: tattn.attention(
            q, k, v, causal=True, impl="flash"))
    launches = tattn.launch_counts()
    res["launches"] = launches
    check(launches["flash_attention"] == 2,
          f"flash kernel launches on the path {launches} != 2")
    ref, plain_peak = _peak_bytes(
        torch, lambda: tattn.flash_forward_plain(q, k, v, True,
                                                 block_k=ATTN_BLOCK_K))
    rel = _rel(torch, out, ref)
    check(rel <= ATTN_TOL["float32"],
          f"long context: flash vs plain {rel!r}")
    del out, ref
    torch.cuda.empty_cache()
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    long = {"shape": list(LONG_SHAPE), "rel_err": rel,
            "flash_peak_bytes": flash_peak, "plain_peak_bytes": plain_peak,
            "input_bytes": 3 * q.numel() * q.element_size(),
            "block_k": ATTN_BLOCK_K,
            "ms": _time_ms(torch, lambda: tattn.flash_forward(
                q, k, v, True, block_k=ATTN_BLOCK_K), flush, 5),
            "plain_ms": _time_ms(torch, lambda: tattn.flash_forward_plain(
                q, k, v, True, block_k=ATTN_BLOCK_K), flush, 3),
            "library_ms": _time_ms(torch, lambda: _sdpa(torch, q, k, v,
                                                        True), flush, 5)}
    bound = long["bound"] = _attn_bound(q, k, True)
    long["bound_ms"], long["bound_by"] = bound["ms"], bound["by"]
    res["long_context"] = long
    log(f"attention: long context {list(LONG_SHAPE)} float32 causal, "
        f"block_k {ATTN_BLOCK_K}: flash {long['ms']!r} ms, peak "
        f"{flash_peak} B above the inputs; plain {long['plain_ms']!r} ms, "
        f"peak {plain_peak} B; library {long['library_ms']!r} ms; "
        f"{_bound_text(bound)}; rel err {rel!r}; flash launches on the "
        f"path {launches}")
    del q, k, v
    torch.cuda.empty_cache()

    # (b) the kernel against its plain version at each shape, at the
    # path's key block; the instances' registers, spills, shared memory
    # and tensor-core instructions
    res["instances"] = _flash_instances(torch, tattn)
    rows = []
    seed = 20
    for kv in ("float32", "bf16"):
        for causal in (True, False):
            rows.append(_attn_row(torch, tattn, "transformer",
                                  (b, t, t, h, d), causal, kv, flush, seed))
            seed += 1
        rows.append(_attn_row(torch, tattn, "unequal",
                              (1, 256, 1024, 8, 64), True, kv, flush, seed))
        seed += 1
    rows.append(_attn_row(torch, tattn, "transformer", (b, t, t, h, d),
                          True, "f16", flush, seed))
    seed += 1
    rows.append(_attn_row(torch, tattn, "transformer", (b, t, t, h, d),
                          True, "bf16", flush, seed, block_k=64))
    seed += 1
    rows.append(_attn_row(torch, tattn, "long", (lb, lt, lt, lh, ld), True,
                          "bf16", flush, seed))
    seed += 1
    for causal in (True, False):
        rows.append(_attn_row(torch, tattn, "test", (2, 64, 64, 4, 16),
                              causal, "float32", flush, seed))
        seed += 1
    res["rows"] = rows
    del flush
    torch.cuda.empty_cache()
    log("phase 8 ok: flash attention agrees with its plain version and "
        "the reference")
    return res


# ------------------------------------------------------------ phase 9
def _tower_flops(batch, seq, d_model, d_ff, num_layers):
    """Forward FLOPs at 2 a MAC, as tools/bench_transformer.py counts
    them (causal attention halved)."""
    proj = 4 * batch * seq * d_model * d_model
    attn = 2 * batch * seq * seq * d_model // 2
    ffn = 2 * batch * seq * d_model * d_ff
    return 2 * num_layers * (proj + attn + ffn)


def _tower_reference(torch, mx, net, shape, arg_params, x, y):
    """Outputs and gradients of the first step through a bind of the
    graph as written (MXNET_GRAPH_PASSES=0: each node one op), from the
    same weights and batch."""
    os.environ["MXNET_GRAPH_PASSES"] = "0"
    try:
        names = net.list_arguments()
        req = {n: ("null" if n in ("data", "label") else "write")
               for n in names}
        exe = net.simple_bind(mx.gpu(0), grad_req=req, data=shape,
                              label=shape)
        for n, arr in arg_params.items():
            exe.arg_dict[n][:] = arr
        exe.arg_dict["data"][:] = x
        exe.arg_dict["label"][:] = y
        exe.forward(is_train=True)
        exe.backward()
        outs = [o.data.clone() for o in exe.outputs]
        grads = {n: exe.grad_dict[n].data.clone() for n in names
                 if req[n] == "write"}
    finally:
        del os.environ["MXNET_GRAPH_PASSES"]
    del exe
    torch.cuda.empty_cache()
    return outs, grads


def phase_transformer(torch, mx, profile=False):
    import importlib

    from mxnet_tpu_torch.models import get_transformer

    tattn = importlib.import_module("mxnet_tpu_torch.parallel.attention")
    res = {}
    net = get_transformer(**TOWER_CFG)
    shape = (TOWER_BATCH, TOWER_SEQ, TOWER_CFG["d_model"])
    rs = np.random.RandomState(0)
    x = mx.nd.array(rs.randn(*shape).astype(np.float32), ctx=mx.gpu(0))
    y = mx.nd.array(rs.randn(*shape).astype(np.float32), ctx=mx.gpu(0))
    batch = mx.io.DataBatch(data=[x], label=[y])

    tattn.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod = mx.mod.Module(net, data_names=("data",), label_names=("label",),
                        context=mx.gpu(0))
    mod.bind(data_shapes=[("data", shape)], label_shapes=[("label", shape)])
    mod.init_params(mx.init.Xavier())
    mod.init_optimizer(kvstore="local", optimizer="adam",
                       optimizer_params={"learning_rate": 1e-4})
    res["bind_init_s"] = time.perf_counter() - t0
    exe = mod._exec_group.execs[0]
    args, _ = mod.get_params()
    w0 = {n: a.data.clone() for n, a in args.items()}
    res["params"] = int(sum(a.size for a in args.values()))
    metric = mx.metric.create("mse")
    step_ms, first = [], None
    torch.cuda.synchronize()
    for step in range(TOWER_STEPS):
        t = time.perf_counter()
        mod.forward_backward(batch)
        if step == 0:
            torch.cuda.synchronize()
            first = ([o.data.clone() for o in exe.outputs],
                     {n: exe.grad_dict[n].data.clone() for n in w0})
        mod.update()
        mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    launches = tattn.launch_counts()
    res["flash_launches"] = launches
    check(launches["flash_attention"] == 0,
          f"the transformer launched the flash kernel: {launches}")
    mse = metric.get()[1]
    res["mse"] = mse
    check(np.isfinite(mse), f"non-finite MSE {mse!r}")
    args, _ = mod.get_params()
    moved = {n: (args[n].data - w0[n]).abs().max().item() for n in w0}
    res["weight_moved_min"] = min(moved.values())
    check(all(m > 0 for m in moved.values()),
          f"weights that did not move: {[n for n, m in moved.items() if not m > 0]}")

    if profile:
        res["profile"] = _profile_step(torch, mod, batch)
    # the first step against the graph bound without passes
    del mod, exe
    torch.cuda.empty_cache()
    ref_outs, ref_grads = _tower_reference(
        torch, mx, net, shape,
        {n: mx.nd.NDArray(w, ctx=mx.gpu(0)) for n, w in w0.items()}, x, y)

    def rel_err(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    worst = {"outputs": max(rel_err(a, b) for a, b in
                            zip(first[0], ref_outs))}
    worst.update({n: rel_err(first[1][n], g) for n, g in ref_grads.items()})
    name = max(worst, key=worst.get)
    res["module_vs_op_by_op_worst"] = {"tensor": name, "rel": worst[name]}
    check(worst[name] <= TOWER_PARITY_RTOL,
          f"first step Module vs op by op: {name} differs by "
          f"{worst[name]!r} of its max > {TOWER_PARITY_RTOL}")

    steady = step_ms[1:]
    fwd = _tower_flops(TOWER_BATCH, TOWER_SEQ, TOWER_CFG["d_model"],
                       TOWER_CFG["d_ff"], TOWER_CFG["num_layers"])
    p50 = float(np.percentile(steady, 50))
    res.update({
        "step_ms": step_ms, "step_ms_p50": p50,
        "step_ms_p95": float(np.percentile(steady, 95)),
        "tokens_per_s": TOWER_BATCH * TOWER_SEQ * len(steady)
        / (sum(steady) / 1e3),
        "fwd_flops": fwd, "step_flops": 3 * fwd,
        "tflops_per_s": 3 * fwd / (p50 / 1e3) / 1e12})
    log(f"transformer: {res['params']} parameters, batch {TOWER_BATCH} x "
        f"{TOWER_SEQ} tokens, {TOWER_STEPS} steps (Adam lr 1e-4), first "
        f"step {step_ms[0]!r} ms, steady p50 {p50!r} ms p95 "
        f"{res['step_ms_p95']!r} ms, {res['tokens_per_s']!r} tokens/s, "
        f"{res['tflops_per_s']!r} TFLOP/s of {3 * fwd} FLOP a step, peak "
        f"memory {res['peak_mem_bytes']} B, MSE {mse!r}, Module vs op by "
        f"op worst {name} {worst[name]!r}; flash kernel launches "
        f"{launches['flash_attention']} (RingAttention on one device is "
        f"plain attention, no B6)")
    log("phase 9 ok: the transformer trains through Module")
    return res


# ------------------------------------------------------------ phase 10
def _rtc_nets(mx):
    """Inception-ResNet-v2 with its SoftmaxOutput head (phase 6's net)
    and the same net with the head replaced by the rtc_softmax_ce Custom
    op on the last FullyConnected's output."""
    from mxnet_tpu_torch import rtc_ops  # noqa: F401  (registers the op)
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    ref = get_inception_resnet_v2(num_classes=1000)
    fc = ref.get_internals()["fc1_output"]
    net = mx.sym.Custom(data=fc, label=mx.sym.Variable("softmax_label"),
                        op_type="rtc_softmax_ce", name="softmax")
    return ref, net


def _host_params(mx, net, batch):
    """Xavier() parameters of `net` on the host, from mx.random.seed(0),
    drawn as Module.init_params draws them."""
    from mxnet_tpu_torch.initializer import InitDesc

    arg_shapes, _, aux_shapes = net.infer_shape(
        data=(batch, 3, RTC_IMAGE, RTC_IMAGE), softmax_label=(batch,))
    attrs = net.attr_dict()
    init = mx.init.Xavier()
    mx.random.seed(0)
    args = {n: mx.nd.zeros(s, ctx=mx.cpu())
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: mx.nd.zeros(s, ctx=mx.cpu())
            for n, s in zip(net.list_auxiliary_states(), aux_shapes)}
    for table in (args, auxs):
        for n, a in table.items():
            init(InitDesc(n, attrs.get(n)), a)
    return args, auxs


def _softmax_bound(rows, cols, backward):
    """Least time: x (or prob and label) read once, the output written
    once, over the HBM rate; or 7 float32 operations an element forward
    (max, subtract and exp twice, add, divide), 1 backward, over the
    float32 rate."""
    n = rows * cols
    nbytes = 8 * n + (4 * rows if backward else 0)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (1 if backward else 7) * n / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def _softmax_rows(torch, rtc_ops, flush):
    """Both head kernels against their plain versions at the training
    shape and at a vocabulary-sized softmax, with their times."""
    dev = torch.device("cuda")
    rows = []
    for shape in ((TRAIN_BATCH, 1000), RTC_VOCAB_SHAPE):
        r, c = shape
        g = torch.Generator(device=dev).manual_seed(r)
        x = torch.randn(shape, generator=g, device=dev) * 5.0
        label = torch.randint(0, c, (r,), generator=g, device=dev).float()
        prob = rtc_ops.softmax_ce_forward(x)
        grad = rtc_ops.softmax_ce_backward(prob, label)
        torch.cuda.synchronize()
        ref_prob = rtc_ops.softmax_plain(x)
        err_f = (prob - ref_prob).abs().max().item()
        check(err_f <= RTC_SOFTMAX_TOL, f"softmax {shape}: max abs err "
              f"{err_f!r} > {RTC_SOFTMAX_TOL}")
        ref_grad = rtc_ops.softmax_ce_backward_plain(prob, label)
        err_b = (grad - ref_grad).abs().max().item()
        check(err_b == 0.0, f"softmax backward {shape}: max abs err "
              f"{err_b!r} (bit-exact expected)")
        del ref_prob, ref_grad
        idx = label.long()[:, None]
        minus = torch.full_like(idx, -1.0, dtype=torch.float32)
        reps = 20 if r * c < 1 << 24 else 5
        block, path = rtc_ops.softmax_geometry(c)
        for name, fn, plain, lib, err, bwd in (
                ("softmax_ce_forward",
                 lambda: rtc_ops.softmax_ce_forward(x),
                 lambda: rtc_ops.softmax_plain(x),
                 lambda: torch.softmax(x, dim=1), err_f, False),
                ("softmax_ce_backward",
                 lambda: rtc_ops.softmax_ce_backward(prob, label),
                 lambda: rtc_ops.softmax_ce_backward_plain(prob, label),
                 lambda: torch.scatter_add(prob, 1, idx, minus), err_b,
                 True)):
            row = {"name": name, "shape": list(shape), "max_abs_err": err,
                   "geometry": ({"block": rtc_ops.softmax_backward_block(c)}
                                if bwd else {"block": block, "path": path}),
                   "ms": _time_ms(torch, fn, flush, reps),
                   "ms_clean_l2": _time_ms(torch, fn, flush, reps,
                                           clean=True),
                   "plain_ms": _time_ms(torch, plain, flush, reps),
                   "library_ms": _time_ms(torch, lib, flush, reps),
                   "library_ms_clean_l2": _time_ms(torch, lib, flush, reps,
                                                   clean=True)}
            row["bound_ms"], row["bound_by"], row["bytes"] = \
                _softmax_bound(r, c, bwd)
            rows.append(row)
            log(f"rtc {name:19s} {shape} {row['geometry']}: err {err!r} "
                f"ms {row['ms']!r} (clean L2 {row['ms_clean_l2']!r}) "
                f"plain_ms {row['plain_ms']!r} library_ms "
                f"{row['library_ms']!r} (clean L2 "
                f"{row['library_ms_clean_l2']!r}) bound_ms "
                f"{row['bound_ms']!r} ({row['bound_by']}, {row['bytes']} "
                f"B)")
        del x, label, prob, grad, idx, minus
        torch.cuda.empty_cache()
    return rows


def _elementwise_rows(torch, rtc, rtc_ops, flush):
    """The three repo bodies at RTC_ELEMS float32 elements against their
    plain versions (bit for bit), with the cold NVRTC compile of their
    source and the host cost of one push against one torch.mul."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(RTC_ELEMS, generator=g, device=dev) * 100.0
    y = torch.randn(RTC_ELEMS, generator=g, device=dev) * 100.0
    first = rtc_ops.kernel("double_f32")
    cubin = first.compile()
    res = {"compile_ms": first.compile_ms, "cubin_bytes": len(cubin),
           "rows": []}
    for body, plain, ins in (("double", rtc_ops.double_plain, [x]),
                             ("scale_shift", rtc_ops.scale_shift_plain, [x]),
                             ("saxpy", rtc_ops.saxpy_plain, [x, y])):
        k = rtc_ops.kernel(f"{body}_f32")
        (out,) = k.push(ins, [x.shape])
        torch.cuda.synchronize()
        want = plain(*ins)
        check(torch.equal(out.data, want), f"{body}: kernel != plain "
              f"(max abs err {(out.data - want).abs().max().item()!r})")
        del out, want
        nbytes = 4 * RTC_ELEMS * (len(ins) + 1)

        def push():
            return k.push(ins, [x.shape])

        row = {"name": body, "elements": RTC_ELEMS, "max_abs_err": 0.0,
               "ms": _time_ms(torch, push, flush, 10),
               "ms_clean_l2": _time_ms(torch, push, flush, 10, clean=True),
               "torch_ms": _time_ms(torch, lambda: plain(*ins), flush, 10),
               "torch_ms_clean_l2": _time_ms(torch, lambda: plain(*ins),
                                             flush, 10, clean=True),
               "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes", "bytes": nbytes}
        res["rows"].append(row)
        log(f"rtc {body:11s} 2^26 float32: bit-exact, ms {row['ms']!r} "
            f"(clean L2 {row['ms_clean_l2']!r}) torch expression ms "
            f"{row['torch_ms']!r} (clean L2 {row['torch_ms_clean_l2']!r}) "
            f"bound_ms {row['bound_ms']!r} (bytes, {nbytes} B)")
    del x, y
    torch.cuda.empty_cache()
    small = torch.randn(4096, device=dev)
    k = rtc_ops.kernel("double_f32")
    res.update(_host_us(torch, {
        "push": lambda: k.push([small], [small.shape]),
        "torch_mul": lambda: torch.mul(small, 2.0)}))
    log(f"rtc elementwise source: cold NVRTC compile {res['compile_ms']!r} "
        f"ms ({res['cubin_bytes']} B cubin); host us a push "
        f"{res['push_host_us']!r}, a torch.mul {res['torch_mul_host_us']!r} "
        f"(medians of {RTC_HOST_ROUNDS} turns of "
        f"{RTC_HOST_REPS // RTC_HOST_ROUNDS}; each turn's "
        f"{res['push_host_us_turns']} and {res['torch_mul_host_us_turns']})")
    return res


def _host_us(torch, fns):
    """Host µs of one enqueue of each fn (a small tensor, no synchronize
    in the loop): RTC_HOST_ROUNDS turns of RTC_HOST_REPS / RTC_HOST_ROUNDS
    calls, the fns in turn within each; the median turn, and every turn.
    The host is shared, so a single long loop lands other processes'
    stalls on one side only."""
    reps = RTC_HOST_REPS // RTC_HOST_ROUNDS
    for fn in fns.values():
        for _ in range(50):
            fn()
    torch.cuda.synchronize()
    turns = {name: [] for name in fns}
    for _ in range(RTC_HOST_ROUNDS):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            turns[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
    out = {}
    for name, t in turns.items():
        out[f"{name}_host_us"] = float(np.median(t))
        out[f"{name}_host_us_turns"] = t
    return out


def _launch_floor(torch, rtc, rtc_ops, flush):
    """An empty kernel's device time through rtc.CudaKernel and _time_ms,
    at the (TRAIN_BATCH, 1000) forward's geometry (one CTA a row)."""
    k = rtc.CudaKernel("launch_floor", RTC_FLOOR_SRC, "launch_floor")
    small = torch.empty(32, device="cuda")
    block = rtc_ops.softmax_geometry(1000)[0]

    def push():
        return k.push_into([small], [small], grid=TRAIN_BATCH, block=block)

    res = {"ms": _time_ms(torch, push, flush),
           "ms_clean_l2": _time_ms(torch, push, flush, clean=True),
           "geometry": {"grid": TRAIN_BATCH, "block": block}}
    log(f"rtc launch floor (an empty kernel, {TRAIN_BATCH} x {block} "
        f"threads): ms "
        f"{res['ms']!r} (clean L2 {res['ms_clean_l2']!r})")
    return res


def _rtc_registers(rtc_ops):
    """Registers and spills of every entry point of both sources, from
    NVRTC's log (--ptxas-options=-v); fails on a spill."""
    info = {}
    for fn in ("softmax_ce_forward", "double_f32"):
        info.update(_ptxas_info(rtc_ops.kernel(fn).build_log or ""))
    check(set(rtc_ops._FILE_OF) <= set(info),
          f"ptxas report lacks {set(rtc_ops._FILE_OF) - set(info)}")
    spills = {fn: i for fn, i in info.items()
              if i["spill_stores"] or i["spill_loads"]}
    check(not spills, f"rtc kernels spill: {spills}")
    log("rtc registers (no spills): " + ", ".join(
        f"{fn} {i['registers']}" for fn, i in sorted(info.items())))
    return info


def _register_numpy_softmax(mx):
    """examples/numpy_ops/custom_softmax.py's CustomOp, on the port: the
    example's numpy forward and backward (a host round trip each)."""

    class NumpySoftmax(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0].asnumpy()
            e = np.exp(x - x.max(axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        mx.nd.array(e / e.sum(axis=1, keepdims=True)))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            label = in_data[1].asnumpy().astype(int)
            g = y.copy()
            g[np.arange(len(label)), label] -= 1.0
            self.assign(in_grad[0], req[0], mx.nd.array(g))

    @mx.operator.register("numpy_softmax_ce")
    class NumpySoftmaxProp(mx.operator.CustomOpProp):
        def __init__(self):
            super().__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            return [in_shape[0], (in_shape[0][0],)], [in_shape[0]], []

        def create_operator(self, ctx, shapes, dtypes):
            return NumpySoftmax()


def _custom_softmax_example(torch, mx):
    """The example's net and data at its own size (5 classes, 16
    features, 1024 points, batch 64, 10 epochs, lr 0.5) through
    Module.fit on the card; then DataParallelExecutorManager on [gpu(0)]
    with the trained weights against the Module's forward."""
    _register_numpy_softmax(mx)
    rs = np.random.RandomState(0)
    k, d, n = 5, 16, 1024
    centers = rs.randn(k, d).astype(np.float32) * 3.0
    y = rs.randint(0, k, n).astype(np.float32)
    x = centers[y.astype(int)] + rs.randn(n, d).astype(np.float32) * 0.7
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, name="fc1", num_hidden=32)
    net = mx.sym.Activation(net, act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=k)
    net = mx.sym.Custom(data=net, label=mx.sym.Variable("softmax_label"),
                        op_type="numpy_softmax_ce", name="softmax")
    it = mx.io.NDArrayIter(x, y, batch_size=64, shuffle=True)
    mod = mx.mod.Module(net, context=[mx.default_context()])
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=10, optimizer="sgd",
            optimizer_params={"learning_rate": 0.5}, eval_metric="acc")
    fit_s = time.perf_counter() - t0
    acc = dict(mod.score(it, mx.metric.Accuracy()))["accuracy"]
    check(acc > 0.9, f"custom_softmax example: accuracy {acc!r} <= 0.9")
    args, auxs = mod.get_params()
    it.reset()
    batch = next(iter(it))
    mgr = mx.executor_manager.DataParallelExecutorManager(
        net, [mx.gpu(0)], it)
    mgr.set_params(args, auxs)
    mgr.load_data_batch(batch)
    mgr.forward(is_train=False)
    mod.forward(batch, is_train=False)
    check(torch.equal(mgr.curr_execgrp.get_outputs()[0].data,
                      mod.get_outputs()[0].data),
          "executor manager on [gpu(0)] != Module forward")
    log(f"rtc: custom_softmax.py's numpy CustomOp net through Module.fit on "
        f"{mx.default_context()}: 160 steps in {fit_s!r} s, accuracy "
        f"{acc!r}; DataParallelExecutorManager on [gpu(0)] equals the "
        "Module's forward")
    return {"accuracy": acc, "fit_s": fit_s}


def phase_rtc(torch, mx):
    """User device code: Inception-ResNet-v2 with the rtc_softmax_ce head
    trained, checkpointed and reloaded through FeedForward on the card."""
    from mxnet_tpu_torch import rtc, rtc_ops

    res = {}
    ref_net, net = _rtc_nets(mx)
    rs = np.random.RandomState(10)
    n_img = RTC_BATCHES * TRAIN_BATCH
    x = rs.uniform(-1, 1, (n_img, 3, RTC_IMAGE, RTC_IMAGE)).astype(
        np.float32)
    y = rs.randint(0, 1000, (n_img,)).astype(np.float32)
    args0, auxs0 = _host_params(mx, net, TRAIN_BATCH)
    res["params"] = int(sum(a.size for a in args0.values()))

    binds, step_ends, first = [], [], {}
    orig_bind = mx.mod.Module.bind

    def timed_bind(self, *a, **kw):
        t = time.perf_counter()
        out = orig_bind(self, *a, **kw)
        binds.append((time.perf_counter() - t, time.perf_counter()))
        return out

    def on_batch(param):
        if param.nbatch == 0:
            exe = param.locals["self"]._exec_group.execs[0]
            first["batch"] = param.locals["batch"]
            first["outs"] = [o.data.clone() for o in exe.outputs]
            first["grads"] = {n: exe.grad_dict[n].data.clone()
                              for n in args0}
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())

    model = mx.FeedForward(
        net, ctx=mx.gpu(0), num_epoch=1, numpy_batch_size=TRAIN_BATCH,
        optimizer="sgd", learning_rate=0.1, momentum=0.9, wd=1e-4,
        initializer=mx.init.Xavier(), arg_params=args0, aux_params=auxs0)
    fwd_k = rtc_ops.kernel("softmax_ce_forward")
    bwd_k = rtc_ops.kernel("softmax_ce_backward")
    rtc.reset_stats()
    launches0 = (fwd_k.launches, bwd_k.launches)
    mx.mod.Module.bind = timed_bind
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mx.random.seed(0)      # the first step's Dropout mask, as below
        model.fit(x, y, batch_end_callback=on_batch)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    finally:
        mx.mod.Module.bind = orig_bind
    fit_launches = rtc.stats()["launches"]
    n_steps = len(step_ends)
    check(n_steps == RTC_BATCHES, f"fit ran {n_steps} steps")
    check(fit_launches == 2 * n_steps,
          f"rtc launches in fit {fit_launches} != 2 x {n_steps} steps")
    res["cold_bind_s"] = binds[0][0]
    starts = [binds[0][1]] + step_ends[:-1]
    step_ms = [(e - s) * 1e3 for s, e in zip(starts, step_ends)]
    steady = step_ms[1:]
    res.update({"fit_s": fit_s, "step_ms": step_ms,
                "step_ms_p50": float(np.percentile(steady, 50)),
                "step_ms_p95": float(np.percentile(steady, 95)),
                "images_per_s": TRAIN_BATCH * len(steady)
                / (sum(steady) / 1e3)})
    log(f"rtc: FeedForward.fit of Inception-ResNet-v2 with the "
        f"rtc_softmax_ce head, {res['params']} parameters, {n_steps} steps "
        f"of {TRAIN_BATCH}: cold bind {res['cold_bind_s']!r} s, first step "
        f"{step_ms[0]!r} ms, steady p50 {res['step_ms_p50']!r} ms p95 "
        f"{res['step_ms_p95']!r} ms, {res['images_per_s']!r} images/s, "
        f"rtc launches {fit_launches}")

    # (1) the first step against SoftmaxOutput's from the same weights
    ref = mx.mod.Module(ref_net, context=mx.gpu(0))
    batch = first["batch"]
    ref.bind(data_shapes=[("data", batch.data[0].shape)],
             label_shapes=[("softmax_label", batch.label[0].shape)])
    ref.set_params(args0, auxs0)
    mx.random.seed(0)
    ref.forward(batch, is_train=True)
    ref.backward()
    exe = ref._exec_group.execs[0]

    def rel_err(a, b):
        return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()

    head = rel_err(first["outs"][0], exe.outputs[0].data)
    largest = max(exe.grad_dict[n].data.abs().max().item() for n in args0)
    zero_tol = RTC_ZERO_GRAD_TOL * largest
    grads, zero = {}, {}
    for n in args0:
        g, want = first["grads"][n], exe.grad_dict[n].data
        if n in RTC_ZERO_GRAD_LEAVES:
            zero[n] = {"max_abs": g.abs().max().item(),
                       "ref_max_abs": want.abs().max().item(),
                       "own_max_rel": rel_err(g, want)}
        else:
            grads[n] = rel_err(g, want)
    worst = max(grads, key=grads.get)
    # the smallest nonzero gradient the relative check holds (the
    # fix_gamma gammas' gradients are exactly zero on both sides)
    ref_max = {n: exe.grad_dict[n].data.abs().max().item() for n in grads}
    least = min((n for n in grads if ref_max[n] > 0), key=ref_max.get)
    res["head_vs_softmax_output"] = {
        "output": head, "worst_grad": worst, "worst_grad_rel": grads[worst],
        "checked": len(grads), "set_aside": zero, "largest_grad": largest,
        "exactly_zero": sum(v == 0 for v in ref_max.values()),
        "least_checked": least, "least_checked_max_abs": ref_max[least],
        "least_checked_rel": grads[least]}
    check(head <= RTC_HEAD_TOL, f"rtc head output vs SoftmaxOutput: "
          f"{head!r} of the max > {RTC_HEAD_TOL}")
    check(grads[worst] <= TRAIN_PARITY_RTOL,
          f"rtc head gradients vs SoftmaxOutput: {worst} differs by "
          f"{grads[worst]!r} of its max > {TRAIN_PARITY_RTOL}")
    check(len(zero) == len(RTC_ZERO_GRAD_LEAVES),
          f"leaves {RTC_ZERO_GRAD_LEAVES} not all in the net: {list(zero)}")
    for n, z in zero.items():
        check(max(z["max_abs"], z["ref_max_abs"]) <= zero_tol,
              f"{n}'s gradient is zero analytically, but the heads give "
              f"{z['max_abs']!r} and {z['ref_max_abs']!r} > {zero_tol!r}")
    del ref, exe, first
    torch.cuda.empty_cache()
    log(f"rtc: first step vs SoftmaxOutput from the same weights: output "
        f"{head!r} of its max, worst of {len(grads)} gradients {worst} "
        f"{grads[worst]!r} of its max (the smallest nonzero one, {least} "
        f"at {ref_max[least]!r}, within {grads[least]!r}); set aside as "
        f"zero analytically: {zero} (largest gradient {largest!r})")

    # (4) predict, save, load on the card, predict again, score
    before = rtc.stats()["launches"]
    pred = model.predict(x)
    check(rtc.stats()["launches"] - before == RTC_BATCHES,
          f"predict launches {rtc.stats()['launches'] - before} != "
          f"{RTC_BATCHES} batches")
    check(pred.shape == (n_img, 1000) and np.isfinite(pred).all(),
          f"predict: shape {pred.shape} or non-finite values")
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "irv2_rtc")
        model.save(prefix)
        loaded = mx.FeedForward.load(prefix, 1, ctx=mx.gpu(0),
                                     numpy_batch_size=TRAIN_BATCH)
        res["checkpoint_bytes"] = os.path.getsize(f"{prefix}-0001.params")
    pred2 = loaded.predict(x)
    check(np.array_equal(pred, pred2),
          "predict after save/load differs from the trained model's "
          f"(max abs diff {np.abs(pred - pred2).max()!r})")
    acc = loaded.score(mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH))
    res["score_accuracy"] = acc
    path_launches = {"softmax_ce_forward": fwd_k.launches - launches0[0],
                     "softmax_ce_backward": bwd_k.launches - launches0[1]}
    res["launches"] = path_launches
    stats = rtc.stats()
    check(stats["launches"] == 2 * n_steps + 3 * RTC_BATCHES,
          f"rtc launches on the path {stats['launches']}")
    log(f"rtc: predict after save/load ({res['checkpoint_bytes']} B of "
        f".params) is bit-identical; score accuracy {acc!r}; launches on "
        f"the path {path_launches}")
    del model, loaded, x, y, pred, pred2, args0, auxs0
    torch.cuda.empty_cache()

    # (2) and (5): the kernels against their plain versions
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32,
                        device="cuda")
    res["softmax_compile_ms"] = fwd_k.compile_ms
    res["softmax_rows"] = _softmax_rows(torch, rtc_ops, flush)
    res["elementwise"] = _elementwise_rows(torch, rtc, rtc_ops, flush)
    res["push_host_us"] = res["elementwise"]["push_host_us"]
    res["torch_mul_host_us"] = res["elementwise"]["torch_mul_host_us"]
    res["launch_floor"] = _launch_floor(torch, rtc, rtc_ops, flush)
    res["registers"] = _rtc_registers(rtc_ops)
    del flush
    torch.cuda.empty_cache()
    # (3) each source compiled (or found on disk) once, the rest hits: the
    # two repo sources (5 kernels) and the launch floor's (1 kernel)
    stats = rtc.stats()
    res["rtc_stats"] = stats
    check(stats["compiles"] <= 3 and stats["compiles"]
          + stats["cache_hits"] == 6,
          f"rtc compiles and cache hits {stats} (3 sources: 2 of the "
          "repo's, 5 kernels, and the launch floor's, 1 kernel)")
    log(f"rtc: softmax source cold NVRTC compile "
        f"{res['softmax_compile_ms']!r} ms; process stats {stats}")

    # (6) the numpy CustomOp example at its own size
    res["custom_softmax_example"] = _custom_softmax_example(torch, mx)
    log("phase 10 ok: user device code trains through FeedForward")
    return res


# ----------------------------------------------------------- phase 11
def _start_examples():
    """The examples this slice unblocks, in one child process on the card
    (tools/run_torch_example.py runs them one after another under the
    mxnet_tpu alias). Started with phase 1's kernel builds, which are
    host work, and reaped before the first timed kernel, so it shares
    the host and the card with no timed part of the script."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, os.path.join(root, "tools",
                                        "run_torch_example.py")]
    for i, (rel, extra) in enumerate(SURFACE_EXAMPLES):
        cmd += ([":::"] if i else []) + [os.path.join("examples", rel)] \
            + extra
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    proc.t0 = time.perf_counter()
    return proc


def _finish_examples(proc):
    """Wait for the examples' process; each script's seconds and the
    process's, or a failure naming the scripts that failed."""
    try:
        out, err = proc.communicate(timeout=SURFACE_EXAMPLES_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"the examples did not finish in {SURFACE_EXAMPLES_TIMEOUT} s")
    runs = [json.loads(line[len("EXAMPLE "):]) for line in out.splitlines()
            if line.startswith("EXAMPLE ")]
    secs = {os.path.relpath(r["script"], "examples").replace(
        os.sep, "/"): r["seconds"] for r in runs}
    bad = [r for r in runs if not r["ok"]]
    check(proc.returncode == 0 and not bad
          and len(runs) == len(SURFACE_EXAMPLES),
          f"examples on the card failed: {bad or runs}\n{out[-2000:]}\n"
          f"{err[-3000:]}")
    return {"seconds": secs, "process_s": time.perf_counter() - proc.t0}


def _imperative_forward(mx, graph, values):
    """The symbol's forward op by op through mx.nd.<op>, from its JSON
    graph; `values` maps each variable (arguments and aux states) to its
    NDArray. Returns the heads."""
    env = {}
    for i, node in enumerate(graph["nodes"]):
        if node["op"] == "null":
            env[(i, 0)] = values[node["name"]]
            continue
        ins = [env[(src, idx)] for src, idx, _ in node["inputs"]]
        attrs = {k: v for k, v in node.get("attrs", {}).items()
                 if not k.startswith("__")}
        out = getattr(mx.nd, node["op"])(*ins, **attrs)
        for j, o in enumerate(out if isinstance(out, list) else [out]):
            env[(i, j)] = o
    return [env[(src, idx)] for src, idx, _ in graph["heads"]]


def _surface_imperative(torch, mx, net, args, auxs, x, y):
    """One training step of the net built op by op under
    autograd.train_section, against the Executor's bind on the same
    weights and batch; then a NAG step through get_updater."""
    res = {}
    gpu = mx.gpu(0)
    shapes = {"data": x.shape, "softmax_label": y.shape}
    ex = net.simple_bind(ctx=gpu, grad_req="write", **shapes)
    for name, arr in ex.arg_dict.items():
        arr[:] = args[name] if name in args else (
            x if name == "data" else y)
    for name, arr in ex.aux_dict.items():
        arr[:] = auxs[name]
    ex.forward(is_train=True)
    ex.backward()
    ref_out = ex.outputs[0].data.clone()
    ref_grads = {n: g.data.clone() for n, g in ex.grad_dict.items()}
    ref_aux = {n: a.data.clone() for n, a in ex.aux_dict.items()}
    del ex
    torch.cuda.empty_cache()

    graph = json.loads(net.tojson())
    values = {n: a.copyto(gpu) for n, a in args.items()}
    values["data"] = mx.nd.array(x, ctx=gpu)
    values["softmax_label"] = mx.nd.array(y, ctx=gpu)
    aux = {n: a.copyto(gpu) for n, a in auxs.items()}
    values.update(aux)
    arg_names = net.list_arguments()
    grads = {n: mx.nd.zeros(values[n].shape, ctx=gpu) for n in arg_names}
    mx.autograd.mark_variables([values[n] for n in arg_names],
                               [grads[n] for n in arg_names])
    updater = mx.optimizer.get_updater(mx.optimizer.NAG(
        learning_rate=1e-4, momentum=0.9, wd=1e-4, rescale_grad=1.0 / len(y),
        param_idx2name=dict(enumerate(arg_names))))
    step_ms = []
    for step in range(SURFACE_IMPERATIVE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with mx.autograd.train_section():
            (out,) = _imperative_forward(mx, graph, values)
        mx.autograd.compute_gradient([out])
        if step == 0:
            torch.cuda.synchronize()
            worst = {"output": _rel(torch, out.data, ref_out)}
            worst.update({n: _rel(torch, grads[n].data, g)
                          for n, g in ref_grads.items()})
            worst_aux = {n: _rel(torch, aux[n].data, a)
                         for n, a in ref_aux.items()}
        for i, n in enumerate(arg_names):
            if n not in ("data", "softmax_label"):
                updater(i, grads[n], values[n])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    bad = {n: r for n, r in worst.items() if not r <= TRAIN_PARITY_RTOL}
    bad_aux = {n: r for n, r in worst_aux.items()
               if not r <= SURFACE_AUX_RTOL}
    name = max(worst, key=worst.get)
    aux_name = max(worst_aux, key=worst_aux.get)
    check(not bad, f"imperative against the Executor: {len(bad)} tensors "
          f"beyond {TRAIN_PARITY_RTOL} of their max, e.g. "
          f"{dict(list(bad.items())[:5])}")
    check(not bad_aux, f"imperative moving statistics beyond "
          f"{SURFACE_AUX_RTOL} of their max: "
          f"{dict(list(bad_aux.items())[:5])}")
    moved = (values["fc1_weight"].data - args["fc1_weight"].data).abs().max()
    check(moved.item() > 0
          and bool(torch.isfinite(values["fc1_weight"].data).all()),
          "the NAG step did not move fc1_weight, or made it non-finite")
    res.update({"step_ms": step_ms, "tensors": len(worst),
                "worst": {"tensor": name, "rel": worst[name]},
                "worst_aux": {"tensor": aux_name, "rel": worst_aux[aux_name]}})
    log(f"surface: imperative step ms {step_ms!r} (the first holds the "
        f"comparison's syncs), {len(worst)} tensors against the Executor, "
        f"worst {name} {worst[name]!r}, moving statistics worst {aux_name} "
        f"{worst_aux[aux_name]!r}")
    mx.autograd.set_is_training(False)
    return res


def _surface_lifecycle(torch, mx, net, args, auxs, x, y):
    """fit over a PrefetchingIter with RMSProp, a cosine schedule,
    checkpoint and log callbacks; then Module.load and predict."""
    import shutil

    from mxnet_tpu_torch import passes

    res = {}
    gpu = mx.gpu(0)
    n, b = len(y), TRAIN_BATCH
    tmp = tempfile.mkdtemp(prefix="surface_")
    prefix = os.path.join(tmp, "irv2")
    try:
        def rmsprop(begin=0):
            return {"learning_rate": 1e-4, "gamma1": 0.9,
                    "begin_num_update": begin,
                    "lr_scheduler": mx.lr_scheduler.CosineScheduler(
                        max_update=8, final_lr=1e-5)}

        it = mx.io.PrefetchingIter(mx.io.NDArrayIter(
            x, y, b, shuffle=True, seed=SURFACE_SEED))
        mod = mx.mod.Module(net, context=gpu)
        t0 = time.perf_counter()
        mod.bind(it.provide_data, it.provide_label)
        res["cold_bind_s"] = time.perf_counter() - t0
        seen, step_ends = [], []

        def on_batch(param):
            seen.append((param.epoch,
                         param.locals["batch"].label[0].asnumpy()))
            torch.cuda.synchronize()
            step_ends.append(time.perf_counter())

        metric = mx.metric.create(
            ["acc", mx.metric.TopKAccuracy(top_k=5), "ce"])
        passes.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=SURFACE_EPOCHS, eval_metric=metric,
                optimizer="rmsprop", optimizer_params=rmsprop(),
                arg_params=args, aux_params=auxs,
                epoch_end_callback=mx.callback.module_checkpoint(
                    mod, prefix, save_optimizer_states=True),
                batch_end_callback=[mx.callback.log_train_metric(1),
                                    on_batch])
        it.close()
        fit_launches = passes.launch_counts()
        steps = SURFACE_EPOCHS * (n // b)
        check(len(step_ends) == steps, f"fit ran {len(step_ends)} steps")
        check(sum(fit_launches.values()) == 40 * steps
              and fit_launches["scale_bias_act"] == 39 * steps,
              f"fit's generated-kernel launches {fit_launches}")
        for epoch in range(SURFACE_EPOCHS):
            order = np.concatenate([lab for e, lab in seen if e == epoch])
            want = np.random.Generator(np.random.Philox(
                key=[SURFACE_SEED, epoch])).permutation(n)
            check(np.array_equal(order, want),
                  f"epoch {epoch} order {order} is not Philox(key=[7, "
                  f"{epoch}])'s {want}")
        values = dict(metric.get_name_value())
        check(all(np.isfinite(v) for v in values.values()),
              f"non-finite metrics {values}")
        starts = [t0] + step_ends[:-1]
        step_ms = [(e - s) * 1e3 for s, e in zip(starts, step_ends)]

        t0 = time.perf_counter()
        back = mx.mod.Module.load(prefix, SURFACE_EPOCHS,
                                  load_optimizer_states=True, context=gpu)
        res["load_s"] = time.perf_counter() - t0
        back.bind(it.provide_data, it.provide_label)
        back.init_optimizer(optimizer="rmsprop",
                            optimizer_params=rmsprop(begin=steps))
        with open("%s-%04d.states" % (prefix, SURFACE_EPOCHS), "rb") as f:
            check(back._updater.get_states() == f.read(),
                  "the loaded updater's states differ from the file's")
        pit = mx.io.NDArrayIter(x, y, b)
        want = mod.predict(pit).data
        got = back.predict(pit).data
        check(torch.equal(want, got), "predict after Module.load is not "
              f"bit-identical: {(want - got).abs().max().item()!r}")
        for outs, nbatch, _ in back.iter_predict(pit):
            check(torch.equal(outs[0].data, got[nbatch * b:(nbatch + 1) * b]),
                  f"iter_predict batch {nbatch} differs from predict's rows")
        batch = mx.io.DataBatch([mx.nd.array(x[:b], ctx=gpu)],
                                [mx.nd.array(y[:b], ctx=gpu)])
        for m in (mod, back):
            m.forward_backward(batch)
            m.update()
        pa, pb = mod.get_params()[0], back.get_params()[0]
        worst = max((_rel(torch, pb[k].data, pa[k].data), k) for k in pa)
        check(worst[0] <= TRAIN_PARITY_RTOL,
              f"a step after Module.load: {worst[1]} {worst[0]!r}")
        before = back.predict(pit).data
        back.reshape([("data", (8,) + x.shape[1:])],
                     [("softmax_label", (8,))])
        small = back.predict(mx.io.NDArrayIter(x, y, 8)).data
        reshape_rel = _rel(torch, small, before)
        check(reshape_rel <= SURFACE_RESHAPE_RTOL,
              f"predict at batch 8 after reshape: {reshape_rel!r}")
        launches = passes.launch_counts()
        check(launches["elementwise"] > fit_launches["elementwise"],
              f"no generated kernel in the predicts: {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res.update({"fit_step_ms": step_ms,
                "fit_step_ms_p50": float(np.percentile(step_ms[1:], 50)),
                "metrics": values, "fit_launches": fit_launches,
                "launches": launches, "step_after_load_worst":
                {"tensor": worst[1], "rel": worst[0]},
                "reshape_rel": reshape_rel})
    log(f"surface: fit {steps} steps {step_ms!r} ms, metrics {values}, "
        f"cold bind {res['cold_bind_s']!r} s, load {res['load_s']!r} s, "
        f"launches in fit {fit_launches} and in the phase {launches}, "
        f"a step after load worst {worst[1]} {worst[0]!r}, batch 8 "
        f"predict {reshape_rel!r}")
    return res


def phase_surface(torch, mx, trained, card, examples):
    """The public surface on the card: imperative nd + autograd and the
    Module lifecycle; `examples` holds the unblocked examples' results,
    run beside phase 1's builds (`_start_examples`)."""
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    net = get_inception_resnet_v2(num_classes=1000, dropout=0.0)
    args, auxs = trained
    rs = np.random.RandomState(11)
    x = rs.uniform(-1, 1, (SURFACE_IMAGES, 3, SURFACE_IMAGE,
                           SURFACE_IMAGE)).astype(np.float32)
    y = rs.permutation(SURFACE_IMAGES).astype(np.float32)
    imperative = _surface_imperative(torch, mx, net, args, auxs,
                                     x[:TRAIN_BATCH], y[:TRAIN_BATCH])
    torch.cuda.empty_cache()
    lifecycle = _surface_lifecycle(torch, mx, net, args, auxs, x,
                                   np.arange(SURFACE_IMAGES,
                                             dtype=np.float32))
    torch.cuda.empty_cache()
    summary = {
        "imperative_step_ms": imperative["step_ms"][-1],
        "imperative_worst_rel": imperative["worst"]["rel"],
        "imperative_worst_aux_rel": imperative["worst_aux"]["rel"],
        "fit_step_ms_p50": lifecycle["fit_step_ms_p50"],
        "cold_bind_s": lifecycle["cold_bind_s"],
        "load_s": lifecycle["load_s"],
        "examples_s": examples["seconds"],
        "examples_process_s": examples["process_s"],
        "card": card}
    log("phase 11 ok: imperative autograd against the Executor and the "
        "Module lifecycle on the card; the unblocked examples passed "
        "beside phase 1")
    return {"imperative": imperative, "lifecycle": lifecycle,
            "examples": examples, "summary": summary}


# ----------------------------------------------------------- phase 12
def _lm_batches(mx, n_batches):
    """Synthetic token ids from seed 0 with a learnable pattern: every
    sequence walks one fixed cycle through LM_CYCLE of the vocabulary's
    ids from a random place on it, and each token's label is the next
    one, so later batches repeat what earlier ones taught."""
    v, t = LM_CFG["vocab_size"], LM_CFG["seq_len"]
    rs = np.random.RandomState(0)
    cycle = rs.permutation(v)[:LM_CYCLE]
    pos = rs.randint(0, len(cycle), (n_batches * LM_BATCH, 1)) \
        + np.arange(t + 1)[None, :]
    tokens = cycle[pos % len(cycle)].astype(np.float32)
    return mx.io.NDArrayIter(tokens[:, :-1], tokens[:, 1:],
                             batch_size=LM_BATCH, shuffle=False)


def _lm_unpack(torch, blob, input_size, h, layers):
    """(w_ih, w_hh, b_ih, b_hh) per layer of a packed one-direction LSTM
    blob: every weight matrix first, layer by layer, then every bias."""
    off, ws = 0, []
    for layer in range(layers):
        n_in = input_size if layer == 0 else h
        w_ih = blob[off:off + 4 * h * n_in].view(4 * h, n_in)
        off += 4 * h * n_in
        w_hh = blob[off:off + 4 * h * h].view(4 * h, h)
        off += 4 * h * h
        ws.append([w_ih, w_hh])
    for layer in range(layers):
        ws[layer] += [blob[off:off + 4 * h], blob[off + 4 * h:off + 8 * h]]
        off += 8 * h
    check(off == blob.numel(), f"LSTM blob of {blob.numel()} != {off}")
    return ws


def _lm_reference(torch, args, x, y):
    """The model's first training step at dropout 0 in plain torch, from
    the phase's own code: embedding lookup, two LSTM layers step by
    step, the dense head, softmax; SoftmaxOutput's gradient
    (prob - onehot) fed back through autograd."""
    F = torch.nn.functional
    h, v = LM_CFG["num_hidden"], LM_CFG["vocab_size"]
    leaves = {n: a.data.detach().clone().requires_grad_(True)
              for n, a in args.items()}
    seq = leaves["embed_weight"][x.long()].transpose(0, 1)   # (T, N, E)
    for w_ih, w_hh, b_ih, b_hh in _lm_unpack(
            torch, leaves["lstm_parameters"], LM_CFG["num_embed"], h,
            LM_CFG["num_layers"]):
        xp = seq @ w_ih.t() + b_ih
        hs = torch.zeros(x.shape[0], h, device=x.device)
        cs = torch.zeros_like(hs)
        outs = []
        for t in range(xp.shape[0]):
            i, f, g, o = (xp[t] + hs @ w_hh.t() + b_hh).chunk(4, dim=1)
            cs = torch.sigmoid(f) * cs + torch.sigmoid(i) * torch.tanh(g)
            hs = torch.sigmoid(o) * torch.tanh(cs)
            outs.append(hs)
        seq = torch.stack(outs)
    logits = F.linear(seq.transpose(0, 1).reshape(-1, h),
                      leaves["pred_weight"], leaves["pred_bias"])
    prob = torch.softmax(logits, dim=-1)
    hot = F.one_hot(y.reshape(-1).long(), v).to(prob.dtype)
    logits.backward(prob.detach() - hot)
    return prob.detach(), {n: t.grad for n, t in leaves.items()}


def _lm_rel(a, b):
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()


def _lm_time(torch, fn, reps=LM_TIME_REPS):
    """Median host ms of fn() ended by a synchronize, after one warm
    call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _lm_rnn_case(torch, mode, input_size, state_size, num_layers,
                 bidirectional, seq_len, batch, seed):
    """The RNN op on the card (cuDNN) against its plain version on the
    same card tensors: outputs, final states and the gradients of the
    data, the blob and the begin states for one random head each."""
    from mxnet_tpu_torch.ops import rnn_op

    gen = torch.Generator(device=LM_DEVICE).manual_seed(seed)
    dirs = 2 if bidirectional else 1
    entries, total = rnn_op.param_layout(input_size, state_size, num_layers,
                                         bidirectional, mode)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=LM_DEVICE)
                * scale).requires_grad_(True)

    ins = [rand(seq_len, batch, input_size),
           rand(total, scale=1.0 / state_size ** 0.5),
           rand(num_layers * dirs, batch, state_size, scale=0.5)]
    if mode == "lstm":
        ins.append(rand(num_layers * dirs, batch, state_size, scale=0.5))
    params = dict(state_size=state_size, mode=mode, num_layers=num_layers,
                  bidirectional=bidirectional, state_outputs=True)

    def cudnn():
        return rnn_op.rnn(*ins, **params, is_train=True)

    def plain():
        state = ins[2]
        cell = ins[3] if mode == "lstm" else None
        out = rnn_op.rnn_plain(ins[0], ins[1], state, cell, entries,
                               num_layers, dirs, mode, is_train=True)
        return out if mode == "lstm" else out[:2]

    results = []
    for route in (cudnn, plain):
        outs = route()
        heads = [torch.randn(o.shape, generator=torch.Generator(
            device=LM_DEVICE).manual_seed(seed + k), device=LM_DEVICE)
            for k, o in enumerate(outs)]
        grads = torch.autograd.grad(outs, ins, heads)
        results.append([o.detach() for o in outs] + list(grads))
    names = (["output", "h_n", "c_n"] if mode == "lstm"
             else ["output", "h_n"]) + ["d_data", "d_parameters", "d_state"] \
        + (["d_state_cell"] if mode == "lstm" else [])
    worst = {n: _lm_rel(a, b) for n, a, b in zip(names, *results)}
    bad = {n: r for n, r in worst.items() if not r <= LM_PARITY_RTOL}
    check(not bad, f"RNN {mode} ({'bi' if bidirectional else 'uni'}"
          f"directional, H {state_size}) cuDNN against its plain version: "
          f"{bad} beyond {LM_PARITY_RTOL}")

    def step(route):
        def run():
            outs = route()
            torch.autograd.backward(outs[0], torch.ones_like(outs[0]))
        return run

    row = {"mode": mode, "bidirectional": bidirectional,
           "input_size": input_size, "state_size": state_size,
           "num_layers": num_layers, "seq_len": seq_len, "batch": batch,
           "worst": max(worst.values()), "worst_tensor": max(
               worst, key=worst.get),
           "cudnn_fwd_bwd_ms": _lm_time(torch, step(cudnn)),
           "plain_fwd_bwd_ms": _lm_time(torch, step(plain))}
    log(f"lm: RNN {mode} {'bi' if bidirectional else 'uni'}directional "
        f"({seq_len}, {batch}, {input_size}) H {state_size} x{num_layers}: "
        f"cuDNN against plain worst {row['worst_tensor']} "
        f"{row['worst']!r}; forward+backward {row['cudnn_fwd_bwd_ms']!r} "
        f"ms, plain {row['plain_fwd_bwd_ms']!r} ms (host clock)")
    return row


def _lm_weight_copy(torch):
    """What the views cost: the op's cuDNN forward (weights as views of
    the blob, which torch packs into one buffer at each call) against
    torch.nn.LSTM's on the same weights held in cuDNN's own packed
    buffer, at the model's width, forward alone and with its
    backward."""
    from mxnet_tpu_torch.ops import rnn_op

    e, h, layers = LM_CFG["num_embed"], LM_CFG["num_hidden"], \
        LM_CFG["num_layers"]
    t, n = LM_CFG["seq_len"], LM_BATCH
    gen = torch.Generator(device=LM_DEVICE).manual_seed(5)
    entries, total = rnn_op.param_layout(e, h, layers, False, "lstm")
    blob = (torch.randn(total, generator=gen, device=LM_DEVICE) * 0.02
            ).requires_grad_(True)
    x = torch.randn(t, n, e, generator=gen, device=LM_DEVICE)
    h0 = torch.zeros(layers, n, h, device=LM_DEVICE)
    ref = torch.nn.LSTM(e, h, layers).to(LM_DEVICE)
    with torch.no_grad():
        for layer in range(layers):
            for p, w in zip(("weight_ih", "weight_hh", "bias_ih", "bias_hh"),
                            rnn_op.layer_weights(blob, entries, layer, 0)):
                getattr(ref, f"{p}_l{layer}").copy_(w)
    ref.flatten_parameters()
    params = dict(state_size=h, mode="lstm", num_layers=layers)

    def views():
        return rnn_op.rnn(x, blob, h0, h0, **params, is_train=True)

    def packed():
        return ref(x, (h0, h0))[0]

    check(_lm_rel(views(), packed()) <= LM_PARITY_RTOL,
          "the op's cuDNN forward differs from torch.nn.LSTM's")

    def fwd(fn):
        def run():
            with torch.no_grad():
                fn()
        return run

    def fwd_bwd(fn):
        def run():
            out = fn()
            out.backward(torch.ones_like(out))
        return run

    res = {"views_fwd_ms": _lm_time(torch, fwd(views)),
           "packed_fwd_ms": _lm_time(torch, fwd(packed)),
           "views_fwd_bwd_ms": _lm_time(torch, fwd_bwd(views)),
           "packed_fwd_bwd_ms": _lm_time(torch, fwd_bwd(packed)),
           "blob_bytes": total * 4}
    log(f"lm: weight views against a packed buffer ({total * 4} B of "
        f"weights): forward {res['views_fwd_ms']!r} against "
        f"{res['packed_fwd_ms']!r} ms, forward+backward "
        f"{res['views_fwd_bwd_ms']!r} against {res['packed_fwd_bwd_ms']!r}"
        f" ms (host clock, medians of {LM_TIME_REPS})")
    return res


def _lm_card_quirks(torch, mx):
    """Embedding's NaN row for an out-of-range id and the tie orders of
    argsort and topk, on the card; no device-side assert fires."""
    gpu = mx.gpu(0)
    v, e = LM_CFG["vocab_size"], 8
    w = np.arange(v * e, dtype=np.float32).reshape(v, e)
    ids = np.array([3, v, -1, v + 1.5, -v - 1], np.float32)
    out = mx.nd.Embedding(mx.nd.array(ids, ctx=gpu), mx.nd.array(w, ctx=gpu),
                          input_dim=v, output_dim=e).asnumpy()
    torch.cuda.synchronize()
    check(np.array_equal(out[0], w[3]) and np.array_equal(out[2], w[-1])
          and np.isnan(out[[1, 3, 4]]).all(),
          f"Embedding on the card: rows {out[:, 0]}")
    x = mx.nd.array(np.array([[1, 3, 1, 3, 2, 1]], np.float32), ctx=gpu)
    ties = {"argsort_descending": mx.nd.argsort(x, is_ascend=False),
            "topk_3": mx.nd.topk(x, k=3),
            "topk_4_ascending": mx.nd.topk(x, k=4, is_ascend=True)}
    want = {"argsort_descending": [[3, 1, 4, 5, 2, 0]],
            "topk_3": [[1, 3, 4]], "topk_4_ascending": [[0, 2, 5, 4]]}
    got = {k: a.asnumpy().tolist() for k, a in ties.items()}
    check(got == want, f"tie orders on the card {got}, want {want}")
    log(f"lm: Embedding rows for ids {ids.tolist()}: "
        f"{['nan' if np.isnan(r[0]) else int(r[0]) // e for r in out]}; "
        f"tie orders on the card {got}")
    return {"embedding_nan_rows": 3, "ties": got}


def phase_lm(torch, mx):
    """The LSTM language model at PTB-large width through Module."""
    from mxnet_tpu_torch import passes
    from mxnet_tpu_torch.models import get_lstm_lm

    res = {}
    data = _lm_batches(mx, LM_STEPS)
    shapes = (data.provide_data, data.provide_label)
    first = next(iter(data))
    data.reset()

    # (1) the first step at dropout 0 against the plain composition
    net0 = get_lstm_lm(**LM_CFG, dropout=0.0)[0]
    mod0 = mx.mod.Module(net0, context=mx.gpu(0))
    t0 = time.perf_counter()
    mod0.bind(*shapes)
    res["cold_bind_s"] = time.perf_counter() - t0
    mx.random.seed(0)
    t0 = time.perf_counter()
    mod0.init_params(initializer=mx.init.Xavier())
    res["init_s"] = time.perf_counter() - t0
    exe = mod0._exec_group.execs[0]
    args = {n: a for n, a in exe.arg_dict.items()
            if n not in ("data", "softmax_label")}
    res["params"] = int(sum(a.size for a in args.values()))
    mod0.forward_backward(first)
    out = exe.outputs[0].data
    ref_out, ref_grads = _lm_reference(
        torch, args, first.data[0].data.to(LM_DEVICE), first.label[0].data.to(LM_DEVICE))
    worst = {"output": _lm_rel(out, ref_out)}
    worst.update({n: _lm_rel(exe.grad_dict[n].data, g)
                  for n, g in ref_grads.items()})
    bad = {n: r for n, r in worst.items() if not r <= LM_PARITY_RTOL}
    check(not bad, f"LM first step against the plain composition: {bad} "
          f"beyond {LM_PARITY_RTOL} of each tensor's max")
    res["module_vs_plain"] = worst
    log(f"lm: {res['params']} parameters, cold bind {res['cold_bind_s']!r}"
        f" s, init {res['init_s']!r} s; first step (dropout 0) against the "
        f"plain composition: {json.dumps(worst)}")
    trained0, _ = mod0.get_params()
    del mod0, exe, ref_grads, args
    torch.cuda.empty_cache()

    # (2) the RNN op's cuDNN route against its plain version
    res["rnn_rows"] = [
        _lm_rnn_case(torch, "lstm", LM_CFG["num_embed"], LM_CFG["num_hidden"],
                     LM_CFG["num_layers"], False, LM_CFG["seq_len"],
                     LM_BATCH, 1),
        _lm_rnn_case(torch, "gru", bidirectional=False, seq_len=LM_CFG[
            "seq_len"], batch=LM_BATCH, seed=2, **LM_SMALL),
        _lm_rnn_case(torch, "lstm", bidirectional=True, seq_len=LM_CFG[
            "seq_len"], batch=LM_BATCH, seed=3, **LM_SMALL)]
    res["weight_copy"] = _lm_weight_copy(torch)
    torch.cuda.empty_cache()

    # (3) Embedding and the ordering ops on the card
    res["card_quirks"] = _lm_card_quirks(torch, mx)

    # (4) ten training steps at dropout 0.65
    net = get_lstm_lm(**LM_CFG, dropout=LM_DROPOUT)[0]
    mod = mx.mod.Module(net, context=mx.gpu(0))
    passes.reset_launch_counts()
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mod.bind(*shapes)
    res["bind_s"] = time.perf_counter() - t0
    plan = mod._exec_group.execs[0]._codegen_plan
    res["fusion_groups"] = len(plan.cache_component)
    mod.set_params(trained0, {})
    mod.init_optimizer(optimizer="sgd", optimizer_params=LM_OPT)
    metric = mx.metric.Perplexity(0)
    ppl, step_ms = [], []
    torch.cuda.synchronize()
    for batch in data:
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metric.reset()
        mod.update_metric(metric, batch.label)
        ppl.append(float(metric.get()[1]))
    launches = passes.launch_counts()
    check(len(step_ms) == LM_STEPS, f"ran {len(step_ms)} steps")
    check(all(np.isfinite(ppl)), f"perplexity {ppl}")
    check(ppl[-1] < ppl[0], f"perplexity did not fall: {ppl}")
    steady = step_ms[1:]
    tokens = LM_BATCH * LM_CFG["seq_len"]
    res.update({
        "step_ms": step_ms,
        "step_ms_p50": float(np.percentile(steady, 50)),
        "step_ms_p95": float(np.percentile(steady, 95)),
        "tokens_per_s": tokens * len(steady) / (sum(steady) / 1e3),
        "peak_mem_bytes": torch.cuda.max_memory_allocated() - base_bytes,
        "perplexity": ppl, "b1_b2_launches": launches})
    log(f"lm: {LM_STEPS} steps at dropout {LM_DROPOUT}: bind "
        f"{res['bind_s']!r} s, {res['fusion_groups']} fusion groups, B1/B2 "
        f"launches {launches}; first step {step_ms[0]!r} ms, steady p50 "
        f"{res['step_ms_p50']!r} ms p95 {res['step_ms_p95']!r} ms, "
        f"{res['tokens_per_s']!r} tokens/s, peak memory "
        f"{res['peak_mem_bytes']} B above the process's before the bind; "
        f"perplexity step 1 {ppl[0]!r}, step "
        f"{LM_STEPS} {ppl[-1]!r}")
    del mod
    torch.cuda.empty_cache()
    log("phase 12 ok: the PTB-large LSTM language model trains through "
        "Module on cuDNN's RNN")
    return res

# ----------------------------------------------------------- phase 13
def _ssd_batch(torch, step, batch, dev):
    """`batch` dark images with 1-8 bright rectangles each, painted as
    examples/ssd/train_ssd_toy.py paints its squares, and their labels
    (batch, SSD_GT_ROWS, 5) [class, x1, y1, x2, y2] with class -1 rows
    padding. The boxes come from numpy (seed SSD_SEED + step), the pixels
    from a seeded generator on `dev`."""
    side = SSD_IMAGE
    rs = np.random.RandomState(SSD_SEED + step)
    label = np.full((batch, SSD_GT_ROWS, 5), -1.0, np.float32)
    for i, n in enumerate(rs.randint(1, 9, batch)):
        wh = rs.randint(side // 10, side // 2, (n, 2))
        lo = rs.randint(0, side - wh)
        label[i, :n, 0] = rs.randint(0, SSD_CLASSES, n)
        label[i, :n, 1:3] = lo / side
        label[i, :n, 3:5] = (lo + wh) / side
    gen = torch.Generator(device=dev).manual_seed(SSD_SEED + step)
    x = torch.rand((batch, 3, side, side), generator=gen, device=dev) * 0.1
    lab = torch.from_numpy(label).to(dev)
    pix = torch.arange(side, dtype=torch.float32, device=dev)
    px = lab[..., 1:] * side
    in_x = (pix >= px[..., 0, None]) & (pix < px[..., 2, None])
    in_y = (pix >= px[..., 1, None]) & (pix < px[..., 3, None])
    box = (in_y[..., :, None] & in_x[..., None, :]
           & (lab[..., 0] >= 0)[..., None, None]).any(1)
    return torch.where(box[:, None], torch.ones_like(x), x), lab


def _ssd_anchors(torch, dev):
    """The training graph's anchors (1, 117,976, 4): MultiBoxPrior over
    the three feature maps (150, 75 and 37 a side at 300x300)."""
    from mxnet_tpu_torch.models import ssd
    from mxnet_tpu_torch.ops import registry as treg

    prior, side, out = treg.get("MultiBoxPrior"), SSD_IMAGE, []
    for sizes, ratios in zip(ssd._DEFAULT_SIZES, ssd._DEFAULT_RATIOS):
        side //= 2
        out.append(prior.fn(torch.empty((1, 1, side, side), device=dev),
                            sizes=sizes, ratios=ratios, clip=True))
    return torch.cat(out, 1)


def _event_ms(torch, fn, reps=VISION_REPS, warm=True):
    """Median device ms of fn over `reps` calls, each between its own
    pair of CUDA events, after one warm call unless `warm` is false."""
    if warm:
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


class _NmsRecorder:
    """Stands in for ops.vision.nms while the phase reads a run's
    candidates: keeps the last call's arguments and result and calls the
    wrapper through (its launches count as usual)."""

    def __init__(self, tvision):
        self._mod, self._nms = tvision, tvision.nms
        self.args = self.keep = None

    def __enter__(self):
        self._mod.nms = self
        return self

    def __exit__(self, *exc):
        self._mod.nms = self._nms

    def __call__(self, *args):
        self.args = args
        self.keep = self._nms(*args)
        return self.keep


def _ssd_targets_card_vs_cpu(torch, dev, lab):
    """MultiBoxTarget on the card and on the CPU, the same inputs through
    the port, at the parity batch."""
    from mxnet_tpu_torch.ops import nms as tnms
    from mxnet_tpu_torch.ops import registry as treg

    op = treg.get("MultiBoxTarget")
    params = op.normalize_params({"overlap_threshold": 0.5,
                                  "ignore_label": -1,
                                  "negative_mining_ratio": 3.0})
    anchors = _ssd_anchors(torch, dev)
    gen = torch.Generator(device=dev).manual_seed(SSD_SEED)
    cls_pred = torch.randn((lab.shape[0], SSD_CLASSES + 1, anchors.shape[1]),
                           generator=gen, device=dev)
    card = op.fn(anchors, lab, cls_pred, **params)
    cpu = op.fn(anchors.cpu(), lab.cpu(), cls_pred.cpu(), **params)
    iou = tnms.iou_matrix(anchors[0].cpu(), lab[..., 1:5].cpu())
    iou = torch.where((lab[..., 0] >= 0).cpu()[:, None, :], iou,
                      torch.full_like(iou, -1.0))
    near = (iou.amax(2) - 0.5).abs() < SSD_NEAR_HALF         # (B, A)
    differ = (card[2].cpu() != cpu[2]) | (
        card[1].cpu() != cpu[1]).reshape(near.shape + (4,)).any(-1)
    check(not (differ & ~near).any(),
          f"MultiBoxTarget: {int((differ & ~near).sum())} anchors differ "
          "on the card from the CPU away from the 0.5 threshold")
    keep4 = ~near.repeat_interleave(4, 1)
    loc_err = ((card[0].cpu() - cpu[0]).abs() * keep4).max().item()
    scale = cpu[0].abs().max().item()
    check(loc_err <= SSD_TARGET_TOL * scale,
          f"MultiBoxTarget loc_target: card against CPU {loc_err!r} beyond "
          f"{SSD_TARGET_TOL} of its max {scale!r}")
    return {"anchors": int(anchors.shape[1]),
            "near_half_anchors": int(near.sum()),
            "differing_anchors": int(differ.sum()),
            "positives": int((cpu[2] > 0).sum()),
            "loc_target_err_rel": loc_err / max(scale, 1e-30)}


def _ssd_step_card_vs_cpu(torch, mx, net, ctx, dev):
    """The first SGD step's outputs and gradients at the parity batch:
    a bind on the card and one on the CPU from the same initial weights
    and batch."""
    b = SSD_PARITY_BATCH
    x, lab = _ssd_batch(torch, 0, b, dev)
    shapes = ([("data", (b, 3, SSD_IMAGE, SSD_IMAGE))],
              [("label", (b, SSD_GT_ROWS, 5))])
    runs = {}
    for name, c, xs, ls in (("card", ctx, x, lab),
                            ("cpu", mx.cpu(), x.cpu(), lab.cpu())):
        mod = mx.mod.Module(net, label_names=["label"], context=c)
        mod.bind(*shapes)
        if name == "card":
            mx.random.seed(SSD_SEED)
            mod.init_params(initializer=mx.init.Xavier())
            init = mod.get_params()
        else:
            mod.init_params(arg_params=init[0], aux_params=init[1])
        mod.forward(mx.io.DataBatch([mx.nd.NDArray(xs, ctx=c)],
                                    [mx.nd.NDArray(ls, ctx=c)]),
                    is_train=True)
        mod.backward()
        exe = mod._exec_group.execs[0]
        runs[name] = ([o.data.cpu() for o in exe.outputs],
                      {n: g.data.cpu() for n, g in exe.grad_dict.items()
                       if g is not None and exe._grad_req.get(n) != "null"})
        del mod, exe
    (co, cg), (po, pg) = runs["card"], runs["cpu"]
    worst = {f"output{i}": _lm_rel(a, b) for i, (a, b) in
             enumerate(zip(co, po))}
    worst.update({n: _lm_rel(cg[n], g) for n, g in pg.items()})
    bad = {n: r for n, r in worst.items() if not r <= SSD_PARITY_RTOL}
    check(not bad, f"SSD first step, card against CPU: {bad} beyond "
          f"{SSD_PARITY_RTOL} of each tensor's max")
    res = {"step_worst": max(worst.values()),
           "step_worst_tensor": max(worst, key=worst.get)}
    res.update(_ssd_targets_card_vs_cpu(torch, dev, lab))
    return res


def _nms_bound(torch, keep, valid, cls, force):
    """V1's bound for one call from its result: each valid candidate
    tested against each kept box before it of its class (of any class
    under force_suppress), NMS_PAIR_OPS a pair on float32 SIMT, or each
    candidate's box, class, valid flag and keep byte moved once.
    `bound_ms_all_pairs` counts the kept boxes of every class."""
    n = valid.sum(1, keepdim=True)
    idx = torch.arange(keep.shape[1], device=keep.device)[None, :]
    pairs_all = float(torch.where(keep, n - 1 - idx,
                                  torch.zeros_like(idx)).sum())
    pairs = pairs_all
    if not force:
        pairs = 0.0
        for c in torch.unique(cls[valid]).tolist():
            member = valid & (cls == c)
            kept = (keep & member).long()
            pairs += float(((kept.cumsum(1) - kept) * member).sum())
    byte_s = keep.numel() * (16 + 4 + 1 + 1) / HBM_BYTES_PER_S
    out = {}
    for key, p in (("", pairs), ("_all_pairs", pairs_all)):
        op_s = NMS_PAIR_OPS * p / FP32_FLOPS_PER_S
        out.update({f"bound_ms{key}": max(op_s, byte_s) * 1e3,
                    f"pairs{key}": p,
                    f"bound_by{key}": "operations" if op_s >= byte_s
                    else "bytes"})
    return out


def _nms_segments(torch, keep, valid, cls, force):
    """The kernel's segments in one call: how many hold a member, and the
    most members and kept boxes one holds."""
    if force:
        members, kept = valid.sum(1), keep.sum(1)
    else:
        lo = int(cls.min())
        span = int(cls.max()) - lo + 1
        slot = (cls - lo) + span * torch.arange(
            cls.shape[0], device=cls.device)[:, None]
        size = cls.shape[0] * span
        members = torch.bincount(slot[valid], minlength=size)
        kept = torch.bincount(slot[keep], minlength=size)
    return {"segments": int((members > 0).sum()),
            "most_members": int(members.max()), "most_kept": int(kept.max())}


def _nms_greedy_check(torch, tnms, boxes, cls, valid, thresh, force, keep):
    """Every keep bit of a V1 call held exactly against the property that
    defines greedy NMS: keep[i] is valid[i] and no kept j < i of i's class
    (of any class under force_suppress) has IoU > thresh with i. One keep
    vector has it (induction over i), so this checks all of them without
    nms_plain's dense K x K IoU (55.7 GB an image at 117,976): each
    image's candidates against its kept boxes, NMS_CHECK_ROWS at a time,
    in the same IoU arithmetic (iou_matrix; the IoU is symmetric bit for
    bit). Returns the differing bits and the pairs tested."""
    bad = torch.zeros((), dtype=torch.int64, device=keep.device)
    pairs, k = 0, keep.shape[1]
    for b in range(keep.shape[0]):
        kept = keep[b].nonzero().squeeze(1)
        kb, kc = boxes[b, kept], cls[b, kept]
        pairs += k * kept.numel()
        for r0 in range(0, k, NMS_CHECK_ROWS):
            r1 = min(r0 + NMS_CHECK_ROWS, k)
            rows = torch.arange(r0, r1, device=keep.device)
            sup = (tnms.iou_matrix(boxes[b, r0:r1], kb) > thresh) \
                & (kept[None, :] < rows[:, None])
            if not force:
                sup &= cls[b, r0:r1, None] == kc[None, :]
            want = valid[b, r0:r1] & ~sup.any(1)
            bad += (want != keep[b, r0:r1]).sum()
    return {"differing_bits": int(bad), "pairs": pairs}


def _ssd_detection(torch, mx, ctx, dev, trained, x):
    """get_ssd_detect with the trained weights at the training batch:
    every anchor through MultiBoxDetection and V1."""
    from mxnet_tpu_torch.models import get_ssd_detect
    from mxnet_tpu_torch.ops import nms as tnms
    from mxnet_tpu_torch.ops import vision as tvision

    res = {}
    det = mx.mod.Module(get_ssd_detect(num_classes=SSD_CLASSES),
                        label_names=None, context=ctx)
    det.bind(data_shapes=[("data", tuple(x.shape))], for_training=False)
    det.set_params(*trained, allow_missing=True)
    batch = mx.io.DataBatch([mx.nd.NDArray(x, ctx=ctx)], [])
    tnms.reset_launch_counts()
    with _NmsRecorder(tvision) as rec:
        det.forward(batch, is_train=False)
        out = det.get_outputs()[0].data
        torch.cuda.synchronize()
    res["nms_launches"] = tnms.nms.launches
    res["nms_groups"] = tnms.nms.groups
    res["nms_scratch_peak_bytes"] = tnms.nms.peak_scratch_bytes
    check(res["nms_launches"] > 0, "detection launched no NMS kernel")
    check(res["nms_groups"] == 1, f"V1 took the detection's images in "
          f"{res['nms_groups']} groups, not one")
    check(res["nms_scratch_peak_bytes"] < NMS_SCRATCH_LIMIT,
          f"V1's scratch {res['nms_scratch_peak_bytes']} B is not under "
          f"{NMS_SCRATCH_LIMIT} B")
    check(tuple(out.shape) == (x.shape[0], SSD_ANCHORS, 6),
          f"detection output {tuple(out.shape)}")
    check(bool(torch.isfinite(out).all()), "non-finite detection output")
    kept = (out[..., 0] >= 0).sum(1).tolist()
    res["kept_rows"] = {"min": min(kept), "median": float(np.median(kept)),
                        "max": max(kept)}

    times = []              # the counted forward above was the warm one
    for _ in range(SSD_FORWARD_REPS):
        t0 = time.perf_counter()
        det.forward(batch, is_train=False)
        det.get_outputs()[0].data.sum()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    res["forward_ms"] = float(np.median(times))
    boxes, cls, valid, thresh, force = rec.args
    keep = rec.keep
    if NMS_SAVE:
        os.makedirs(os.path.dirname(os.path.abspath(NMS_SAVE)),
                    exist_ok=True)
        torch.save({"detection": [a.cpu() if torch.is_tensor(a) else a
                                  for a in rec.args]}, NMS_SAVE)
    res["valid_candidates"] = valid.sum(1).tolist()
    res["nms_ms"] = _event_ms(torch, lambda: tnms.nms(*rec.args),
                              reps=SSD_FORWARD_REPS, warm=False)
    bound = _nms_bound(torch, keep, valid, cls, force)
    res.update({"nms_bound_ms": bound["bound_ms"],
                "nms_bound_by": bound["bound_by"],
                "nms_pairs": bound["pairs"],
                "nms_bound_ms_all_pairs": bound["bound_ms_all_pairs"],
                "nms_pairs_all": bound["pairs_all_pairs"],
                "nms_segments": _nms_segments(torch, keep, valid, cls,
                                              force)})
    # every keep bit of the counted call, at the detection's full shape
    t0 = time.perf_counter()
    res["nms_greedy_check"] = _nms_greedy_check(torch, tnms, *rec.args, keep)
    res["nms_greedy_check"]["s"] = time.perf_counter() - t0
    diff = res["nms_greedy_check"]["differing_bits"]
    check(diff == 0, f"V1 at {tuple(keep.shape)}: {diff} keep bits break "
          "greedy NMS")
    # V1 against nms_plain on image 0's first candidates
    res["nms_vs_plain"] = {}
    for k in NMS_CHECK_K:
        a = (boxes[:1, :k], cls[:1, :k], valid[:1, :k], thresh, force)
        got = tnms.nms(*a)
        want = tnms.nms_plain(*a)
        diff = int((got != want).sum())
        check(diff == 0, f"V1 against nms_plain at {k} candidates: {diff} "
              "keep bits differ")
        res["nms_vs_plain"][k] = {"differing_bits": diff,
                                  "kept": int(want.sum())}
    k = NMS_CHECK_K[0]
    a = (boxes[:1, :k], cls[:1, :k], valid[:1, :k], thresh, force)
    res["nms_ms_small"] = _event_ms(torch, lambda: tnms.nms(*a))
    res["nms_plain_ms_small"] = _event_ms(torch, lambda: tnms.nms_plain(*a),
                                         reps=1)
    res["nms_bound_small"] = _nms_bound(torch, tnms.nms(*a), a[2], a[1],
                                        force)
    del det, out
    return res


def _rpn(torch, dev):
    """Faster R-CNN's Proposal at the reference's defaults on a 600x1000
    image's conv5 map, then ROIPooling of its 300 rois to 7x7."""
    from mxnet_tpu_torch.ops import nms as tnms
    from mxnet_tpu_torch.ops import registry as treg
    from mxnet_tpu_torch.ops import vision as tvision

    res = {}
    h, w = RPN_MAP
    k = 12
    gen = torch.Generator(device=dev).manual_seed(SSD_SEED)
    cls_prob = torch.rand((1, 2 * k, h, w), generator=gen, device=dev)
    bbox = torch.randn((1, 4 * k, h, w), generator=gen, device=dev) * 0.1
    im_info = torch.tensor([RPN_IM_INFO], device=dev)
    prop = treg.get("Proposal")
    params = prop.normalize_params({})
    with _NmsRecorder(tvision) as rec:
        rois = prop.fn(cls_prob, bbox, im_info, **params)
        torch.cuda.synchronize()
    check(tuple(rois.shape) == (params["rpn_post_nms_top_n"], 5),
          f"Proposal rois {tuple(rois.shape)}")
    check(bool(torch.isfinite(rois).all()), "non-finite rois")
    plain = tnms.nms_plain(*rec.args)
    diff = int((plain != rec.keep).sum())
    check(diff == 0, f"Proposal: V1 and nms_plain differ in {diff} bits")
    _, pcls, pvalid, _, pforce = rec.args
    if NMS_SAVE:
        saved = torch.load(NMS_SAVE)
        saved["proposal"] = [a.cpu() if torch.is_tensor(a) else a
                             for a in rec.args]
        torch.save(saved, NMS_SAVE)
    res.update({"anchors": h * w * k, "kept": int(rec.keep.sum()),
                "nms_differing_bits": diff,
                "nms_ms": _event_ms(torch, lambda: tnms.nms(*rec.args)),
                "nms_bound": _nms_bound(torch, rec.keep, pvalid, pcls,
                                        pforce),
                "proposal_ms": _event_ms(torch, lambda: prop.fn(
                    cls_prob, bbox, im_info, **params))})
    data = torch.randn((1, RPN_CHANNELS, h, w), generator=gen, device=dev)
    pool = treg.get("ROIPooling")
    pp = pool.normalize_params({"pooled_size": ROI_POOLED,
                                "spatial_scale": 1.0 / 16})
    card = pool.fn(data, rois, **pp)
    cpu = pool.fn(data.cpu(), rois.cpu(), **pp)
    check(torch.equal(card.cpu(), cpu),
          "ROIPooling: card and CPU not bit-identical")
    res.update({"roi_pool_shape": list(card.shape),
                "roi_pool_ms": _event_ms(torch,
                                         lambda: pool.fn(data, rois, **pp)),
                "roi_pool_empty_bins": int((card == 0).sum())})
    return res


def phase_vision(torch, mx):
    """SSD at 300x300 (training and detection) and Faster R-CNN's RPN,
    through the vision ops and V1 on the card."""
    from mxnet_tpu_torch import passes
    from mxnet_tpu_torch.models import get_ssd_train
    from mxnet_tpu_torch.ops import registry as treg

    dev = torch.device(VISION_DEVICE)
    ctx = mx.gpu(0) if VISION_DEVICE == "cuda" else mx.cpu()
    res = {"parts_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        res["parts_s"][name] = now - t_part
        t_part = now

    net = get_ssd_train(num_classes=SSD_CLASSES)
    res["card_vs_cpu"] = _ssd_step_card_vs_cpu(torch, mx, net, ctx, dev)
    part("card_vs_cpu")
    log(f"vision: batch {SSD_PARITY_BATCH} on the card against the CPU: "
        f"{json.dumps(res['card_vs_cpu'])}")
    torch.cuda.empty_cache()

    # ten SGD steps at batch 32
    batches = [_ssd_batch(torch, s + 1, SSD_BATCH, dev)
               for s in range(SSD_STEPS)]
    shapes = ([("data", tuple(batches[0][0].shape))],
              [("label", tuple(batches[0][1].shape))])
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mod = mx.mod.Module(net, label_names=["label"], context=ctx)
    t0 = time.perf_counter()
    mod.bind(*shapes)
    res["cold_bind_s"] = time.perf_counter() - t0
    exe = mod._exec_group.execs[0]
    res["fusion_groups"] = [list(g) for g in exe._codegen_plan.cache_component]
    res["params"] = int(sum(a.size for n, a in exe.arg_dict.items()
                            if n not in ("data", "label")))
    mx.random.seed(SSD_SEED)
    mod.init_params(initializer=mx.init.Xavier())
    anchors = _ssd_anchors(torch, dev)
    target = treg.get("MultiBoxTarget")
    tp = target.normalize_params({"overlap_threshold": 0.5,
                                  "ignore_label": -1,
                                  "negative_mining_ratio": 3.0})
    # the anchors the first batch's loss counts: the mined negatives'
    # count depends on the positives only, not on the scores
    first = target.fn(anchors, batches[0][1], torch.zeros(
        (SSD_BATCH, SSD_CLASSES + 1, SSD_ANCHORS), device=dev), **tp)
    res["valid_anchors"] = int((first[2] >= 0).sum())
    del first
    mod.init_optimizer(optimizer="sgd", optimizer_params=SSD_OPT + (
        ("rescale_grad", 1.0 / res["valid_anchors"]),))
    passes.reset_launch_counts()
    step_ms, loc = [], []
    for x, lab in batches:
        batch = mx.io.DataBatch([mx.nd.NDArray(x, ctx=ctx)],
                                [mx.nd.NDArray(lab, ctx=ctx)])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward(batch, is_train=True)
        mod.backward()
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        loc.append(float(mod.get_outputs()[1].data.mean()))
    launches = passes.launch_counts()
    check(all(np.isfinite(loc)), f"non-finite loc loss {loc}")
    check(tuple(mod.get_outputs()[0].shape) ==
          (SSD_BATCH, SSD_CLASSES + 1, SSD_ANCHORS),
          f"cls_prob {mod.get_outputs()[0].shape}")
    lowered = [d for _, d in exe._codegen_plan.cache_component
               if d.startswith("kernel:")]
    res["b1_launches_per_step"] = launches["elementwise"] / SSD_STEPS
    if lowered:
        check(launches["elementwise"] == SSD_STEPS * len(lowered),
              f"B1 launches {launches} over {SSD_STEPS} steps, groups "
              f"{res['fusion_groups']}")
    else:
        log(f"vision: no fusion group lowered, the codegen's reasons: "
            f"{res['fusion_groups']}")
    steady = step_ms[1:]
    res.update({
        "step_ms": step_ms,
        "step_ms_p50": float(np.percentile(steady, 50)),
        "step_ms_p95": float(np.percentile(steady, 95)),
        "images_per_s": SSD_BATCH * len(steady) / (sum(steady) / 1e3),
        "peak_mem_bytes": torch.cuda.max_memory_allocated() - base_bytes,
        "loc_loss_first_last": [loc[0], loc[-1]], "b1_launches": launches})
    cls_pred = mod._exec_group.execs[0].outputs[0].data
    res["multibox_target_ms"] = _event_ms(
        torch, lambda: target.fn(anchors, batches[-1][1], cls_pred, **tp),
        reps=3)
    log(f"vision: SSD {res['params']} parameters, cold bind "
        f"{res['cold_bind_s']!r} s, {SSD_STEPS} steps at batch {SSD_BATCH} "
        f"({res['valid_anchors']} valid anchors in the first): "
        f"first {step_ms[0]!r} ms, steady p50 {res['step_ms_p50']!r} ms p95 "
        f"{res['step_ms_p95']!r} ms, {res['images_per_s']!r} images/s, peak "
        f"memory {res['peak_mem_bytes']} B above the bind's base, mean loc "
        f"loss step 1 {loc[0]!r} step {SSD_STEPS} {loc[-1]!r}, B1 launches "
        f"{launches}, MultiBoxTarget {res['multibox_target_ms']!r} ms")
    trained = mod.get_params()
    x_last = batches[-1][0]
    del mod, exe, batches, cls_pred
    torch.cuda.empty_cache()
    part("training")

    res["detection"] = _ssd_detection(torch, mx, ctx, dev, trained, x_last)
    log(f"vision: detection {json.dumps(res['detection'])}")
    torch.cuda.empty_cache()
    part("detection")
    res["rpn"] = _rpn(torch, dev)
    log(f"vision: Faster R-CNN RPN {json.dumps(res['rpn'])}")
    torch.cuda.empty_cache()
    part("rpn")
    log("phase 13 ok: SSD trains and detects at 300x300 through the vision "
        "ops and the NMS kernel")
    return res


def _vision_line(vision):
    """V1: `ms`, `plain_ms` and `bound_ms` at one shape, image 0's first
    4,096 candidates (the plain version's K-step loop over a dense IoU
    cannot run at full K), and the kernel's time and bound at the
    detection's shape (batch 32, every anchor) under `*_detection` and at
    Proposal's under `*_proposal`. Each bound counts the pairs of a kept
    box and a later valid candidate of its class; `*_all_pairs` counts
    those of every class. `launches` counts both kernels (prepare and
    segments) of phase 13's detection call, `groups` its launch groups
    (one: every image). Torch has no NMS op, so there is no library
    call."""
    d, r = vision["detection"], vision["rpn"]
    small = d["nms_bound_small"]
    return [{
        "name": "nms", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/nms.cu",
        "replaces": "mxnet_tpu/ops/vision.py:416",
        "launches": d["nms_launches"], "groups": d["nms_groups"],
        "max_abs_err": float(max(
            [x["differing_bits"] for x in d["nms_vs_plain"].values()]
            + [d["nms_greedy_check"]["differing_bits"],
               r["nms_differing_bits"]])),
        "shape": [1, NMS_CHECK_K[0]],
        "ms": d["nms_ms_small"], "plain_ms": d["nms_plain_ms_small"],
        "bound_ms": small["bound_ms"], "bound_by": small["bound_by"],
        "bound_ms_all_pairs": small["bound_ms_all_pairs"],
        "library_ms": None,
        "shape_detection": [SSD_BATCH, SSD_ANCHORS],
        "ms_detection": d["nms_ms"], "bound_ms_detection": d["nms_bound_ms"],
        "bound_by_detection": d["nms_bound_by"],
        "bound_ms_all_pairs_detection": d["nms_bound_ms_all_pairs"],
        "scratch_peak_bytes": d["nms_scratch_peak_bytes"],
        "ms_proposal": r["nms_ms"],
        "bound_ms_proposal": r["nms_bound"]["bound_ms"],
        "library_note": "torch has no NMS op"}]


def _rtc_line(rtc_res):
    """B7: the two head kernels launched through rtc.CudaKernel on phase
    10's path, at the training shape, with their times at the
    vocabulary size (RTC_VOCAB_SHAPE) beside."""
    out = []
    for name in ("softmax_ce_forward", "softmax_ce_backward"):
        r = next(x for x in rtc_res["softmax_rows"] if x["name"] == name
                 and x["shape"] == [TRAIN_BATCH, 1000])
        v = next(x for x in rtc_res["softmax_rows"] if x["name"] == name
                 and x["shape"] == list(RTC_VOCAB_SHAPE))
        out.append({
            "name": f"rtc_{name}", "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/rtc/softmax_ce.cu",
            "replaces": "mxnet_tpu/rtc.py:43",
            "launches": rtc_res["launches"][name],
            "max_abs_err": max(x["max_abs_err"]
                               for x in rtc_res["softmax_rows"]
                               if x["name"] == name),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "ms_vocab": v["ms"],
            "bound_ms_vocab": v["bound_ms"],
            "library_ms_vocab": v["library_ms"]})
    return out


# -------------------------------------------------------------- main
def _kernel_line(rows, launches_float, launches_int8, spec_launches):
    def pick(kv):
        return next(r for r in rows if r["kv"] == kv and r["bp"] == 128)

    out = []
    for name, kv, line, launches in (
            ("paged_attention_float", "float32", 134, launches_float),
            ("paged_attention_int8", "int8", 177, launches_int8)):
        r = pick(kv)
        out.append({
            "name": name, "route": "cuda",
            "source": "mxnet_tpu_torch/csrc/paged_attention.cu",
            "replaces": f"mxnet_tpu/decoding/attention.py:{line}",
            "launches": launches,
            "max_abs_err": max(x["max_abs_err"] for x in rows
                               if x["kv"] in ((kv, "bf16")
                                              if kv == "float32"
                                              else (kv,))),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]})
    # phase 14's speculative runs: the draft's K steps a target step
    out[0]["launches_speculative"] = spec_launches
    return out


# the Pallas kernels the generated CUDA kernels replace
_CODEGEN_REPLACES = {
    "elementwise": "mxnet_tpu/passes/pallas_codegen.py:408",
    "scale_bias_act": "mxnet_tpu/passes/pallas_codegen.py:444",
    "reduction": "mxnet_tpu/passes/pallas_codegen.py:455",
}


def _codegen_line(template_rows, train_rows, train_launches,
                  executor_launches):
    """B1 and B2 at the training shapes (for B2 the group with the most
    launches per step), launched on the training path; B3 at the
    template net's shape, launched on the Executor path."""
    out = []
    for template in ("elementwise", "scale_bias_act", "reduction"):
        if template == "reduction":
            r = next(x for x in template_rows if x["template"] == template)
            launches = executor_launches[template]
        else:
            r = max((x for x in train_rows if x["template"] == template),
                    key=lambda x: x["launches_per_step"])
            launches = train_launches[template]
        out.append({
            "name": f"fusion_{template}", "route": "cuda",
            "source": "mxnet_tpu_torch/passes/codegen.py",
            "replaces": _CODEGEN_REPLACES[template], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
        if "turns_clean_l2" in r:
            t = r["turns_clean_l2"]
            out[-1].update({"ms_clean_l2": t["kernel"]["mean"],
                            "library_ms_clean_l2": t["library"]["mean"],
                            "turns_clean_l2": {n: [v["min"], v["max"]]
                                               for n, v in t.items()}})
    return out


def _flash_line(attn):
    """B6 at the transformer's shape, float32, causal; its launches on
    phase 8's path; the largest error of every comparison."""
    r = next(x for x in attn["rows"] if x["name"] == "transformer"
             and x["kv"] == "float32" and x["causal"])
    return [{
        "name": "flash_attention", "route": "cuda",
        "source": "mxnet_tpu_torch/csrc/flash_attention.cu",
        "replaces": "mxnet_tpu/parallel/attention.py:48",
        "launches": attn["launches"]["flash_attention"],
        "max_abs_err": max(x["max_abs_err"] for x in attn["rows"]),
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    ap.add_argument("--profile", action="store_true",
                    help="also run torch.profiler over a training step "
                    "(phases 6 and 9) and print where the device time "
                    "goes (phase 3's serving window is profiled in every "
                    "run)")
    args = ap.parse_args()
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs one "
             "CUDA card")
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import decoding as dec
    except ImportError as e:
        fail(f"mxnet_tpu_torch is not importable ({e}); run from the "
             "root of the repository")
    check(not any(m == "jax" or m == "mxnet_tpu" or m.startswith(
        ("jax.", "mxnet_tpu.")) for m in sys.modules),
        "the port imported jax or mxnet_tpu")

    t = time.perf_counter()
    card, build_s, examples = phase_environment(torch)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "phase_s": {"environment": time.perf_counter() - t}}

    def run(key, fn, *a, **kw):
        t = time.perf_counter()
        out = report[key] = fn(*a, **kw)
        report["phase_s"][key] = time.perf_counter() - t
        return out

    rows = run("kernel_rows", phase_kernels, torch)
    cfg = dec.DecoderConfig(**SERVE_CFG)
    t = time.perf_counter()
    decoder = dec.params_from_jax(dec.init_decoder_params(cfg, seed=0),
                                  cfg, torch.device("cuda")).eval()
    log(f"weights: {sum(p.numel() for p in decoder.parameters())} "
        f"parameters in {time.perf_counter() - t!r} s")
    run("serving", phase_serving, torch, decoder, cfg, "cuda")
    serving, hot, cold_model = report["serving"]
    report["serving"] = serving
    kv = run("kv_dtypes", phase_kv_dtypes, torch, decoder, cfg, "cuda")
    tier = run("decode_tier", phase_decode_tier, torch, decoder, cfg,
               serving, hot, cold_model)
    del decoder, cold_model
    torch.cuda.empty_cache()
    codegen = run("codegen", phase_codegen, torch, mx)
    training, groups, trained = run("training", phase_training, torch, mx,
                                    profile=args.profile)
    report["training"] = training
    train_rows = run("train_kernels", phase_train_kernels, torch, groups,
                     training["launches_per_step_by_digest"])
    attn = run("attention", phase_attention, torch)
    run("transformer", phase_transformer, torch, mx, profile=args.profile)
    rtc_res = run("rtc", phase_rtc, torch, mx)
    surface = run("surface", phase_surface, torch, mx, trained, card,
                  examples)
    del trained
    torch.cuda.empty_cache()
    lm = run("lm", phase_lm, torch, mx)
    torch.cuda.empty_cache()
    vision = run("vision", phase_vision, torch, mx)

    line = {"kernels": _kernel_line(
        rows, serving["launches"]["paged_attention_float"],
        kv["int8"]["launches"]["paged_attention_int8"],
        {k: r["b4_launches"] for k, r in tier["spec"].items()})
        + _codegen_line(codegen["rows"], train_rows, training["launches"],
                        codegen["launches"])
        + _flash_line(attn) + _rtc_line(rtc_res) + _vision_line(vision)}
    report["kernels"] = line["kernels"]
    report["phase_s"]["total"] = time.perf_counter() - t_start
    log("surface: " + json.dumps(surface["summary"]))
    prof = serving["profile"]
    log("decode: " + json.dumps({
        "greedy": {"tokens_per_s": serving["e2e_tokens_per_s"],
                   "ttft_p50_s": float(np.median(serving["ttft_s"])),
                   "p50_token_ms": serving["stats"]["p50_token_ms"],
                   "p95_token_ms": serving["stats"]["p95_token_ms"]},
        "sampled": {k: tier["sampled"][k] for k in (
            "tokens_per_s", "ttft_p50_s", "p50_token_ms", "p95_token_ms",
            "preemptions_small_pool")},
        "speculative": {name: {k: r[k] for k in (
            "tokens_per_s", "ttft_p50_s", "p50_token_ms", "p95_token_ms",
            "acceptance", "accepted_per_target_step",
            "tokens_per_target_step", "b4_launches_per_step", "captures")}
            for name, r in tier["spec"].items()},
        "captures": serving["captures"],
        "window_wall_us": prof["wall_us"],
        "window_device_us": prof["device_us"],
        "window_prefill_us": prof["prefill_us"],
        "window_steps_us": prof["steps_us"],
        "busy_share": prof["busy_share"],
        "busy_share_eager_pr6": "0.133 (PERF.md section 5, PR 6's call 8)",
        "graph_vs_eager": tier["graph_vs_eager"],
        "divergences": {
            "sampled_small_pool": len(tier["sampled"]["small_vs_big"]),
            "sampled_alone": len(tier["sampled"]["alone_vs_big"]),
            "drain_resume": len(tier["drain"]["divergences"]),
            "spec_self": len(tier["spec"]["self"]["vs_target_only"]),
            "spec_real": len(tier["spec"]["real"]["vs_target_only"]),
            "split_grid": len(tier["split"]["vs_cold"])},
        "handed_off": tier["drain"]["handed_off"],
        "split_prefix_hits": tier["split"]["prefix_hits"],
        "phase_s": report["phase_s"]["decode_tier"],
        "parts_s": tier["parts_s"], "card": card}))
    log("lm: " + json.dumps({
        k: lm[k] for k in ("params", "cold_bind_s", "step_ms_p50",
                           "step_ms_p95", "tokens_per_s", "peak_mem_bytes",
                           "b1_b2_launches")}
        | {"perplexity_first_last": [lm["perplexity"][0],
                                     lm["perplexity"][-1]],
           "module_vs_plain_worst": max(lm["module_vs_plain"].values()),
           "rnn_cudnn_vs_plain_worst": max(r["worst"]
                                           for r in lm["rnn_rows"]),
           "weight_copy": lm["weight_copy"], "card": card}))
    det = vision["detection"]
    log("vision: " + json.dumps({
        k: vision[k] for k in ("params", "valid_anchors", "cold_bind_s",
                               "step_ms_p50",
                               "step_ms_p95", "images_per_s",
                               "peak_mem_bytes", "loc_loss_first_last",
                               "b1_launches_per_step",
                               "multibox_target_ms")}
        | {"card_vs_cpu": vision["card_vs_cpu"],
           "detect_forward_ms": det["forward_ms"],
           "nms_ms": det["nms_ms"], "nms_launches": det["nms_launches"],
           "nms_groups": det["nms_groups"],
           "nms_greedy_check": det["nms_greedy_check"],
           "kept_rows": det["kept_rows"],
           "nms_scratch_peak_bytes": det["nms_scratch_peak_bytes"],
           "nms_segments": det["nms_segments"],
           "nms_bound_ms": det["nms_bound_ms"],
           "nms_bound_ms_all_pairs": det["nms_bound_ms_all_pairs"],
           "rpn": vision["rpn"], "phase_s": report["phase_s"]["vision"],
           "parts_s": vision["parts_s"],
           "card": card}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True, default=str)
    log(f"total {report['phase_s']['total']!r} s (kernel build "
        f"{build_s!r} s; each phase's s: {json.dumps(report['phase_s'])})")
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()

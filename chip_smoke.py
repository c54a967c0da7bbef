#!/usr/bin/env python3
"""End-to-end check of mxnet_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card and nvcc; exits non-zero without a result line when
torch.cuda.is_available() is false or the package is missing. Phases,
each of which exits non-zero on failure:

  1. environment  card name and power limit, torch/CUDA versions, TF32
                  off, the CUDA kernels built from csrc/ (one nvcc per
                  library, started together; the flash forward is three
                  libraries, one a dtype), and with them the generated
                  fusion sources the later phases' binds compile (phase
                  5's template nets and their bf16 twins,
                  Inception-ResNet-v2's groups with phase 7's bf16
                  twins, SSD's; each found from its optimized graph on
                  the host, its nvcc started as soon as its text is
                  known), so that those binds compile nothing; the
                  decoder's seeded weights and phases 6 and 10's host
                  inputs are drawn meanwhile
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
                  plain attention on one device, as in the JAX package).
                  Then 10 more steps on the same Module under
                  cast_compute(torch.bfloat16): float32 master weights,
                  a finite loss, the first bf16 step's MSE within 2e-2
                  of the float32 forward's on the same batch and weights
                  (TOWER_BF16_RTOL); its tokens/s, step p50/p95 and
                  TFLOP/s beside float32's (--profile: the bf16 step's
                  matrix-product kernels by name)
 10. rtc          user device code: Inception-ResNet-v2 at full width and
                  half depth (RTC_REPEATS: 5, 10 and 5 blocks a stage,
                  cut to keep the script in its budget) with
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
                  weights (Inception-ResNet-v2 at full width and half
                  depth, HALF_DEPTH: 5, 10 and 5 blocks a stage, cut
                  for the budget; dropout 0, batch 32, 3x299x299, TF32
                  off): the net's forward built
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
                  serve_checkpoint and profile_lenet (the one-shot
                  slice's examples) run in the same child process.
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
                  eagerly. (f) ring-attention prefill (phase 20's
                  decode arm): ring_prefill 1024 on a cache-off model,
                  phase 3's prompts whose length bucket reaches 1024
                  prefill through ring_attention over seq_mesh_for
                  (one entry on one card), the decode steps through B4
                  n_layers a step, greedy streams equal the cache-off
                  engine's, no capture after warmup. (d) prefix cache
                  on, merged step off: hits
                  equal the cold streams. Every stream comparison passes
                  where equal or diverging first at a near tie of the
                  cache-off engine's logits (top-2 gap of filtered +
                  Gumbel, or of the logits, < 1e-3, or a preceding mass
                  within 1e-6 of top_p), each divergence counted. A
                  `decode: {...}` summary line before the kernel line
 15. bucketing    (runs after phase 12, from its trained parameters) the
                  rnn package and BucketingModule at phase 12's widths:
                  a seeded corpus of 3-60-token sentences through
                  rnn.encode_sentences and rnn.BucketSentenceIter
                  (upstream lstm_bucketing.py's buckets 10-60, batch 20),
                  buckets 60 and 10 at dropout 0 against the plain
                  composition (1e-4 of each tensor's max), then two
                  passes of 3 batches a bucket at dropout 0.65 (SGD lr
                  0.1, clip 10). Checks: every bucket's parameters and
                  gradients on the default bucket's storage; peak memory
                  above the bind's base under the parameters and
                  gradients plus two default-bucket steps; no executor,
                  bind or kernel build on the second pass; perplexity
                  finite and falling; save_rnn_checkpoint ->
                  load_rnn_checkpoint bit-exact. Tokens/s and step ms
                  p50/p95 a bucket, each new bucket's bind s. Then the
                  fused arm, MXNET_TPU_BUCKET_FUSED=1, over the eager
                  arm's own batches: a captured step a bucket over the
                  one canonical parameter and state storage (data_ptr),
                  one capture a bucket on pass 1 and none on pass 2, no
                  parameter re-pointed at a hand-over, each bucket's
                  step p50 beside the eager arm's, the peak and each
                  bucket's graph pool beside the eager arm's bound; and
                  at dropout 0 buckets 60 and 10 trained fused and eager
                  over the same 4 steps within 1e-4 of each tensor's max
                  (a `bucketing: {...}` summary line)
 16. one shot     (runs after phase 11, with phase 6's trained weights
                  and phase 3's decoder) one-shot serving: the
                  Inception-ResNet-v2 checkpoint (1000 classes,
                  3x299x299, float32, TF32 off; at half depth,
                  HALF_DEPTH, cut for the budget) written by
                  model.save_checkpoint and loaded by
                  serving.ModelServer(max_batch=8, max_wait_us=2000)
                  .load_checkpoint: batch buckets 1, 2, 4, 8, each cell
                  bound and run before ready, every cell's parameters
                  the base cell's storage; 64 seeded images from 4
                  client threads, 48 at once (full batches) and 16 one
                  at a time spaced past max_wait (batch-1 flushes).
                  Checks: every request completes, each served row
                  within 1e-4 of its max of a single-request
                  Predictor's forward, no trace and no exec-cache miss
                  after warmup, every served batch launching each of
                  the cell's lowered B1/B2 groups once. Requests/s,
                  p50/p95/p99 ms, batch_fill and padding_waste beside
                  the same images through a looped batch-1 Predictor.
                  The exporter (MXNET_TELEMETRY_PORT=0) scraped once
                  over localhost (latency histogram count 64, /statusz
                  servingStats 64 completed); one batch profiled with
                  MXNET_TPU_XLA_TRACE_DIR (executor events, CUDA kernel
                  slices at pid >= 1000 naming fused_scale_bias_act,
                  the servingStats and execCacheStats keys; the
                  window's busy share). Then phase 3's decoder behind
                  the same server (load_decoder with its cache-off
                  knobs, max_batch 2, page buckets 8 and 32): 4 of
                  phase 3's prompts through submit_decode, stream and
                  generate equal to phase 3's cache-off streams but at
                  counted near ties, B4 n_layers times a decode step,
                  unload stopping the scheduler (a `one_shot: {...}`
                  summary line)
 17. fused        (runs after phase 7, on Inception-ResNet-v2 at half
                  depth, HALF_DEPTH, cut for the script's budget,
                  with phase 6's trained weights, bound at phase 6's
                  shapes and captured after two steps; freed after) the
                  fused train step as a CUDA graph and run health: (a) one
                  replayed step against one eager step from the same
                  state (params, moving stats, momentum, the device
                  generator's state): outputs and parameters within
                  1e-3 of each tensor's max; 4 steps of the eager path
                  timed (the step's state handed to the updater and
                  back to a rebuilt step); (b) after the rebuilt step's
                  warmup and capture, 10
                  replayed steps (p50/p95 as phase 6 takes them, beside
                  the eager p50), the busy share of one profiled
                  replay, 0 captures, B1/B2 1 and 20 a step; (c)
                  run_steps(4, stacked) against four single steps
                  (within 1e-3, or RUN_STEPS_SPREAD times the difference
                  of the four steps run twice: cuDNN's atomics), then
                  fit(steps_per_dispatch=4) over 8 batches (callbacks
                  at 4 and 8, nothing captured); (e) Monitor(device=True)
                  over 3 steps after its recapture: 0 captures, one
                  fetch a toc; (d) NumericsMonitor(interval=5) over 10
                  steps: 10 rows, at most 2 fetches and no wait in the
                  steps; (f) the HBM pre-flight's estimate beside the
                  measured peak of a replay above the bind's base; (g)
                  the step's deviceStats record (capture s, pool bytes,
                  flops) and fit's CalibrationStore record ("fit_step",
                  platform gpu); then an eager Monitor(1, ".*weight")
                  over one step (every weight, one fetch at toc), and a
                  new fused step with MXNET_TPU_FAULT_INJECT=nan:step:3:
                  b35_1_proj_conv_weight: a nonfinite anomaly at step
                  3 with its first bad op named and a flight record
                  written (a `fused: {...}` summary line)
 18. pipeline     (runs inside phase 17, after its fits and before its
                  monitors, on phase 6's module and captured step) the
                  input pipeline: an MXIndexedRecordIO file of 320 seeded
                  299x299x3 uint8 images (raw bytes, label = index) read
                  by data.make_pipeline(RecordSource, batch 32, seed 0)
                  and trained by Module.fit over one epoch of 10 steps,
                  prefetch 2 (DevicePrefetchIter: a pinned ring, copies on
                  a side stream, events) and prefetch 0: step p50/p95
                  (steps 2-10, each ended by a synchronize) beside phase
                  6's fit and phase 17's replay, inputPipelineStats, the
                  pinned ring's counters; 0 captures, B1/B2 1 and 39 a
                  step, 0 stalls with prefetch on and 10 of 10 off; the
                  labels the step's input buffer held equal
                  epoch_permutation(0, 0, 320), and a state_dict taken
                  after 4 steps resumes a fresh pipeline on the other 6
                  batches. Then MXNET_TPU_OPT_BUCKET=1 and the module's
                  step built again over its state (one recapture; a
                  bucketed replay against a per-parameter replay from
                  one snapshot within 1e-3; the bucketed replays' p50);
                  the layout pass at half depth (the same weights bound
                  with and without it: layout_rewrites = the 2-D
                  Convolution and Pooling nodes, the first step's output
                  and every gradient within 1e-3, the first step's
                  kernels by name, each bind's step p50 over 3 replays),
                  both binds over a calibration file whose records favour
                  every group's plain version (each group marked
                  calibrated_slower, and B1/B2 still 1 and 20 in the
                  first step at that depth); the autotuner's record for
                  the module's graph on "gpu" before and after a measured
                  forward, and the codegen's kernel and plain timings
                  (a `pipeline: {...}` summary line)
 19. data parallel (runs after phase 13) Inception-ResNet-v2 at full
                  width, at HALF_DEPTH since phase 20 (its budget),
                  dropout 0, 3x299x299, float32, TF32 off, SGD:
                  (1) Module([gpu(0), gpu(0)], kvstore='device'), batch
                  32 split 16/16, 4 steps: the store's merged gradient
                  the two executors' sum and both executors' weights
                  equal after each step, bit for bit; B1/B2 1 and 20 an
                  executor a step. (2) Two workers through
                  tools/launch.py -n 2 on cuda:0, re-entering this
                  script (--dp-worker), started with the script (their
                  imports and batches beside phase 1's builds; the card
                  only after phase 19's go): (a) dist_sync push and
                  pull of the 55.9 M-element gradient list, the pulled
                  sum rank 0's plus rank 1's bit for bit (ms of each);
                  (b)
                  Module.fit with kvstore='dist_sync' through the fused
                  step's data plane, 32 rows a worker (global 64), 4
                  steps (10 before phase 20), seeds that differ by
                  rank: step ms p50/p95 (steps 2-4, each ended by a
                  synchronize), the gradients' all-reduce ms, captures
                  after warmup (0) and the segments a step runs, B1/B2
                  1 and 20 a step,
                  both ranks' parameters and moving statistics equal
                  bit for bit; step 1 within DP_STEP1_RTOL of each
                  tensor's movement of one process's fused step over the
                  global batch of 64 from rank 0's initial weights; (c)
                  neither worker compiles anything (a `data_parallel:
                  {...}` summary line). The same two workers then run
                  phase 20's part in the same launch
 20. model parallel (after phase 19, in its launch; module docstring
                  of parallel/ring_attention.py and sharding/) phase 9's
                  tower at full width and depth (d_model 512, 8 heads,
                  d_ff 1024, 4 layers, causal), global batch 8 x 2048,
                  float32, TF32 off, SGD with momentum, numpy-seeded
                  weights: (a) in both workers, mesh {'seq': 2}, data
                  and label split "None,seq", w1/w2 sharded over 'seq'
                  (tp_axis="seq"), ring attention across the two
                  processes: 6 fit steps (p50/p95 of steps 2-6, tokens/s,
                  K/V bytes rotated a step, each collective's bytes and
                  ms a step, beside phase 9's one-process step); step 1
                  within MP_STEP1_WORST of each tensor's movement of one
                  process's step over the same batch from the same
                  weights (run by the parent before the workers' go);
                  the replicated parameters equal on both
                  ranks; each rank stores half of w1/w2's bytes; 0
                  captures after warmup; save_sharded after step 3. (b)
                  impl="ulysses" (8 heads over 2), 3 steps, step 1
                  against (a)'s. (c) ShardingPlan({'fsdp': 2}): every
                  weight half stored, rows split, 3 steps, step 1
                  against the one-process step. (d) the parent
                  load_sharded's (a)'s checkpoint into a one-process
                  module with no mesh: parameters and momentum equal the
                  workers' gathered ones bit for bit, then its step 4
                  against the workers' step 4. (e) is phase 14's ring-
                  prefill arm (a `model_parallel: {...}` summary line)
 21. pipeline and experts (after phase 20, in the same launch; module
                  docstrings of parallel/pipeline.py, parallel/moe.py,
                  module/pipeline_module.py) float32, TF32 off,
                  numpy-seeded weights, the parent's one-process
                  references run before the workers' go: (a) one layer
                  of phase 9's tower a stage (causal attention + FFN,
                  both residual, d_model 512), PipelineModule over 4
                  stages, 2 a worker, 8 microbatches of the 8 x 2048
                  batch, loss l2, SGD with momentum, 4 steps: step 1's
                  outputs and parameters against the parent's
                  composition of the 4 layers microbatch by microbatch,
                  within PE_STEP1_WORST; each worker stores 2 of the 4
                  stages; both ranks' losses and outputs equal; step ms
                  p50/p95, tokens/s, the boundary's bytes and send/recv
                  ms a step. (b) phase 9's tower with layers 1 and 3
                  MoE (8 experts, capacity 2560 of 16,384 tokens): the
                  parent's 3 steps with no mesh (step ms, tokens
                  dropped, aux loss), then mesh {'expert': 2} in the
                  workers, the whole batch on both, 3 steps: step 1
                  against the parent's, the ranks bit-equal, each
                  computing 4 of the 8 experts' FFN (counted), gloo's
                  bytes a step. (c) Inception-ResNet-v2 at full width
                  and HALF_DEPTH as 4 stage symbols cut between blocks
                  (each boundary changes the shape, each stage holds
                  BatchNorm), softmax_ce over 1000 classes, batch 32 in
                  4 microbatches, 2 stages a worker, 3 steps: step 1's
                  parameters and moving statistics against the
                  parent's composition of the same stage executors
                  microbatch by microbatch, within PE_HET_STEP1_WORST
                  and PE_HET_AUX_WORST, both below what a dropped
                  microbatch or a reversed order of the moving
                  statistics' updates reads; each worker binds its 2
                  stages' executors alone, the two storing one copy
                  of the parameters between them; B1 and B2 4 and 80
                  a step summed over the workers (a `pipe_expert:
                  {...}` summary line)
 22. bundles      (runs inside phase 16, while its served model is warm;
                  serving/bundle.py, exec_cache_disk.py, fault.py) (a)
                  save_bundle of phase 16's Inception-ResNet-v2 (half
                  depth, batch buckets 1, 2, 4, 8, float32: a record a
                  bind with its generated B1/B2 libraries) and of a
                  DecodedModel at the docs/serving.md width on phase
                  16's weights, kv_dtype int8, quantize="int8" (max_batch
                  2, 256 pages, page buckets 8 and 40): sizes, save and
                  hash times, content hashes; the int8 params.npz under
                  0.3 of the float32 weights. (b) the parent's outputs
                  at batch buckets 1 and 8, and 4 greedy requests (32,
                  128, 320 and 512 prompt tokens, 32 new) on the decoder
                  with the bundle's dequantized weights copied into its
                  parameters in place (its float32 weights restored
                  after; their top-1 agreement with the float32 streams
                  reported). (c) a fresh process (this script's copy
                  beside a copy of mxnet_tpu_torch/ with no _build/, no
                  nvcc on PATH, no CUDA_HOME, started with the script,
                  importing after phase 1 and waiting for its go) restores
                  both through
                  ModelServer.load_bundle: 0 plans built, 0 nvcc runs,
                  0 compiles, a disk hit a served bind, disk loads, every
                  library loaded from the bundles' exec_cache/, the
                  served outputs bit for bit, the streams token for
                  token, B1/B2 and B5 launched; its times to the first
                  answer beside phase 16's load and warmup and phase 1's
                  builds. (d) (started with (a), in two processes of
                  their own) the examples' MLP (784-128-64-10) through
                  fit_auto_resume over a seeded data pipeline, 3 epochs
                  of 16 batches, with deterministic algorithms: one
                  killed by kill:step:24 (-SIGKILL, no finally or
                  atexit), one resuming its files to the end, whose
                  batches after the killed ones are the uninterrupted
                  run's and whose parameters equal, bit for bit, the
                  same schedule run with the 'step:24' exception and a
                  resume in one process (a `bundles: {...}` summary
                  line)
 23. fleet        (runs inside phase 16 after phase 22, on phase 22's
                  served bundle and phase 3's weights; fleet/) (a) a
                  float32 bundle of the docs/serving.md decoder (max_batch
                  8, 256 pages, page bucket 24, prefix cache on) behind
                  FleetRouter(replicas=3), affinity routing, 200 ms
                  heartbeats, each replica a fresh process on cuda:0
                  started through the router's spawn_fn as this script
                  (`--fleet-replica`: fleet.replica.main with the
                  default command's arguments, no exec-cache disk root,
                  no nvcc); every hello, the heal's replacement's too,
                  reports 0 traces and 0 compiles. (b) 12 sampled
                  requests (temperature 0.8, top_k 40, top_p 0.95, seeds
                  2300-2311) in two families sharing a 256-token prefix,
                  each with its own 32-token tail, 64 new tokens: one of
                  each family first, the other ten once the replicas'
                  heartbeats advertise the families' pages; at least 8
                  routed by affinity covering 16 pages each. (c) after
                  256 tokens out, SIGKILL of the replica with the most
                  live decodes: every request completes, 1 death, a
                  re-admission, the fleet healed back to 3. (d) the 12
                  again, the busiest replica drained through the admin
                  plane (`fleet.cli.admin_call`, timeout_ms 0): a
                  hand-off, every request complete, 2 replicas left and
                  no heal. Every stream of (b)-(d) equals the same
                  request decoded alone in this process with the prefix
                  cache off but at counted near ties; each cleanly
                  exited decoder replica launched B4 16 times a decode
                  step. (e) Inception-ResNet-v2's served bundle behind
                  FleetRouter(replicas=1), started with (a)'s:
                  router.predict of 1 and of 8 images (one request an
                  image, collected into one batch by the replica's
                  batcher) equals phase 22's restored outputs bit for
                  bit after JSON's float round trip, B1/B2 launched; the
                  latency through the router beside the in-process
                  `infer` (a `fleet: {...}` summary line)
 24. elastic      elastic/ on the card: LeNet (models/lenet.py, 1x28x28,
                  20 and 50 filters, 500 hidden, 431,080 parameters) over
                  1,024 seeded images, micro-batch 64, 2 logical shards,
                  2 epochs (16 global steps), the script's own entry
                  (`chip_smoke:elastic_lenet_job`). A coordinator in this
                  process for each of three jobs, the agents real
                  processes (`python -m mxnet_tpu_torch.elastic.agent
                  --ctx gpu`) on cuda:0, all five started together: (a)
                  one worker; (b) two, one killed by its own
                  kill:step:6 (-9); (c) one, joined after step 5 by a
                  second held warm at its start gate. (b)'s and (c)'s
                  final parameters equal (a)'s bit for bit; every
                  consumed log holds each (epoch, shard, step) batch
                  once with the sampler's indices; one shrink in (b),
                  one grow in (c), fewer bytes moved than a full
                  restore, no digest mismatch, no trace after a
                  member's warmup, every agent's parameters on cuda.
                  Start-to-hello, step ms and the share of (a)'s step
                  outside its two micro-batch gradients, quiesce wall
                  and bytes moved (an `elastic: {...}` line)

Phases 6, 9, 11, 12, 13, 17 and 18 train through the fused step, each
step after its first a replay of one captured CUDA graph (phase 10's
Custom head runs it uncaptured, by name; phase 15's eager arm trains
eagerly once a second bucket binds, its fused arm a graph a bucket).
The script points MXNET_CALIBRATION_CACHE and MXNET_TUNING_CACHE at
fresh temporary files: a record of an earlier run could change the
tuner's choice (a fusion group's records never take its kernel off the
card's path: phase 18 binds over records that favour the plain
versions).

The last two lines of standard output are
one JSON object with every kernel's numbers and one JSON object naming
the device; the summary lines of phases 17, 18, 11, 16, 22, 23, 12, 13,
14, 15, 19 and 20 (`fused: {...}`, `pipeline: {...}`, `surface: {...}`,
`one_shot: {...}`, `bundles: {...}`, `fleet: {...}`, `lm: {...}`,
`vision: {...}`,
`decode: {...}`, `bucketing: {...}`, `data_parallel: {...}`,
`model_parallel: {...}`) come before them.
"""
from __future__ import annotations

import argparse
import atexit
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
# phase 17: graphed steps timed, eager steps timed beside them, and the
# batches of fit(steps_per_dispatch=4)
FUSED_STEPS = 10
FUSED_EAGER_STEPS = 4
FUSED_FIT_BATCHES = 8
# run_steps(4) against four single steps: within 1e-3 of each tensor's
# max, or within this many times the difference between two runs of the
# same four steps (cuDNN's atomics), whichever is larger
RUN_STEPS_SPREAD = 4
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
# the first bf16 step's MSE against the float32 forward's, same weights
# and batch: bf16 rounds each operand to an 8-bit mantissa (2^-9
# relative); through 4 layers of d_model-512 products and softmaxes the
# outputs drift by about a percent at most, and the MSE, a mean over
# 8.4 M squared errors, by far less
TOWER_BF16_RTOL = 2e-2

# phase 10: 4 batches of the training shape through FeedForward; the head
# against SoftmaxOutput on the first step: its output within this share
# of the max (the kernel's softmax sums in another order than
# torch.softmax), the gradients within TRAIN_PARITY_RTOL
RTC_BATCHES = 4
# the net's stage depths: half of the canonical (10, 20, 9), cut so the
# script stays in its time budget with phase 16 added (widths unchanged)
RTC_REPEATS = (5, 10, 5)
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
# phases 11 and 16 run phase 6's model at half depth (5, 10 and 5 blocks
# a stage, phase 6's trained weights of those blocks), cut so that phase
# 17 does not lengthen the script
HALF_DEPTH = (5, 10, 5)
SURFACE_EPOCHS = 2
SURFACE_SEED = 7
SURFACE_IMPERATIVE_STEPS = 2
SURFACE_AUX_RTOL = 1e-4
SURFACE_RESHAPE_RTOL = 1e-4
SURFACE_EXAMPLES = [("dec/dec_cluster.py", []),
                    ("reinforcement_learning/reinforce_cartpole.py",
                     ["--batches", "60", "--min-length", "40"]),
                    ("bayesian_methods/sgld_regression.py", []),
                    ("autoencoder/ae_mnist.py", []),
                    ("serving/serve_checkpoint.py", ["--requests", "30"]),
                    ("profiler/profile_lenet.py",
                     ["--out", os.path.join(tempfile.gettempdir(),
                                            "chip_smoke_profile_lenet.json")])]
SURFACE_EXAMPLES_TIMEOUT = 240
PHASE1_NICE = 5

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

# phase 15: a BucketingModule over models.lstm_lm_sym_gen at phase 12's
# widths, dropout and SGD settings, from phase 12's trained parameters;
# the buckets of upstream MXNet's example/rnn/lstm_bucketing.py. The PTB
# text is not in the repository, so the corpus is synthetic: each
# bucket's sentences walk phase 12's token cycle, lengths 3-60, through
# rnn.encode_sentences and rnn.BucketSentenceIter
BUCKETS = [10, 20, 30, 40, 50, 60]
BUCKET_BATCHES = 3      # each bucket's batches a pass
BUCKET_PASSES = 2
BUCKET_SEED = 15
# the loss sums over a bucket's steps; every bucket's gradient is divided
# by the default (largest) bucket's tokens, as phase 12 divides by its
# 35. Phase 12's lr 1.0 is cut to 0.1: at lr 1.0 a batch's perplexity
# swung to 1e8-1e9 all through both passes, probably through the output
# row of the label the buckets pad with (0, which the graph's
# SoftmaxOutput trains on); at 0.1 it falls pass to pass
# (tools/bucketing_lr_sweep.py on the card)
BUCKET_OPT = (("learning_rate", 0.1), ("clip_gradient", 10.0),
              ("rescale_grad", 1.0 / (LM_BATCH * max(BUCKETS))))

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
def phase_environment(torch, examples):
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

    found = {"items": []}

    def sources():
        t0 = time.perf_counter()
        for item in _ahead_sources(mx):
            found["items"].append(item[0])
            yield item
        found["s"] = time.perf_counter() - t0
        _draw_host_inputs(mx)
        found["host_s"] = time.perf_counter() - t0 - found["s"]

    try:
        secs = kernels.build_all(generated=sources)
        log(f"phase 1 ok: kernels {list(kernels.LIBRARIES)} and the later "
            f"phases' {len(found['items'])} generated sources (found on "
            f"the host in {found['s']!r} s while the libraries compiled) "
            f"built in {secs!r} s; phases 6 and 10's host inputs drawn "
            f"meanwhile in {found['host_s']!r} s")
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
    # the fused step's record_function ranges show on the device's
    # timeline too, spanning the kernels they hold: not device work
    ranges = ("fused_train_step", "fused_train_steps")
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and e.key not in ranges]
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
    from mxnet_tpu_torch.decoding.blocks import pages_needed
    from mxnet_tpu_torch.serving.batcher import pick_bucket

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

    # (c) speculative, K = 4: a self-draft, then a real draft, each
    # warmed on the pages buckets the phase's requests take (the buckets
    # of their prompts' prefills, and the largest for the decode steps)
    t0 = time.perf_counter()
    res["spec"] = {}
    grid = cold_model.engine.page_buckets
    spec_buckets = sorted({pick_bucket(pages_needed(
        len(x), cold_model.engine.page_size), grid) for x in prompts}
        | {grid[-1]})
    res["spec_page_buckets"] = spec_buckets
    draft_cfg = dec.DecoderConfig(**DRAFT_CFG)
    draft = dec.params_from_jax(dec.init_decoder_params(draft_cfg, seed=1),
                                draft_cfg, torch.device(DECODE_DEVICE))
    for name, spec_kw in (("self", dict(draft="self")),
                          ("real", dict(draft=draft, draft_cfg=draft_cfg))):
        t1 = time.perf_counter()
        model = dec.DecodedModel(f"lm-spec-{name}", 1, decoder, cfg, **kw,
                                 prefix_cache=False, spec_k=SPEC_K,
                                 page_buckets=spec_buckets, **spec_kw)
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

    # (f) ring-attention prefill (phase 20's decode arm): prompts whose
    # length bucket reaches RING_PREFILL prefill through ring attention
    # over seq_mesh_for(bucket); the decode steps read their pages
    # through B4 as before
    t0 = time.perf_counter()
    ring = dec.DecodedModel("lm-ring", 1, decoder, cfg, **kw,
                            prefix_cache=False, ring_prefill=RING_PREFILL)
    attention.reset_launch_counts()
    streams, ttft, wall = _serve_concurrent(ring, prompts, max_new)
    launches = attention.launch_counts()["paged_attention_float"]
    snap = ring.stats.snapshot()
    fns = ring.engine._ring_fns
    check(fns, f"ring prefill: no prompt reached the {RING_PREFILL}-token "
          "bucket")
    check(launches == cfg.n_layers * snap["steps"],
          f"ring prefill: B4 launches {launches} != n_layers x steps "
          f"{cfg.n_layers} x {snap['steps']}")
    check(snap["traces_since_warmup"] == 0,
          "ring prefill: a graph was captured after warmup")
    res["ring"] = {
        "ring_prefill": RING_PREFILL,
        "ring_buckets": sorted(fns),
        # one card: the job's seq mesh has one entry, as the JAX
        # package's has on one chip
        "seq_mesh_sizes": {b: int(f.mesh.shape["seq"])
                           for b, f in fns.items()},
        "ring_prompts": sum(1 for x in prompts
                            if len(x) > RING_PREFILL // 2),
        "b4_launches": launches, "steps": snap["steps"],
        "b4_launches_per_step": launches / snap["steps"],
        "captures_after_warmup": snap["traces_since_warmup"],
        "tokens_per_s": sum(map(len, streams)) / wall,
        "ttft_p50_s": float(np.median(ttft)),
        "vs_dense": _divergences(quiet, prompts, streams, cold, None,
                                 "ring prefill vs dense prefill")}
    res["ring"]["near_tie_divergences"] = len(res["ring"]["vs_dense"])
    log("decode tier: ring prefill " + json.dumps(
        {k: v for k, v in res["ring"].items() if k != "vs_dense"}))
    ring.close()
    del ring
    _empty_cache(torch, DECODE_DEVICE)
    part("ring_prefill", t0)

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


def _bind_shapes(net, **inputs):
    """Every argument's and aux state's shape of a bind of `net`."""
    args, _, auxs = net.infer_shape(**inputs)
    return {**dict(zip(net.list_arguments(), args)),
            **dict(zip(net.list_auxiliary_states(), auxs))}


def _ahead_sources(mx):
    """The generated sources the later phases' binds compile, yielded
    one at a time as (tag, text) while phase 1's libraries compile, so
    each nvcc starts as soon as its text is known: the template nets of
    phase 5 and their bf16 twins; Inception-ResNet-v2's groups (phases
    6, 10 and 11) and the bf16 twins phase 7 times; SSD's (phase 13).
    Each comes from the optimized graph and its inferred shapes on the
    host (`passes.bind_sources`): the same text a bind on the card
    emits (a group's text depends on its ops and dtypes, not on its
    shapes), its library named by a digest of the text, so those binds
    compile nothing."""
    import torch

    from mxnet_tpu_torch import passes
    from mxnet_tpu_torch.models import get_inception_resnet_v2, get_ssd_train

    side = (CODEGEN_SIDE, CODEGEN_SIDE)
    jobs = [(net, {n: side for n in net.list_arguments()},
             (None, torch.bfloat16))
            for net in _template_nets(mx).values()]
    inc = get_inception_resnet_v2(num_classes=1000)
    jobs.append((inc, _bind_shapes(inc, data=(TRAIN_BATCH, 3, 299, 299),
                                   softmax_label=(TRAIN_BATCH,)),
                 (None, torch.bfloat16)))
    # phase 21's: the MoE tower and the pipelined tower layer (its
    # Inception stages' groups are the whole net's)
    pe = _pe_config()
    for net, shapes in ((_pe_moe_net(pe), {"data": _pe_shape(pe),
                                           "label": _pe_shape(pe)}),
                        (_pe_stage(mx, pe), {"data": (1,) + _pe_shape(pe)[1:]})):
        jobs.append((net, _bind_shapes(net, **shapes), (None,)))
    ssd = get_ssd_train(num_classes=SSD_CLASSES)
    jobs.append((ssd, _bind_shapes(ssd, data=(SSD_BATCH, 3, SSD_IMAGE,
                                              SSD_IMAGE),
                                   label=(SSD_BATCH, SSD_GT_ROWS, 5)),
                 (None,)))
    for net, shapes, dtypes in jobs:
        yield from passes.bind_sources(passes.optimize_for_bind(net),
                                       shapes, dtypes)


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
# seeded host inputs of the later phases, drawn while phase 1's compilers
# run (`_host_inputs`)
_HOST = {}


def _host_inputs(key, draw):
    """`draw()`'s result, drawn ahead under `key` during phase 1 (and
    dropped once taken), or drawn now."""
    out = _HOST.pop(key, None)
    return draw() if out is None else out


def _draw_host_inputs(mx):
    """Phases 6 and 10's seeded host arrays, drawn in phase 1 once its
    sources are found, while nvcc runs: the values are those the phases
    would draw (their own seeds; the initializer under mx.random.seed,
    which nothing else draws from meanwhile)."""
    _HOST["train"] = _train_arrays(TRAIN_STEPS, TRAIN_BATCH)
    _HOST["rtc"] = _rtc_host_inputs(mx)


def _train_arrays(n_batches, batch):
    rs = np.random.RandomState(0)
    x = rs.uniform(-1, 1, (n_batches * batch, 3, 299, 299)).astype(
        np.float32)
    y = rs.randint(0, 1000, (n_batches * batch,)).astype(np.float32)
    return x, y


def _train_data(mx, n_batches, batch):
    """Synthetic ImageNet batches as examples/image_classification/
    train_imagenet.py builds them (seed 0)."""
    x, y = _host_inputs("train", lambda: _train_arrays(n_batches, batch))
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
    torch.cuda.synchronize()
    res["base_bytes"] = torch.cuda.memory_allocated()
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
            captured["outs"], captured["grads"] = _step_outputs_grads(
                mod, ref_grads)
        torch.cuda.synchronize()
        step_ends.append(time.perf_counter())

    metric = mx.metric.create(["acc", "ce"])
    speedometer = mx.callback.Speedometer(TRAIN_BATCH, frequent=5)
    passes.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _retained_grads():
        mod.fit(data, num_epoch=1, eval_metric=metric, optimizer="sgd",
                optimizer_params=_OPT, initializer=mx.init.Xavier(**_INIT),
                batch_end_callback=[on_batch, speedometer])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = passes.launch_counts()
    res["launches"] = launches
    n_steps = len(step_ends)
    check(n_steps == TRAIN_STEPS, f"fit ran {n_steps} steps")
    fs = mod._fused_step
    check(fs is not None and fs.graphed and fs.captures == 1,
          f"fit did not train through one captured graph: fused step "
          f"{fs is not None}, graphed {fs and fs.graphed} "
          f"({fs and fs.uncaptured_op}), captures {fs and fs.captures}")
    res["graphed"] = _graphed(mod)
    res["captures"] = {"captures": fs.captures, "steps": fs._t}
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
    log("phase 6 ok: Inception-ResNet-v2 trains through Module.fit, each "
        "step after the first a replay of one captured CUDA graph")
    trained = mod.get_params()
    trained = ({n: a.copy() for n, a in trained[0].items()},
               {n: a.copy() for n, a in trained[1].items()})
    return res, groups, trained, mod


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


# ----------------------------------------------------------- phase 17
def _retained_grads():
    """Inside the block, fused steps built keep each step's gradients
    (FusedTrainStep.retain_grads) for the first-step checks."""
    import contextlib

    from mxnet_tpu_torch.parallel import dp_step

    @contextlib.contextmanager
    def block():
        dp_step.FusedTrainStep.retain_grads = True
        try:
            yield
        finally:
            dp_step.FusedTrainStep.retain_grads = False

    return block()


def _step_outputs_grads(mod, names):
    """The outputs and gradients of the step just run through `mod`: the
    fused step's (its retained gradients) or the executor's."""
    fs = mod._fused_step
    outs = [o.data.clone() for o in mod.get_outputs()]
    if fs is not None:
        return outs, {n: fs.grads[n].clone() for n in names}
    exe = mod._exec_group.execs[0]
    return outs, {n: exe.grad_dict[n].data.clone() for n in names}


def _graphed(mod):
    """How a module trained: "graphed" through its fused step's CUDA
    graph, "uncaptured: <op>" through the step with an op that must
    synchronise, "eager" with no fused step."""
    fs = getattr(mod, "_fused_step", None)
    if fs is None:
        return "eager"
    return "graphed" if fs.graphed else f"uncaptured: {fs.uncaptured_op}"


def _fused_state(torch, mod):
    """A copy of the fused step's training state and the random state
    its next step draws from."""
    from mxnet_tpu_torch import random as mxrandom

    fs = mod._fused_step
    gen = mxrandom.generator(fs._device)
    return {"params": {n: v.clone() for n, v in fs.params.items()},
            "auxs": {n: v.clone() for n, v in fs.auxs.items()},
            "states": {n: v.clone() for n, v in fs.states.items()},
            "t": fs._t, "num_update": mod._optimizer.num_update,
            "gen": gen.get_state()}


def _fused_restore(torch, mod, snap):
    from mxnet_tpu_torch import random as mxrandom

    fs = mod._fused_step
    with torch.no_grad():
        for table in ("params", "auxs", "states"):
            for n, v in snap[table].items():
                getattr(fs, table)[n].copy_(v)
    fs._t = snap["t"]
    mod._optimizer.num_update = snap["num_update"]
    mxrandom.generator(fs._device).set_state(snap["gen"])
    mod._fused_dirty = True
    mod._params_dirty = True


def _rel_worst(torch, got, want):
    """{name: max |got - want| / max |want|} over two dicts of tensors."""
    return {n: ((got[n] - w).abs().max()
                / w.abs().max().clamp_min(1e-30)).item()
            for n, w in want.items()}


def _half_depth_module(torch, mx, trained):
    """Phase 17's module, cut for the script's budget (on an H100 80GB
    HBM3 at 700 W phase 17 took 27.08 s at full depth):
    Inception-ResNet-v2 at HALF_DEPTH with phase 6's trained weights of
    its blocks, bound at phase 6's shapes and trained two steps, so that
    its step is captured as phase 6's was. Returns (module, the card's
    allocated bytes before its bind)."""
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    net = get_inception_resnet_v2(num_classes=1000, repeats=HALF_DEPTH)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    data = _train_data(mx, TRAIN_STEPS, TRAIN_BATCH)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(data.provide_data, data.provide_label)
    mod.set_params(*_weights_of(net, trained))
    mod.init_optimizer(optimizer="sgd", optimizer_params=_OPT)
    for batch in list(data)[:2]:
        mod.forward_backward(batch)
        mod.update()
    torch.cuda.synchronize()
    fs = mod._fused_step
    check(fs is not None and fs.graphed and fs.captures == 1,
          f"the half-depth module's step is not captured: "
          f"{None if fs is None else (fs.graphed, fs.captures)}")
    return mod, base


def phase_fused(torch, mx, mod, data, base_bytes, pipeline=None):
    """A module with a captured step (`_half_depth_module`) through the
    fused-step surface: fused against eager, graphed step times, run_steps
    and fit(steps_per_dispatch=4), the numerics sentinel and an injected
    NaN, both monitors, the pre-flight against the measured peak, and the
    deviceStats and CalibrationStore records. `pipeline(res)` (phase 18)
    runs on the same module after the fits, before the monitors."""
    import shutil

    from mxnet_tpu_torch import passes, profiler, profiling

    res = {}
    part = _parts(res)
    fs = mod._fused_step
    check(fs is not None and fs.graphed,
          f"the module has no graphed fused step "
          f"({None if fs is None else fs.uncaptured_op})")
    batches = list(data)
    data.reset()
    batch = batches[0]
    names = sorted(fs.params)

    # (a) one fused step against one eager step from the same state
    snap = _fused_state(torch, mod)
    mod.forward_backward(batch)
    mod.update()
    f_out = mod.get_outputs()[0].data.clone()
    f_par = {n: v.clone() for n, v in fs.params.items()}
    _fused_restore(torch, mod, snap)
    mod.forward(batch, is_train=True)
    e_out = mod.get_outputs()[0].data.clone()   # the eager lifecycle
    mod.backward()
    mod.update()
    e_par = {n: v.data for n, v in mod.get_params()[0].items()}
    worst = _rel_worst(torch, f_par, e_par)
    worst["output"] = _rel_worst(torch, {"o": f_out}, {"o": e_out})["o"]
    name = max(worst, key=worst.get)
    res["fused_vs_eager_worst"] = {"tensor": name, "rel": worst[name]}
    check(worst[name] <= TRAIN_PARITY_RTOL,
          f"fused step against eager step: {name} differs by "
          f"{worst[name]!r} of its max (> {TRAIN_PARITY_RTOL})")
    # the eager path alone (the Module before the fused step: the
    # executor's walk, autograd, the updater's multi-tensor SGD): the
    # step hands its state to the updater for them
    mod._disable_fused("eager steps timed")
    eager_ms = []
    for b in batches[1:1 + FUSED_EAGER_STEPS]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mod.forward_backward(b)
        mod.update()
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    # the same fused step takes the state back: its graph holds its own
    # tensors, which the refresh before its next run overwrites with the
    # eager steps' parameters and optimizer state
    mod._fused_step = fs
    mod._fused_stale = True
    mod._opt_state_bifurcated = True
    res["eager_step_ms"] = eager_ms
    res["eager_step_ms_p50"] = float(np.percentile(eager_ms, 50))
    log(f"fused: one step against the eager step from the same state: "
        f"worst {name} {worst[name]!r} of its max; eager steps "
        f"{eager_ms!r} ms")
    part("fused_vs_eager")

    # (b) ten graphed steps: p50/p95, busy share, captures, launches
    captures0 = fs.captures
    passes.reset_launch_counts()
    step_ms = []
    torch.cuda.synchronize()
    for b in batches[:FUSED_STEPS]:
        t0 = time.perf_counter()
        mod.forward_backward(b)
        mod.update()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = passes.launch_counts()
    res["captures_in_steps"] = fs.captures - captures0
    check(res["captures_in_steps"] == 0,
          f"{res['captures_in_steps']} captures after warmup")
    per_step = {k: v / FUSED_STEPS for k, v in launches.items()}
    res["launches_per_step"] = per_step
    check(per_step["elementwise"] == 1
          and per_step["scale_bias_act"] == sum(HALF_DEPTH),
          f"B1/B2 launches a graphed step {per_step} != 1 and "
          f"{sum(HALF_DEPTH)}")
    steady = step_ms[1:]
    res.update({"step_ms": step_ms,
                "step_ms_p50": float(np.percentile(steady, 50)),
                "step_ms_p95": float(np.percentile(steady, 95))})
    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        mod.forward_backward(batch)
        mod.update()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    res["profile"] = _device_time(torch, prof, wall_us, 8, "fused step")
    log(f"fused: {FUSED_STEPS} graphed steps {step_ms!r} ms, p50 "
        f"{res['step_ms_p50']!r} ms p95 {res['step_ms_p95']!r} ms beside "
        f"the eager p50 {res['eager_step_ms_p50']!r} ms; busy share "
        f"{res['profile']['busy_share']!r}; captures after warmup "
        f"{res['captures_in_steps']}; B1/B2 launches a step {per_step}")
    part("graphed_steps")

    # (c) run_steps(k=4, stacked) against four single steps; fit with
    # steps_per_dispatch=4
    # the four single steps run twice from one state: cuDNN's weight
    # gradients accumulate with atomics, so two runs of the same steps
    # differ, and momentum carries the difference on from step to step
    four = batches[:4]
    snap = _fused_state(torch, mod)
    singles = []
    for _ in range(2):
        _fused_restore(torch, mod, snap)
        for b in four:
            mod.forward_backward(b)
            mod.update()
        singles.append(({n: v.clone() for n, v in fs.params.items()},
                        mod.get_outputs()[0].data.clone()))
    _fused_restore(torch, mod, snap)
    captures0 = fs.captures
    stacked = mx.io.DataBatch(
        data=[mx.nd.stack(*[b.data[0] for b in four])],
        label=[mx.nd.stack(*[b.label[0] for b in four])])
    mod.run_steps(stacked, 4, stacked=True)

    def worst_of(params, out, ref):
        w = _rel_worst(torch, params, ref[0])
        w["output"] = _rel_worst(torch, {"o": out}, {"o": ref[1]})["o"]
        name = max(w, key=w.get)
        return {"tensor": name, "rel": w[name]}

    got = worst_of(fs.params, mod.get_outputs()[0].data, singles[0])
    spread = worst_of(*singles[1], singles[0])
    res["run_steps_vs_single_worst"] = got
    res["single_vs_single_worst"] = spread
    limit = max(TRAIN_PARITY_RTOL, RUN_STEPS_SPREAD * spread["rel"])
    res["run_steps_limit"] = limit
    name = got["tensor"]
    check(got["rel"] <= limit,
          f"run_steps(4) against four steps: {name} {got['rel']!r} of "
          f"its max, beyond {limit!r} (the same four steps run twice: "
          f"{spread})")
    check(fs.captures == captures0, "run_steps captured a graph")
    seen = []
    x, y = _host_inputs("train", lambda: _train_arrays(TRAIN_STEPS,
                                                       TRAIN_BATCH))
    n = FUSED_FIT_BATCHES * TRAIN_BATCH
    fit_data = mx.io.NDArrayIter(x[:n], y[:n], batch_size=TRAIN_BATCH,
                                 shuffle=False, label_name="softmax_label")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(fit_data, num_epoch=1, optimizer="sgd", optimizer_params=_OPT,
            steps_per_dispatch=4,
            batch_end_callback=lambda p: seen.append(p.nbatch))
    torch.cuda.synchronize()
    res["fit_k4_s"] = time.perf_counter() - t0
    check(seen == [4, 8], f"fit(steps_per_dispatch=4) callbacks at {seen}")
    check(fs.captures == captures0, "fit(steps_per_dispatch=4) captured")
    log(f"fused: run_steps(4, stacked) against four steps worst {name} "
        f"{got['rel']!r} (the four steps twice: {spread}); "
        f"fit(steps_per_dispatch=4) over "
        f"{FUSED_FIT_BATCHES} batches {res['fit_k4_s']!r} s, callbacks at "
        f"{seen}")
    part("run_steps")
    if pipeline is not None:
        fs = None                 # phase 18 builds the step again
        pipeline(res)
        part("pipeline")
        fs = mod._fused_step

    # (e) Monitor(device=True) keeps the graph; an eager Monitor later
    dev_mon = mx.Monitor(1, device=True)
    mod.install_monitor(dev_mon)
    for b in batches[:2]:     # the sentinel's recapture: warmup, capture
        dev_mon.tic()
        mod.forward_backward(b)
        mod.update()
        dev_mon.toc()
    captures0 = fs.captures
    profiler.reset_host_sync_stats()
    records = []
    for b in batches[2:5]:
        dev_mon.tic()
        mod.forward_backward(b)
        mod.update()
        records += dev_mon.toc()
    syncs = profiler.host_sync_stats()
    res["device_monitor"] = {"records": len(records),
                             "captures": fs.captures - captures0,
                             "fetches": syncs["blocking_fetches"]}
    check(fs.captures == captures0 and mod._fused_step is fs,
          "Monitor(device=True) did not keep the graph")
    check(syncs["blocking_fetches"] == 3 and {"loss", "grad_norm"} <= {
        r[1] for r in records}, f"device monitor: {res['device_monitor']}")
    log(f"fused: Monitor(device=True) over 3 steps: "
        f"{json.dumps(res['device_monitor'])}")
    mod._monitor = None
    for exe in mod._exec_group.execs:
        exe.set_monitor_callback(None)
    part("device_monitor")

    # (d) the numerics sentinel: rows drained in one fetch each, no
    # host sync a step
    mon = mx.NumericsMonitor(interval=5)
    mon.attach(mod)
    check(mon.active, "NumericsMonitor did not attach to the fused step")
    profiler.reset_host_sync_stats()
    t_first = fs._t + 1
    for i, b in enumerate(batches[:FUSED_STEPS]):
        mod.forward_backward(b)
        mod.update()
        mon.after_batch(mod, 0, i)
    mid = profiler.host_sync_stats()
    mon.drain(mod)
    end = profiler.host_sync_stats()
    steps = [r["step"] for r in mon.history]
    res["numerics"] = {"rows": len(steps), "fetches_in_steps":
                       mid["blocking_fetches"], "waits_in_steps":
                       mid["blocking_waits"], "fetches_total":
                       end["blocking_fetches"],
                       "grad_norm_last": mon.history[-1]["grad_norm"]}
    check(steps == list(range(t_first, t_first + FUSED_STEPS)),
          f"sentinel rows for steps {steps}")
    check(mid["blocking_waits"] == 0 and mid["blocking_fetches"] <= 2
          and end["blocking_fetches"] <= 3,
          f"numerics host syncs {res['numerics']}")
    log(f"fused: NumericsMonitor(interval=5) over {FUSED_STEPS} steps: "
        f"{json.dumps(res['numerics'])}")
    part("numerics")

    # (f) the pre-flight's estimate against the measured peak
    exe = mod._exec_group.execs[0]
    report = profiling.preflight_bind(
        exe._opt_symbol,
        {n: (tuple(a.shape), a.dtype) for n, a in exe.arg_dict.items()},
        exe._grad_req,
        auxs={n: (tuple(a.shape), a.dtype) for n, a in exe.aux_dict.items()},
        device=exe._device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mod.forward_backward(batch)
    mod.update()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base_bytes
    res["preflight"] = {k: report[k] for k in (
        "param_bytes", "grad_bytes", "opt_bytes", "activation_bytes",
        "total_bytes", "cap_bytes", "fits")}
    res["measured_peak_bytes"] = peak
    # a replay allocates nothing: the graph's intermediates live in its
    # pool, reserved at the capture
    pool = profiling.records_for(digest=fs._profiling_digest(),
                                 kind="fused_step")[0]["temp_bytes"]
    res["graph_pool_bytes"] = pool
    log(f"fused: pre-flight estimate {report['total_bytes']} B (params "
        f"{report['param_bytes']}, grads {report['grad_bytes']}, opt "
        f"{report['opt_bytes']}, activations {report['activation_bytes']}; "
        f"cap {report['cap_bytes']}) beside the measured peak of a graphed "
        f"step {peak} B (max_memory_allocated above the bind's base) and "
        f"the graph pool's {pool} B")
    part("preflight")

    # (g) deviceStats: the captured step's record; fit's calibration
    rec = profiling.records_for(digest=fs._profiling_digest(),
                                kind="fused_step")
    check(rec and rec[0]["graphed"] and rec[0]["flops"] > 0,
          f"no graphed fused_step record: {rec}")
    rec = rec[0]
    cal = profiling.calibration_store().records(
        digest=mod.symbol.canonical_signature())
    fit_rec = [r for r in cal.values() if r["kind"] == "fit_step"]
    check(fit_rec and fit_rec[0]["platform"] == "gpu",
          f"no fit_step calibration record: {cal}")
    res["device_stats"] = {k: rec[k] for k in (
        "kind", "executables", "compile_s", "trace_s", "arg_bytes",
        "out_bytes", "temp_bytes", "hbm_bytes", "flops", "graphed")}
    res["calibration"] = fit_rec[0]
    res["step_tflops"] = rec["flops"] / (res["step_ms_p50"] * 1e-3) / 1e12
    log(f"fused: deviceStats {json.dumps(res['device_stats'])}; fit's "
        f"calibration record {json.dumps(fit_rec[0])}")
    part("records")

    # (e, eager) Monitor(1, pattern=".*weight") over one eager step
    mon_w = mx.Monitor(1, pattern=".*weight")
    mod.install_monitor(mon_w)
    check(mod._fused_step is None, "an eager Monitor kept the fused step")
    mon_w.tic()
    mod.forward_backward(batch)
    mod.update()
    profiler.reset_host_sync_stats()
    rows = mon_w.toc()
    fetches = profiler.host_sync_stats()["blocking_fetches"]
    weights = sorted(n for n in exe._arg_names if n.endswith("weight"))
    got = sorted({r[1] for r in rows if r[1].endswith("weight")})
    res["eager_monitor"] = {"records": len(rows), "fetches": fetches,
                            "weights": len(got)}
    check(got == weights and fetches == 1,
          f"eager Monitor: {len(got)} of {len(weights)} weights, "
          f"{fetches} fetches")
    part("eager_monitor")

    # (d, injected) MXNET_TPU_FAULT_INJECT=nan:step:N:<weight>
    mod._monitor = None
    exe.set_monitor_callback(None)
    target = "b35_1_proj_conv_weight"
    flight_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    os.environ["MXNET_TPU_FAULT_INJECT"] = f"nan:step:3:{target}"
    os.environ["MXNET_TELEMETRY_FLIGHT_DIR"] = flight_dir
    flops = fs.flops()
    try:
        mod._build_fused_step()
    finally:
        del os.environ["MXNET_TPU_FAULT_INJECT"]
    fs = mod._fused_step
    fs._flops = flops      # counted already: its first run skips the count
    mod._fused_dirty = False
    mon = mx.NumericsMonitor(interval=1)
    mon.attach(mod)
    for b in batches[:4]:
        mon.note_batch(b)
        mod.forward_backward(b)
        mod.update()
        # a blocking drain each step: the attribution replays the batch
        # on the parameters of the step whose row tripped
        mon.drain(mod)
        if mon.anomalies:
            break
    bad = [a for a in mon.anomalies if a.kind == "nonfinite"]
    from mxnet_tpu_torch.numerics import stats as nstats

    last = nstats.numerics_stats().get("last_anomaly", {})
    flights = sorted(os.listdir(flight_dir))
    res["injected"] = {"anomaly_step": bad[0].step if bad else None,
                       "first_bad_op": last.get("first_bad_op"),
                       "flight_records": flights}
    check(bad and bad[0].step == 3, f"no nonfinite anomaly at step 3: "
          f"{[a.to_dict() for a in mon.anomalies]}")
    check(str(res["injected"]["first_bad_op"]).startswith("b35_1_proj"),
          f"the first bad op {res['injected']['first_bad_op']!r} is not "
          f"the one that reads {target}")
    check(any(f.endswith(".json") for f in flights),
          "no flight record written")
    log(f"fused: injected NaN into {target}'s gradient at step 3: "
        f"{json.dumps(res['injected'])}")
    del os.environ["MXNET_TELEMETRY_FLIGHT_DIR"]
    shutil.rmtree(flight_dir, ignore_errors=True)
    part("injected")
    mon.close()
    return res


# ----------------------------------------------------------- phase 18
PIPE_RECORDS = 320             # 10 batches of 32, one epoch
PIPE_IMAGE = 299
PIPE_SEED = 18
PIPE_PREFETCH = 2
PIPE_RESUME_AT = 4             # the state_dict taken after this many steps
PIPE_BUCKET_REPLAYS = 3
LAYOUT_STEPS = 3               # timed replays a layout
LAYOUT_SPEC = "dce,fold,cse,layout,canonicalize,fusion_hints,codegen"


def _pipeline_file(tmp):
    """PIPE_RECORDS seeded 299x299x3 uint8 images (raw bytes: nothing on
    the card's path decodes JPEG), each record's label its index."""
    from mxnet_tpu_torch import recordio

    rs = np.random.RandomState(PIPE_SEED)
    idx, rec = os.path.join(tmp, "train.idx"), os.path.join(tmp, "train.rec")
    with recordio.MXIndexedRecordIO(idx, rec, "w") as w:
        for i in range(PIPE_RECORDS):
            img = rs.randint(0, 256, (PIPE_IMAGE, PIPE_IMAGE, 3),
                             dtype=np.uint8)
            w.write_idx(i, recordio.pack(
                recordio.IRHeader(0, float(i), i, 0), img.tobytes()))
    return idx, rec


def _pipeline_decode(payload):
    """One record: the pixels as float32 in [-1, 1], CHW; the label."""
    from mxnet_tpu_torch import recordio

    header, raw = recordio.unpack(payload)
    img = np.frombuffer(raw, np.uint8).reshape(PIPE_IMAGE, PIPE_IMAGE, 3)
    x = img.transpose(2, 0, 1).astype(np.float32) * (1.0 / 127.5) - 1.0
    return x, np.float32(header.label)


class _HostProbe:
    """What the host did during one fit: a thread that asks for 1 ms
    sleeps and records each wake later than 3 ms (a late wake is time the
    GIL or a core was held by someone else), the collector's pauses over
    2 ms, each thread's CPU ms from /proc, and the process's threads."""

    def __init__(self):
        import gc

        self.late, self.gc, self._t, self._stop = [], [], {}, None
        self._gc = gc
        self.t0 = time.perf_counter()

    @staticmethod
    def _cpu():
        names = {t.native_id: t.name for t in threading.enumerate()}
        out = {}
        for tid in os.listdir("/proc/self/task"):
            try:
                with open(f"/proc/self/task/{tid}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            out[f"{names.get(int(tid), 'native')}:{tid}"] = (
                int(fields[11]) + int(fields[12]))
        return out

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t["gc"] = time.perf_counter()
        elif "gc" in self._t:
            start = self._t.pop("gc")
            d = time.perf_counter() - start
            if d > 2e-3:
                self.gc.append((round((start - self.t0) * 1e3, 1),
                                round(d * 1e3, 2), info["generation"]))

    def _run(self, stop):
        while not stop.is_set():
            t = time.perf_counter()
            time.sleep(1e-3)
            late = time.perf_counter() - t - 1e-3
            if late > 3e-3:
                self.late.append((round((t - self.t0) * 1e3, 1),
                                  round(late * 1e3, 2)))

    def __enter__(self):
        self.threads = sorted(t.name for t in threading.enumerate())
        self._cpu0 = self._cpu()
        self._gc.callbacks.append(self._on_gc)
        self._stop = threading.Event()
        self._th = threading.Thread(target=self._run, args=(self._stop,),
                                    daemon=True, name="host-probe")
        self.t0 = time.perf_counter()
        self._th.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._th.join()
        self._gc.callbacks.remove(self._on_gc)
        tick_ms = 1e3 / os.sysconf("SC_CLK_TCK")
        cpu = self._cpu()
        self.cpu_ms = {k: (v - self._cpu0.get(k, 0)) * tick_ms
                       for k, v in cpu.items()
                       if v - self._cpu0.get(k, 0) > 0}
        return False

    def summary(self):
        return {"threads_at_start": self.threads,
                "late_wakes_ms": self.late, "gc_pauses_ms": self.gc,
                "thread_cpu_ms": self.cpu_ms,
                "loadavg": os.getloadavg()}


def _pipeline_fit(torch, mx, mod, files, prefetch):
    """One epoch of mod.fit over the RecordIO file through make_pipeline:
    step ms (each ended by a synchronize), the labels each step's input
    buffer held, the stats, launches, captures and the state after
    PIPE_RESUME_AT steps."""
    from mxnet_tpu_torch import data as mxdata
    from mxnet_tpu_torch import passes

    fs = mod._fused_step
    pipe = mxdata.make_pipeline(
        mxdata.RecordSource(*files, _pipeline_decode),
        batch_size=TRAIN_BATCH, seed=0, prefetch=prefetch)
    labels, ends, state = [], [], {}
    shape = (TRAIN_BATCH, 3, PIPE_IMAGE, PIPE_IMAGE)

    def on_batch(param):
        # the labels the step's input buffer held (a 128-byte fetch)
        prog = next(p for p in fs._programs.values()
                    if tuple(p.inputs["data"].shape) == shape)
        labels.append(prog.inputs["softmax_label"].cpu().numpy().copy())
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        if param.nbatch == PIPE_RESUME_AT - 1:
            state.update(pipe.state_dict())

    captures0 = fs.captures
    mxdata.reset_input_pipeline_stats()
    passes.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _HostProbe() as probe:
        mod.fit(pipe, num_epoch=1, optimizer="sgd",
                optimizer_params=_OPT, batch_end_callback=on_batch)
        torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = passes.launch_counts()
    stats = mxdata.input_pipeline_stats()
    ring = pipe.ring_stats()
    # each batch's marks in ms from the fit's start (the pipeline's own
    # clock readings): the loader's decode, the stager's pull and copy,
    # the consumer's ask
    timeline = [{k: (round((v - t0) * 1e3, 3) if isinstance(v, float)
                     else v) for k, v in m.items()}
                for m in pipe.timeline() if m["epoch"] == 0]
    pipe.close()
    check(len(ends) == PIPE_RECORDS // TRAIN_BATCH,
          f"fit over the pipeline ran {len(ends)} steps")
    starts = [t0] + ends[:-1]
    step_ms = [(e - s) * 1e3 for s, e in zip(starts, ends)]
    steady = step_ms[1:]
    n = len(step_ms)
    return {"fit_s": fit_s, "step_ms": step_ms,
            "step_ms_p50": float(np.percentile(steady, 50)),
            "step_ms_p95": float(np.percentile(steady, 95)),
            "captures": fs.captures - captures0,
            "launches_per_step": {k: v / n for k, v in launches.items()},
            "launches": launches, "stats": stats, "ring": ring,
            "timeline": timeline, "host": probe.summary(),
            "labels": labels, "state": state}


def _rebuild_fused(mod):
    """The module's fused step built again over its trained parameters
    and optimizer state: the bucketed update's knob is read at the
    build. The next call of each signature captures anew."""
    old = mod._fused_step
    mod._flush_fused()
    mod._build_fused_step(carry_from=old)
    mod._fused_step._flops = old._flops   # counted: no count a build
    old._invalidate()                     # its graphs and their pool
    return mod._fused_step


def _pipeline_bucketed(torch, mx, mod, batches):
    """MXNET_TPU_OPT_BUCKET=1 and the module's step built again: the
    plan, its one recapture, a bucketed replay against a per-parameter
    replay from one snapshot, and the bucketed replays' p50. The step is
    built again per parameter after it (phase 17's later parts)."""
    fs = mod._fused_step
    b0 = batches[0]
    snap = _fused_state(torch, mod)
    mod.forward_backward(b0)
    mod.update()
    per = ({n: v.clone() for n, v in fs.params.items()},
           mod.get_outputs()[0].data.clone())
    os.environ["MXNET_TPU_OPT_BUCKET"] = "1"
    try:
        fs = _rebuild_fused(mod)
        check(fs._bucket_active,
              "MXNET_TPU_OPT_BUCKET=1: the bucket plan is not active")
        for b in batches[1:3]:    # the new body's first run, its capture
            mod.forward_backward(b)
            mod.update()
        _fused_restore(torch, mod, snap)
        mod.forward_backward(b0)
        mod.update()
        got = ({n: v.clone() for n, v in fs.params.items()},
               mod.get_outputs()[0].data.clone())
        ms = []
        for b in batches[3:3 + PIPE_BUCKET_REPLAYS]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(b)
            mod.update()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        flat = fs._bucket.weight
        lo = flat.data_ptr()
        hi = lo + flat.numel() * flat.element_size()
        inside = all(lo <= fs.params[n].data_ptr() < hi
                     for n in fs._trainable)
        recaptures = fs.captures
    finally:
        os.environ["MXNET_TPU_OPT_BUCKET"] = "0"
        _rebuild_fused(mod)    # the module back to the per-parameter update

    def worst_of(a, b):
        w = _rel_worst(torch, a[0], b[0])
        w["output"] = _rel_worst(torch, {"o": a[1]}, {"o": b[1]})["o"]
        name = max(w, key=w.get)
        return {"tensor": name, "rel": w[name]}

    vs = worst_of(got, per)
    # phase 17's rule for one step from one snapshot (its spread
    # alternative is for several steps, where momentum carries cuDNN's
    # atomics)
    limit = TRAIN_PARITY_RTOL
    out = {"active": True, "recaptures": recaptures,
           "flat_elems": int(flat.numel()), "views_inside_flat": inside,
           "vs_per_param_worst": vs, "limit": limit, "replay_ms": ms,
           "replay_ms_p50": float(np.percentile(ms, 50))}
    check(recaptures == 1, f"the bucket plan recaptured {recaptures} times")
    check(inside, "a trained parameter is not a view into the flat buffer")
    check(vs["rel"] <= limit,
          f"bucketed replay against per-parameter replay: {vs} beyond "
          f"{limit!r}")
    log(f"pipeline: bucketed update (MXNET_TPU_OPT_BUCKET=1): "
        f"{json.dumps(out)}")
    return out


def _kernel_names(torch, fn):
    """{device kernel name: launches} of one call of `fn` (the card's
    activity only)."""
    cuda = torch.autograd.DeviceType.CUDA
    act = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=act) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == cuda and e.self_device_time_total > 0
            and e.key not in ("fused_train_step", "fused_train_steps")}


def _favour_plain_store(torch, digests):
    """Point MXNET_CALIBRATION_CACHE at a new file whose records say each
    group of `digests` runs 10^4 times faster as its plain version than
    as its kernel on "gpu" (what a store kept across runs can say of a
    group that ties its plain version); returns the path it replaced."""
    from mxnet_tpu_torch import profiling

    prev = os.environ["MXNET_CALIBRATION_CACHE"]
    os.environ["MXNET_CALIBRATION_CACHE"] = os.path.join(
        os.path.dirname(prev), "favour_plain.json")
    store = profiling.calibration_store()
    for d in digests:
        store.record(d, "gpu", "kernel", 10e-3)
        store.record(d, "gpu", "kernel_lax", 1e-6)
    return prev


def _pipeline_layout(torch, mx, trained, batches, digests):
    """The layout pass at HALF_DEPTH: the same weights bound with and
    without it; rewrites, first-step parity, kernels and step p50s. The
    steps run uncaptured (`FusedTrainStep.eager()`, no capture a bind)
    and without the profiling records (MXNET_PROFILING=0: no flop
    count over the first step). Both binds read a calibration file
    whose records favour the plain version of each of phase 6's groups
    (`digests`): each group is marked calibrated_slower and its kernel
    still launches."""
    from mxnet_tpu_torch import passes
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    net = get_inception_resnet_v2(num_classes=1000, dropout=0.0,
                                  repeats=HALF_DEPTH)
    args, auxs = _weights_of(net, trained)
    # the 2-D NCHW Convolution and Pooling nodes, read from the graph
    conv_pool = sum(
        1 for gn in passes.Graph.from_symbol(net).nodes
        if gn.op in ("Convolution", "Pooling")
        and len(gn.params().get("kernel") or ()) == 2
        and str(gn.params().get("layout") or "NCHW") == "NCHW")
    names = sorted(n for n in args)
    out, firsts, seeded = {}, {}, {}
    os.environ["MXNET_PROFILING"] = "0"
    cal_path = _favour_plain_store(torch, digests)
    try:
        for label, spec in (("NCHW", "1"), ("layout", LAYOUT_SPEC)):
            os.environ["MXNET_GRAPH_PASSES"] = spec
            before = passes.graph_pass_stats()["layout_rewrites"]
            try:
                m = mx.mod.Module(net, context=mx.gpu(0))
                t0 = time.perf_counter()
                m.bind([("data", (TRAIN_BATCH, 3, PIPE_IMAGE, PIPE_IMAGE))],
                       [("softmax_label", (TRAIN_BATCH,))])
                bind_s = time.perf_counter() - t0
            finally:
                del os.environ["MXNET_GRAPH_PASSES"]
            rewrites = passes.graph_pass_stats()["layout_rewrites"] - before
            m.set_params(args, auxs)
            m.init_optimizer(optimizer="sgd", optimizer_params=_OPT)
            plan = [g.digest for g, _ in
                    m._exec_group.execs[0]._codegen_plan.fused.values()]
            recs = passes.fusion_group_records()
            passes.reset_launch_counts()
            with _retained_grads():
                kernels = _kernel_names(torch, lambda: (
                    m.forward_backward(batches[0]), m.update()))
                firsts[label] = _step_outputs_grads(m, names)
            seeded[label] = {
                "groups_lowered": len(plan),
                "groups_in_store": sum(d in digests for d in plan),
                "calibrated_slower": sum(
                    bool(recs[d]["calibrated_slower"]) for d in plan),
                "first_step_launches": passes.launch_counts()}
            ms = []
            with m._fused_step.eager():
                for b in batches[1:1 + LAYOUT_STEPS]:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m.forward_backward(b)
                    m.update()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
            out[label] = {"rewrites": rewrites, "bind_s": bind_s,
                          "step_ms_uncaptured": ms,
                          "step_ms_p50": float(np.percentile(ms, 50)),
                          "kernels": kernels}
            del m
            torch.cuda.empty_cache()
    finally:
        del os.environ["MXNET_PROFILING"]
        os.environ["MXNET_CALIBRATION_CACHE"] = cal_path
    (o0, g0), (o1, g1) = firsts["NCHW"], firsts["layout"]
    worst = _rel_worst(torch, g1, g0)
    worst["output"] = _rel_worst(torch, {"o": o1[0]}, {"o": o0[0]})["o"]
    name = max(worst, key=worst.get)
    k0, k1 = out["NCHW"].pop("kernels"), out["layout"].pop("kernels")
    extra = {k: v for k, v in k1.items() if v > k0.get(k, 0)}
    res = {"conv_pool_nodes": conv_pool,
           "layout_rewrites": out["layout"]["rewrites"],
           "first_step_worst": {"tensor": name, "rel": worst[name]},
           "kernels_first_step": {"NCHW": sum(k0.values()),
                                  "layout": sum(k1.values())},
           "kernels_only_or_more_with_layout": extra,
           "nhwc_kernels": {label: {k[:60]: v for k, v in ks.items()
                                    if "nhwc" in k.lower()}
                            for label, ks in (("NCHW", k0),
                                              ("layout", k1))},
           "NCHW": out["NCHW"], "layout": out["layout"],
           "over_favour_plain_store": seeded}
    nchw = seeded["NCHW"]
    first = nchw["first_step_launches"]
    check(nchw["groups_in_store"] == nchw["groups_lowered"]
          == nchw["calibrated_slower"] == 1 + sum(HALF_DEPTH),
          f"over records favouring the plain versions: {nchw}")
    check(first["elementwise"] == 1
          and first["scale_bias_act"] == sum(HALF_DEPTH),
          f"over records favouring the plain versions, B1/B2 launched "
          f"{first} in the first step, not 1 and {sum(HALF_DEPTH)}")
    check(res["layout_rewrites"] == conv_pool and out["NCHW"]["rewrites"]
          == 0, f"layout_rewrites {res['layout_rewrites']} (without the "
          f"pass {out['NCHW']['rewrites']}) != {conv_pool} 2-D "
          f"Convolution and Pooling nodes")
    check(worst[name] <= TRAIN_PARITY_RTOL,
          f"layout pass: the first step's {name} differs by {worst[name]!r} "
          f"of its max (> {TRAIN_PARITY_RTOL})")
    log(f"pipeline: layout pass at half depth {HALF_DEPTH}: "
        f"{json.dumps(res)}")
    return res


def _pipeline_tuner(torch, mx, mod, training, batch):
    """The autotuner's record for the module's graph on "gpu", and the
    codegen's calibrated_slower count at phase 6's bind."""
    from mxnet_tpu_torch import passes, profiling
    from mxnet_tpu_torch.passes.tuner import choose_fusion_kernel

    shapes = {"data": (TRAIN_BATCH, 3, PIPE_IMAGE, PIPE_IMAGE),
              "softmax_label": (TRAIN_BATCH,)}
    net = mod.symbol
    digest = net.canonical_signature()
    store = profiling.calibration_store()
    kinds = sorted(r["kind"] for r in store.records(digest=digest).values())
    first = passes.Autotuner().choose(net, shapes, platform="gpu")
    # a measured forward of the graph, harvested as the serving tier's
    # warmup does (kind "forward"): the record the tuner upgrades from
    mod.forward(batch, is_train=False)
    mod.get_outputs()[0].wait_to_read()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.forward(batch, is_train=False)
    mod.get_outputs()[0].wait_to_read()
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    store.record(digest, "gpu", "forward", fwd_s)
    tuning = os.environ["MXNET_TUNING_CACHE"] + ".fresh"
    second = passes.Autotuner(cache_path=tuning).choose(
        net, shapes, platform="gpu")
    digests = sorted(training["launches_per_step_by_digest"])
    favour = [d for d in digests if choose_fusion_kernel(d, "gpu") == "lax"]
    ratio = {}
    for d in digests:
        k = store.measured_seconds(d, "gpu", "kernel")
        p = store.measured_seconds(d, "gpu", "kernel_lax")
        if k and p:
            ratio[d] = p / k
    res = {"calibration_kinds_before": kinds, "first": first,
           "forward_s": fwd_s, "with_forward_record": second,
           "calibrated_slower_at_phase6_bind":
               training["fusion_stats"]["calibrated_slower"],
           "fallback_at_phase6_bind":
               training["fusion_stats"]["groups_fallback"],
           "calibration_s_at_phase6_bind":
               training["fusion_stats"]["calibration_s"],
           "cold_bind_s_at_phase6": training["cold_bind_s"],
           "groups_timed": len(ratio),
           "groups_the_records_favour_plain": len(favour),
           "plain_over_kernel_min": min(ratio.values()) if ratio else None,
           "plain_over_kernel_max": max(ratio.values()) if ratio else None}
    check(first["layout"] == "NCHW" and second["layout"] == "NCHW",
          f"the tuner chose {first['layout']}/{second['layout']} on a card")
    check(second["source"] == "calibrated",
          f"the tuner's record with a forward record: {second}")
    check(len(ratio) == len(digests),
          f"kernel/plain timings for {len(ratio)} of {len(digests)} groups")
    log(f"pipeline: tuner {json.dumps(res)}")
    return res


def phase_pipeline(torch, mx, mod, training, fused):
    """Phase 18: phase 6's module (its bind, weights and captured step)
    trained from a RecordIO file through DevicePrefetchIter; then the
    bucketed update, the layout pass and the tuner."""
    from mxnet_tpu_torch import data as mxdata

    res = {}
    part = _parts(res)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rec_")
    try:
        files = _pipeline_file(tmp)
        res["file_bytes"] = os.path.getsize(files[1])
        part("file")
        on = _pipeline_fit(torch, mx, mod, files, PIPE_PREFETCH)
        part("fit_prefetch_on")
        off = _pipeline_fit(torch, mx, mod, files, 0)
        part("fit_prefetch_off")
        # (d) the order of the labels that reached the step, and resume
        perm = mxdata.epoch_permutation(0, 0, PIPE_RECORDS)
        want = perm.reshape(-1, TRAIN_BATCH).astype(np.float32)
        for arm in (on, off):
            check(np.array_equal(np.stack(arm["labels"]), want),
                  "the labels that reached the step are not "
                  "epoch_permutation(0, 0, 320)")
        check(on["state"].get("position") == PIPE_RESUME_AT,
              f"state_dict after {PIPE_RESUME_AT} steps: {on['state']}")
        fresh = mxdata.make_pipeline(
            mxdata.RecordSource(*files, _pipeline_decode),
            batch_size=TRAIN_BATCH, seed=0, prefetch=PIPE_PREFETCH)
        fresh.load_state_dict(on["state"])
        rest = [b.label[0].asnumpy() for b in fresh]
        fresh.close()
        check(len(rest) == len(want) - PIPE_RESUME_AT and all(
            np.array_equal(a, b) for a, b in zip(rest,
                                                 want[PIPE_RESUME_AT:])),
              f"the resumed pipeline's {len(rest)} batches are not the "
              f"remaining ones")
        part("order_resume")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    for arm, name in ((on, "on"), (off, "off")):
        check(arm["captures"] == 0,
              f"prefetch {name}: {arm['captures']} captures in the fit")
        per = arm["launches_per_step"]
        check(per["elementwise"] == 1 and per["scale_bias_act"] == 39,
              f"prefetch {name}: B1/B2 launches a step {per}")
    n = len(on["step_ms"])
    log(f"pipeline: prefetch on, each batch's timeline (ms from the "
        f"fit's start): {json.dumps(on['timeline'])}; the host during the "
        f"fit: {json.dumps(on['host'])}")
    check(on["stats"]["stall_count"] == 0,
          f"prefetch on: {on['stats']['stall_count']} stalls in a "
          f"steady-state epoch")
    check(off["stats"]["stall_count"] == off["stats"]["batches"] == n,
          f"prefetch off: {off['stats']['stall_count']} stalls over "
          f"{off['stats']['batches']} batches")
    batches = [b for b in _train_data(mx, TRAIN_STEPS, TRAIN_BATCH)]
    res["bucketed"] = _pipeline_bucketed(torch, mx, mod, batches)
    part("bucketed")
    trained = mod.get_params()
    res["layout"] = _pipeline_layout(
        torch, mx, trained, batches,
        sorted(training["launches_per_step_by_digest"]))
    part("layout")
    res["tuner"] = _pipeline_tuner(torch, mx, mod, training, batches[0])
    part("tuner")
    for arm in (on, off):
        arm.pop("labels")
    res.update({"prefetch_on": on, "prefetch_off": off})
    res["summary"] = {
        "step_ms_p50": on["step_ms_p50"], "step_ms_p95": on["step_ms_p95"],
        "step_ms_p50_prefetch_off": off["step_ms_p50"],
        "step_ms_p95_prefetch_off": off["step_ms_p95"],
        "phase6_fit_step_ms_p50": training["step_ms_p50"],
        "phase17_replay_step_ms_p50": fused["step_ms_p50"],
        "input_pipeline_stats": on["stats"],
        "input_pipeline_stats_prefetch_off": off["stats"],
        "pinned_ring": on["ring"],
        "captures": on["captures"],
        "launches_per_step": on["launches_per_step"],
        "bucketed_replay_step_ms_p50": res["bucketed"]["replay_ms_p50"],
        "bucketed_vs_per_param_worst": res["bucketed"]["vs_per_param_worst"],
        "layout_rewrites": res["layout"]["layout_rewrites"],
        "layout_step_ms_p50": {k: res["layout"][k]["step_ms_p50"]
                               for k in ("NCHW", "layout")},
        "layout_first_step_worst": res["layout"]["first_step_worst"],
        "tuner_choice": {k: res["tuner"]["with_forward_record"][k]
                         for k in ("layout", "multistep_k", "source")},
        "calibrated_slower_at_phase6_bind":
            res["tuner"]["calibrated_slower_at_phase6_bind"],
        "calibration_s_at_phase6_bind":
            res["tuner"]["calibration_s_at_phase6_bind"],
        "over_favour_plain_store": res["layout"]["over_favour_plain_store"],
        "parts_s": res["parts_s"]}
    log(f"pipeline: fit over RecordIO through DevicePrefetchIter: step "
        f"p50 {on['step_ms_p50']!r} ms p95 {on['step_ms_p95']!r} ms "
        f"(prefetch off: p50 {off['step_ms_p50']!r} ms) beside phase 6's "
        f"fit p50 {training['step_ms_p50']!r} ms and phase 17's replay p50 "
        f"{fused['step_ms_p50']!r} ms; inputPipelineStats "
        f"{json.dumps(on['stats'])}; prefetch off "
        f"{json.dumps(off['stats'])}")
    log("phase 18 ok: Inception-ResNet-v2 trains from a RecordIO file "
        "through DevicePrefetchIter into the captured step")
    return res


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


def _tower_bf16(torch, mx, mod, batch, y, profile):
    """TOWER_STEPS Adam steps of the phase's Module under
    cast_compute(bfloat16): the first step's loss against the float32
    forward's on the same batch and weights, float32 master weights, a
    finite loss; with --profile, the step's top kernels (its GEMMs by
    name)."""
    exe = mod._exec_group.execs[0]

    def mse(out):
        return float(((out.data.float() - y.data) ** 2).mean())

    mod.forward(batch, is_train=False)
    loss32 = mse(mod.get_outputs()[0])
    mod.cast_compute(torch.bfloat16)
    args, _ = mod.get_params()
    w0 = {n: a.data.clone() for n, a in args.items()}
    metric = mx.metric.create("mse")
    step_ms, first = [], None
    torch.cuda.synchronize()
    for step in range(TOWER_STEPS):
        t = time.perf_counter()
        mod.forward_backward(batch)
        if step == 0:
            out = mod.get_outputs()[0]
            check(out.data.dtype == torch.bfloat16,
                  f"the bf16 step's output is {out.data.dtype}")
            first = mse(out)
        mod.update()
        mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    rel = abs(first - loss32) / loss32
    check(rel <= TOWER_BF16_RTOL,
          f"bf16 first-step loss {first!r} against float32's {loss32!r}: "
          f"{rel!r} > {TOWER_BF16_RTOL}")
    masters = {n: str(exe.arg_dict[n].data.dtype) for n in w0}
    check(set(masters.values()) == {"torch.float32"},
          f"master weights not float32: {masters}")
    args, _ = mod.get_params()
    check(all((args[n].data - w).abs().max().item() > 0
              for n, w in w0.items()), "a weight did not move in bf16")
    m = metric.get()[1]
    check(np.isfinite(m), f"non-finite bf16 MSE {m!r}")
    steady = step_ms[1:]
    res = {"step_ms": step_ms,
           "step_ms_p50": float(np.percentile(steady, 50)),
           "step_ms_p95": float(np.percentile(steady, 95)),
           "tokens_per_s": TOWER_BATCH * TOWER_SEQ * len(steady)
           / (sum(steady) / 1e3),
           "float32_loss": loss32, "first_loss": first, "loss_rel": rel,
           "mse": m}
    if profile:
        prof = _profile_step(torch, mod, batch)
        res["profile"] = prof
        log("transformer: the bf16 step's matrix-product kernels (cuBLAS "
            "names its kernels by their operand types): " + json.dumps(
                [r["name"] for r in prof["top"] if any(
                    k in r["name"].lower() for k in ("gemm", "nvjet"))]))
    return res


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
        if step == 0:
            with _retained_grads():
                mod.forward_backward(batch)
                mod.update()
            first = _step_outputs_grads(mod, w0)
        else:
            mod.forward_backward(batch)
            mod.update()
        mod.update_metric(metric, batch.label)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    res["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    fs = mod._fused_step
    check(fs is not None and fs.graphed and fs.captures == 1,
          f"the tower did not train through one captured graph "
          f"({fs and fs.uncaptured_op})")
    res["graphed"] = _graphed(mod)
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
    res["bf16"] = _tower_bf16(torch, mx, mod, batch, y, profile)
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
    b16 = res["bf16"]
    log(f"transformer: bf16 (cast_compute) {TOWER_STEPS} steps: steady "
        f"p50 {b16['step_ms_p50']!r} ms p95 {b16['step_ms_p95']!r} ms, "
        f"{b16['tokens_per_s']!r} tokens/s, "
        f"{3 * fwd / (b16['step_ms_p50'] / 1e3) / 1e12!r} TFLOP/s, first "
        f"step's loss {b16['first_loss']!r} against float32's "
        f"{b16['float32_loss']!r} on the same batch and weights (relative "
        f"{b16['loss_rel']!r}, limit {TOWER_BF16_RTOL}), MSE {b16['mse']!r};"
        f" float32 p50 {p50!r} ms, {res['tokens_per_s']!r} tokens/s")
    b16["tflops_per_s"] = 3 * fwd / (b16["step_ms_p50"] / 1e3) / 1e12
    log("phase 9 ok: the transformer trains through Module, in float32 "
        "and under cast_compute(bfloat16)")
    return res


# ------------------------------------------------------------ phase 10
def _rtc_nets(mx):
    """Inception-ResNet-v2 with its SoftmaxOutput head (phase 6's net)
    and the same net with the head replaced by the rtc_softmax_ce Custom
    op on the last FullyConnected's output."""
    from mxnet_tpu_torch import rtc_ops  # noqa: F401  (registers the op)
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    ref = get_inception_resnet_v2(num_classes=1000, repeats=RTC_REPEATS)
    fc = ref.get_internals()["fc1_output"]
    net = mx.sym.Custom(data=fc, label=mx.sym.Variable("softmax_label"),
                        op_type="rtc_softmax_ce", name="softmax")
    return ref, net


def _rtc_host_inputs(mx):
    """Phase 10's images and labels (seed 10) and its net's Xavier()
    parameters from mx.random.seed(0), on the host."""
    rs = np.random.RandomState(10)
    n_img = RTC_BATCHES * TRAIN_BATCH
    x = rs.uniform(-1, 1, (n_img, 3, RTC_IMAGE, RTC_IMAGE)).astype(
        np.float32)
    y = rs.randint(0, 1000, (n_img,)).astype(np.float32)
    return (x, y) + _host_params(mx, _rtc_nets(mx)[1], TRAIN_BATCH)


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


def _parts(res):
    """A function that stores, under res["parts_s"][name], the seconds
    since its previous call (or since it was made)."""
    res["parts_s"] = {}
    last = [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        res["parts_s"][name] = now - last[0]
        last[0] = now

    return part


def phase_rtc(torch, mx):
    """User device code: Inception-ResNet-v2 with the rtc_softmax_ce head
    trained, checkpointed and reloaded through FeedForward on the card."""
    from mxnet_tpu_torch import rtc, rtc_ops

    res = {}
    part = _parts(res)
    ref_net, net = _rtc_nets(mx)
    n_img = RTC_BATCHES * TRAIN_BATCH
    x, y, args0, auxs0 = _host_inputs("rtc", lambda: _rtc_host_inputs(mx))
    res["params"] = int(sum(a.size for a in args0.values()))

    part("host_inputs")
    binds, step_ends, first = [], [], {}
    orig_bind = mx.mod.Module.bind

    def timed_bind(self, *a, **kw):
        t = time.perf_counter()
        out = orig_bind(self, *a, **kw)
        binds.append((time.perf_counter() - t, time.perf_counter()))
        return out

    def on_batch(param):
        if param.nbatch == 0:
            mod = param.locals["self"]
            first["batch"] = param.locals["batch"]
            first["outs"], first["grads"] = _step_outputs_grads(mod, args0)
            fs = mod._fused_step
            first["uncaptured_op"] = fs and fs.uncaptured_op
            first["graphed"] = _graphed(mod)
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
        with _retained_grads():
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
    # the Custom head runs user Python: the fused step runs uncaptured
    # and says so
    check(first["uncaptured_op"] == "Custom",
          f"the rtc head's fused step: uncaptured op "
          f"{first['uncaptured_op']!r}, not 'Custom'")
    res["graphed"] = first["graphed"]
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

    part("fit")
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

    part("vs_softmax_output")
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
    part("predict_save_load")

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

    part("kernels")
    # (6) the numpy CustomOp example at its own size
    res["custom_softmax_example"] = _custom_softmax_example(torch, mx)
    part("custom_softmax_example")
    log(f"rtc: parts {json.dumps(res['parts_s'])} s")
    log("phase 10 ok: user device code trains through FeedForward")
    return res


# ----------------------------------------------------------- phase 11
def _start_examples():
    """The examples this slice unblocks, in one child process on the card
    (tools/run_torch_example.py runs them one after another under the
    mxnet_tpu alias). Started first, beside the imports and phase 1's
    kernel builds, which are host work, and reaped before the first
    timed kernel, so it shares the host and the card with no timed part
    of the script."""
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
        groups = {}
        for g, _ in mod._exec_group.execs[0]._codegen_plan.fused.values():
            groups[g.template] = groups.get(g.template, 0) + 1
        check(all(fit_launches[t] == n_groups * steps
                  for t, n_groups in groups.items())
              and groups.get("scale_bias_act") == sum(HALF_DEPTH),
              f"fit's generated-kernel launches {fit_launches}, groups "
              f"{groups}")
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
            check((back._fused_step or back._updater).get_states()
                  == f.read(),
                  "the loaded optimizer states differ from the file's")
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
    res.update({"graphed": {"fit": _graphed(mod), "loaded": _graphed(back)},
                "fit_step_ms": step_ms,
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


def _weights_of(net, trained):
    """The (args, auxs) of `trained` that `net` takes: phase 6's weights
    of a shallower Inception-ResNet-v2's blocks."""
    args, auxs = trained
    names = set(net.list_arguments())
    aux_names = set(net.list_auxiliary_states())
    return ({n: a for n, a in args.items() if n in names},
            {n: a for n, a in auxs.items() if n in aux_names})


def phase_surface(torch, mx, trained, card, examples):
    """The public surface on the card: imperative nd + autograd and the
    Module lifecycle; `examples` holds the unblocked examples' results,
    run beside phase 1's builds (`_start_examples`)."""
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    timing = {}
    part = _parts(timing)
    net = get_inception_resnet_v2(num_classes=1000, dropout=0.0,
                                  repeats=HALF_DEPTH)
    args, auxs = _weights_of(net, trained)
    log(f"surface: Inception-ResNet-v2 at half depth {HALF_DEPTH} (phase "
        f"6's weights of those blocks), cut for the script's budget")
    rs = np.random.RandomState(11)
    x = rs.uniform(-1, 1, (SURFACE_IMAGES, 3, SURFACE_IMAGE,
                           SURFACE_IMAGE)).astype(np.float32)
    y = rs.permutation(SURFACE_IMAGES).astype(np.float32)
    part("host_inputs")
    imperative = _surface_imperative(torch, mx, net, args, auxs,
                                     x[:TRAIN_BATCH], y[:TRAIN_BATCH])
    torch.cuda.empty_cache()
    part("imperative")
    lifecycle = _surface_lifecycle(torch, mx, net, args, auxs, x,
                                   np.arange(SURFACE_IMAGES,
                                             dtype=np.float32))
    torch.cuda.empty_cache()
    part("lifecycle")
    log(f"surface: parts {json.dumps(timing['parts_s'])} s")
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


# ----------------------------------------------------------- phase 16
ONE_SHOT_IMAGES = 64
ONE_SHOT_IMAGE = 299
ONE_SHOT_BURST = 48           # sent at once: full batches of 8
ONE_SHOT_CLIENTS = 4
ONE_SHOT_SEED = 16
ONE_SHOT_MAX_BATCH = 8        # docs/serving.md's defaults
ONE_SHOT_MAX_WAIT_US = 2000
ONE_SHOT_TRICKLE_GAP_S = 0.004   # past max_wait: each one flushes alone
ONE_SHOT_RTOL = 1e-4          # of the output's max (cuDNN's algorithm
                              # differs with the batch size)
ONE_SHOT_DECODE_PROMPTS = (0, 2, 1, 3)   # phase 3's 32/64/288/320 tokens
ONE_SHOT_PAGE_BUCKETS = (8, 32)
ONE_SHOT_DECODE_NEW = 64                 # phase 3's max_new
ONE_SHOT_DEVICE = "cuda"


def _scrape(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read().decode()


def _one_shot_traffic(server, images):
    """ONE_SHOT_BURST images at once from ONE_SHOT_CLIENTS threads, then
    the rest one at a time (each after the last one's reply and a gap
    past max_wait), the threads taking turns; per-image outputs and the
    two windows' seconds."""
    n, outs, errors = len(images), [None] * len(images), []
    turn = threading.Lock()
    burst_done = threading.Barrier(ONE_SHOT_CLIENTS + 1)
    windows = {}

    def client(k):
        try:
            mine = range(k, ONE_SHOT_BURST, ONE_SHOT_CLIENTS)
            futs = [(i, server.submit("irv2", {"data": images[i]}))
                    for i in mine]
            for i, f in futs:
                outs[i] = f.result(timeout=600)[0]
        except Exception as e:  # reported below, fails the phase
            errors.append(f"burst client {k}: {type(e).__name__}: {e}")
        burst_done.wait()
        for i in range(ONE_SHOT_BURST + k, n, ONE_SHOT_CLIENTS):
            with turn:
                try:
                    outs[i] = server.predict("irv2", {"data": images[i]},
                                             timeout=600)[0]
                except Exception as e:
                    errors.append(f"request {i}: {type(e).__name__}: {e}")
                time.sleep(ONE_SHOT_TRICKLE_GAP_S)

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(ONE_SHOT_CLIENTS)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    burst_done.wait()
    windows["burst_s"] = time.perf_counter() - t0
    for th in threads:
        th.join(900)
    windows["all_s"] = time.perf_counter() - t0
    check(not errors, "; ".join(errors))
    check(all(o is not None for o in outs), "a request did not complete")
    return outs, windows


def _kernel_slices(trace):
    """(kernel events at pid >= 1000, their summed device us)."""
    ks = [e for e in trace["traceEvents"]
          if isinstance(e.get("pid"), int) and e["pid"] >= 1000
          and e.get("ph") == "X" and e.get("cat") == "kernel"]
    return ks, sum(e.get("dur", 0.0) for e in ks)


def _one_shot_profile(torch, mx, server, images, tmp):
    """One full batch served under profiler_set_state('run') with
    MXNET_TPU_XLA_TRACE_DIR: the dump's executor events, its CUDA kernel
    slices (a B2 kernel among them), its stat views, and the window's
    busy share (kernel time over the run -> stop wall)."""
    fn = os.path.join(tmp, "profile.json")
    os.environ["MXNET_TPU_XLA_TRACE_DIR"] = os.path.join(tmp, "capture")
    try:
        mx.profiler.profiler_set_config(mode="symbolic", filename=fn)
        mx.profiler.profiler_set_state("run")
        t0 = time.perf_counter()
        futs = [server.submit("irv2", {"data": images[i]})
                for i in range(ONE_SHOT_MAX_BATCH)]
        for f in futs:
            f.result(timeout=600)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        mx.profiler.profiler_set_state("stop")
    finally:
        del os.environ["MXNET_TPU_XLA_TRACE_DIR"]
    with open(fn) as f:
        trace = json.load(f)
    host = [e for e in trace["traceEvents"] if e.get("cat") == "executor"]
    kernels, device_us = _kernel_slices(trace)
    b2 = [e for e in kernels if "fused_scale_bias_act" in e["name"]]
    check(host, "the profile dump holds no executor event")
    check(b2, f"no B2 kernel slice at pid >= 1000 in the dump "
          f"({len(kernels)} kernel slices)")
    for key in ("servingStats", "execCacheStats"):
        check(key in trace, f"the profile dump lacks {key}")
    return {"executor_events": len(host), "kernel_slices": len(kernels),
            "b2_slices": len(b2), "device_us": device_us,
            "wall_us": wall_us, "busy_share": device_us / wall_us,
            "keys": [k for k in trace if k != "traceEvents"]}


def _one_shot_decode(torch, mx, server, decoder, cfg, serving3):
    """(c) phase 3's decoder, on the card where it is, behind the same
    server: 4 of phase 3's prompts through submit_decode, stream and
    generate against phase 3's cache-off streams (near ties counted),
    B4 n_layers times a decode step, unload stopping the scheduler."""
    from mxnet_tpu_torch.decoding import attention

    t0 = time.perf_counter()
    model = server.load_decoder(
        "lm", decoder, cfg, max_batch=2, num_pages=1024,
        kv_dtype="float32", prefix_cache=False,
        page_buckets=ONE_SHOT_PAGE_BUCKETS, device=ONE_SHOT_DEVICE)
    warm_s = time.perf_counter() - t0
    prompts = [serving3["prompts"][i] for i in ONE_SHOT_DECODE_PROMPTS]
    want = [serving3["cold"][i] for i in ONE_SHOT_DECODE_PROMPTS]
    max_new = ONE_SHOT_DECODE_NEW
    attention.reset_launch_counts()
    t0 = time.perf_counter()
    futs = [server.submit_decode("lm", p, max_new_tokens=max_new)
            for p in prompts[:2]]
    streamed = list(server.stream("lm", prompts[2], max_new_tokens=max_new,
                                  timeout=600))
    generated = server.generate("lm", prompts[3], max_new_tokens=max_new,
                                timeout=600)
    got = [f.result(600) for f in futs] + [streamed, generated]
    wall = time.perf_counter() - t0
    launches = attention.launch_counts()["paged_attention_float"]
    snap = model.stats.snapshot()
    check(launches == cfg.n_layers * snap["steps"] and launches > 0,
          f"B4 launched {launches} times in {snap['steps']} decode steps "
          f"of {cfg.n_layers} layers")
    check(snap["traces_since_warmup"] == 0,
          f"the decoder left its warmed grid: {snap['traces_since_warmup']}")
    ties = _divergences(model.engine, prompts, got, want, None,
                        "one-shot server's decoder vs phase 3 cache-off")
    thread = model.scheduler._thread
    check(thread is not None and thread.is_alive(),
          "the decoder's scheduler is not running")
    server.unload("lm")
    check(not thread.is_alive(), "unload left the scheduler running")
    return {"warmup_s": warm_s, "wall_s": wall,
            "tokens": sum(map(len, got)), "steps": snap["steps"],
            "b4_launches": launches, "near_ties": ties,
            "captures": model.engine.traces()}


def phase_one_shot(torch, mx, trained, decoder, cfg, serving3, card,
                   bundles=None):
    """Phase 16 (module docstring): one-shot serving of
    Inception-ResNet-v2 with phase 6's weights, the telemetry exporter
    and profile dump, and phase 3's decoder behind the same server.
    `bundles(model, images, parts)` (phase 22) runs while the served
    model is still warm, before the server stops."""
    import shutil

    from mxnet_tpu_torch import exec_cache, passes
    from mxnet_tpu_torch import telemetry as tel
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    timing = {}
    part = _parts(timing)
    res = {}
    gpu = mx.gpu(0)
    tmp = tempfile.mkdtemp(prefix="one_shot_")
    os.environ["MXNET_TELEMETRY_PORT"] = "0"
    try:
        prefix = os.path.join(tmp, "irv2")
        net = get_inception_resnet_v2(num_classes=1000, repeats=HALF_DEPTH)
        args, auxs = _weights_of(net, trained)
        log(f"one_shot: Inception-ResNet-v2 at half depth {HALF_DEPTH} "
            f"(phase 6's weights of those blocks), cut for the script's "
            f"budget")
        mx.model.save_checkpoint(prefix, 1, net, args, auxs)
        images = (np.random.default_rng(ONE_SHOT_SEED).random(
            (ONE_SHOT_IMAGES, 3, ONE_SHOT_IMAGE, ONE_SHOT_IMAGE),
            dtype=np.float32) * 2 - 1)
        part("checkpoint_and_images")

        # (a) load: buckets 1, 2, 4, 8, every cell warmed before ready
        server = mx.serving.ModelServer(max_batch=ONE_SHOT_MAX_BATCH,
                                        max_wait_us=ONE_SHOT_MAX_WAIT_US)
        port = tel.exporter_port()
        check(port, "MXNET_TELEMETRY_PORT=0 started no exporter")
        model = server.load_checkpoint(
            "irv2", prefix, 1,
            input_specs={"data": (3, ONE_SHOT_IMAGE, ONE_SHOT_IMAGE)},
            ctx=gpu)
        part("load_and_warmup")
        cells = sorted(model._by_bucket)
        check(cells == [(1, 0), (2, 0), (4, 0), (8, 0)],
              f"batch buckets {cells}")
        base = model._base._exec
        names = [n for n in base.arg_dict
                 if n not in ("data", "softmax_label")]
        shared = all(
            model._by_bucket[c]._exec.arg_dict[n]._data.data_ptr()
            == base.arg_dict[n]._data.data_ptr()
            for c in cells for n in names) and all(
            model._by_bucket[c]._exec.aux_dict[n]._data.data_ptr()
            == base.aux_dict[n]._data.data_ptr()
            for c in cells for n in base.aux_dict)
        check(shared, "a cell's parameters are not the base cell's storage")
        per_batch = {}
        for c in cells:
            plan = model._by_bucket[c]._exec._codegen_plan
            groups = {}
            for group, _ in plan.fused.values():
                groups[group.template] = groups.get(group.template, 0) + 1
            check(len(plan.fused) == len(plan.cache_component),
                  f"cell {c}: a fusion group fell back "
                  f"{plan.cache_component}")
            per_batch[c] = groups
        check(len({tuple(sorted(g.items())) for g in per_batch.values()})
              == 1, f"the cells lower different groups {per_batch}")
        per_batch = per_batch[cells[0]]
        warm = exec_cache.cache_stats()

        passes.reset_launch_counts()
        outs, windows = _one_shot_traffic(server, images)
        launches = passes.launch_counts()
        snap = model.stats.snapshot()
        part("traffic")
        check(snap["completed"] == ONE_SHOT_IMAGES and snap["failed"] == 0
              and snap["expired"] == 0, f"serving stats {snap}")
        check(snap["traces_since_warmup"] == 0,
              f"traces_since_warmup {snap['traces_since_warmup']}")
        for t, n in per_batch.items():
            check(launches.get(t, 0) == n * snap["batches"],
                  f"{t} launches {launches} != {n} groups x "
                  f"{snap['batches']} served batches")

        # the single-request Predictor: reference rows and the looped
        # batch-1 baseline (a cache hit on the batch-1 cell's plan)
        ref = mx.Predictor.from_checkpoint(
            prefix, 1, {"data": (1, 3, ONE_SHOT_IMAGE, ONE_SHOT_IMAGE)},
            ctx=gpu)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = []
        for i in range(ONE_SHOT_IMAGES):
            ref.set_input("data", images[i:i + 1])
            ref.forward()
            rows.append(ref.get_output(0)[0])
        single_s = time.perf_counter() - t0
        part("single_request_predictor")
        worst = max(float(np.abs(o - r).max() / max(np.abs(r).max(),
                                                    1e-30))
                    for o, r in zip(outs, rows))
        check(worst <= ONE_SHOT_RTOL,
              f"a served row differs from the single-request Predictor's "
              f"by {worst!r} of its max (> {ONE_SHOT_RTOL})")
        after = exec_cache.cache_stats()
        check(after["misses"] == warm["misses"]
              and after["traces"] == warm["traces"],
              f"exec cache after warmup {warm} -> {after}")

        # (b) telemetry: one scrape, then one profiled batch
        metrics = _scrape(port, "/metrics")
        statusz = json.loads(_scrape(port, "/statusz"))
        count_line = ('mxnet_tpu_serving_request_latency_ms_count'
                      '{model="irv2:1"} ')
        counts = [ln for ln in metrics.splitlines()
                  if ln.startswith(count_line)]
        check(counts == [count_line + str(ONE_SHOT_IMAGES)],
              f"latency histogram count {counts}")
        completed = statusz["servingStats"]["irv2:1"]["completed"]
        check(completed == ONE_SHOT_IMAGES,
              f"/statusz servingStats completed {completed}")
        check(_scrape(port, "/healthz") == "ok\n", "/healthz")
        part("scrape")
        prof = _one_shot_profile(torch, mx, server, images, tmp)
        part("profile")

        # (c) the decoder behind the same server
        decode = _one_shot_decode(torch, mx, server, decoder, cfg, serving3)
        part("decode")
        if bundles is not None:
            res["bundles"] = bundles(model, images, dict(timing["parts_s"]))
        server.stop()
        tel.stop_exporter()
    finally:
        os.environ.pop("MXNET_TELEMETRY_PORT", None)
        shutil.rmtree(tmp, ignore_errors=True)
    lat = snap
    res.update({
        "requests": ONE_SHOT_IMAGES,
        "requests_per_s": ONE_SHOT_IMAGES / windows["all_s"],
        "burst_requests_per_s": ONE_SHOT_BURST / windows["burst_s"],
        "p50_ms": lat["p50_ms"], "p95_ms": lat["p95_ms"],
        "p99_ms": lat["p99_ms"], "batches": lat["batches"],
        "batch_fill": lat["batch_fill"],
        "padding_waste": lat["padding_waste"],
        "single_images_per_s": ONE_SHOT_IMAGES / single_s,
        "burst_vs_single": (ONE_SHOT_BURST / windows["burst_s"])
        / (ONE_SHOT_IMAGES / single_s),
        "served_vs_predictor_worst": worst,
        "launches": launches, "groups_per_batch": per_batch,
        "exec_cache_after_warmup": {k: after[k] - warm[k] for k in (
            "hits", "misses", "traces")},
        "warm_cells": len(cells), "profile": prof, "decode": decode,
        "phase_parts_s": timing["parts_s"], "card": card})
    res["summary"] = ({k: res[k] for k in (
        "requests_per_s", "burst_requests_per_s", "p50_ms", "p95_ms",
        "p99_ms", "batches", "batch_fill", "padding_waste",
        "single_images_per_s", "burst_vs_single",
        "served_vs_predictor_worst", "groups_per_batch")}
        | {"busy_share": prof["busy_share"],
           "profile_kernel_slices": prof["kernel_slices"],
           "decode_tokens": decode["tokens"],
           "decode_steps": decode["steps"],
           "decode_b4_launches": decode["b4_launches"],
           "decode_near_ties": len(decode["near_ties"]),
           "decode_warmup_s": decode["warmup_s"],
           "parts_s": timing["parts_s"], "card": card})
    log("phase 16 ok: one-shot serving of Inception-ResNet-v2 at full "
        "width, the exporter and the profile dump, and the decoder behind "
        "the same server")
    return res


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
        "perplexity": ppl, "b1_b2_launches": launches,
        "graphed": _graphed(mod)})
    log(f"lm: {LM_STEPS} steps at dropout {LM_DROPOUT}: bind "
        f"{res['bind_s']!r} s, {res['fusion_groups']} fusion groups, B1/B2 "
        f"launches {launches}; first step {step_ms[0]!r} ms, steady p50 "
        f"{res['step_ms_p50']!r} ms p95 {res['step_ms_p95']!r} ms, "
        f"{res['tokens_per_s']!r} tokens/s, peak memory "
        f"{res['peak_mem_bytes']} B above the process's before the bind; "
        f"perplexity step 1 {ppl[0]!r}, step "
        f"{LM_STEPS} {ppl[-1]!r}")
    trained, _ = mod.get_params()
    del mod
    torch.cuda.empty_cache()
    log("phase 12 ok: the PTB-large LSTM language model trains through "
        "Module on cuDNN's RNN")
    return res, trained

# ----------------------------------------------------------- phase 15
def _bucket_corpus(cycle):
    """BUCKET_BATCHES x LM_BATCH sentences a bucket (and a few more, short
    of another batch), each a walk along phase 12's token `cycle` from a
    seeded place, its length drawn within the bucket's range, as
    words."""
    rs = np.random.RandomState(BUCKET_SEED)
    out, lo = [], 3
    for top in BUCKETS:
        for _ in range(BUCKET_BATCHES * LM_BATCH + LM_BATCH // 4):
            n = rs.randint(lo, top + 1)
            start = rs.randint(len(cycle))
            out.append([f"w{cycle[(start + i) % len(cycle)]}"
                        for i in range(n)])
        lo = top + 1
    order = rs.permutation(len(out))
    return [out[i] for i in order]


def _bucketing_fused(torch, mx, shapes, default_key, firsts, widths,
                     trained, eager):
    """Phase 15's fused arm: the eager arm's batches, pass by pass, with
    MXNET_TPU_BUCKET_FUSED=1 (a captured step a bucket over one storage),
    and at dropout 0 buckets 60 and 10 fused against eager."""
    from mxnet_tpu_torch.models import lstm_lm_sym_gen

    res = {}
    os.environ["MXNET_TPU_BUCKET_FUSED"] = "1"
    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        mod = mx.mod.BucketingModule(
            lstm_lm_sym_gen(**widths, dropout=LM_DROPOUT),
            default_bucket_key=default_key, context=mx.gpu(0))
        mod.bind(*shapes)
        mod.set_params(trained, {})
        mod.init_optimizer(optimizer="sgd", optimizer_params=BUCKET_OPT)
        step_ms = {k: [] for k in BUCKETS}
        captures, adopted = [], []
        for batches in eager["passes"]:
            for batch in batches:
                key = batch.bucket_key
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mod.forward_backward(batch)
                mod.update()
                torch.cuda.synchronize()
                step_ms[key].append((time.perf_counter() - t0) * 1e3)
            captures.append({k: m._fused_step.captures
                             for k, m in mod._buckets.items()})
            adopted.append(sum(m._fused_step.adopted_bytes
                               for m in mod._buckets.values()))
        peak = torch.cuda.max_memory_allocated() - base
        steps = {k: m._fused_step for k, m in mod._buckets.items()}
        owner = mod._buckets[mod._state_owner]._fused_step

        def ptrs(fs):
            return ([fs.params[n].data_ptr() for n in sorted(fs.params)]
                    + [fs.states[n].data_ptr() for n in sorted(fs.states)
                       if fs.states[n] is not None])

        shared = all(ptrs(fs) == ptrs(owner) for fs in steps.values())
        res.update({
            "captures_by_pass": captures,
            "adopted_param_bytes_by_pass": adopted,
            "one_storage": shared, "owner_t": owner._t,
            "graphed": {k: _graphed(m) for k, m in mod._buckets.items()},
            "peak_mem_bytes": peak,
            "pool_bytes": {k: fs.pool_bytes for k, fs in steps.items()},
            "eager_peak_bound_bytes": eager["peak_bound_bytes"],
            "step_ms_p50": {k: float(np.percentile(v[-BUCKET_BATCHES:], 50))
                            for k, v in step_ms.items()},
            "eager_step_ms_p50": {
                k: float(np.percentile(v[-BUCKET_BATCHES:], 50))
                for k, v in eager["step_ms"].items()}})
        del mod, steps, owner
        torch.cuda.empty_cache()

        # dropout 0: buckets 60 and 10, the same steps, fused and eager
        params = {}
        for flag in ("0", "1"):
            os.environ["MXNET_TPU_BUCKET_FUSED"] = flag
            m = mx.mod.BucketingModule(
                lstm_lm_sym_gen(**widths, dropout=0.0),
                default_bucket_key=default_key, context=mx.gpu(0))
            m.bind(*shapes)
            m.set_params(trained, {})
            m.init_optimizer(optimizer="sgd", optimizer_params=BUCKET_OPT)
            for key in (max(BUCKETS), min(BUCKETS)) * 2:
                m.forward_backward(firsts[key])
                m.update()
            params[flag] = {n: a.data.clone()
                            for n, a in m.get_params()[0].items()}
            del m
            torch.cuda.empty_cache()
    finally:
        del os.environ["MXNET_TPU_BUCKET_FUSED"]
    worst = _rel_worst(torch, params["1"], params["0"])
    name = max(worst, key=worst.get)
    res["dropout0_fused_vs_eager_worst"] = {"tensor": name,
                                            "rel": worst[name]}
    n = len(BUCKETS)
    check(captures[0] == {k: 1 for k in BUCKETS}
          and captures[1] == captures[0],
          f"captures a bucket by pass {captures}")
    check(adopted[1] == adopted[0],
          f"hand-overs re-pointed parameters: {adopted}")
    check(shared, "the buckets' steps are not on one parameter and state "
          "storage")
    check(res["owner_t"] == 2 * n * BUCKET_BATCHES,
          f"the owner's step count {res['owner_t']}")
    check(all(g == "graphed" for g in res["graphed"].values()),
          f"fused buckets {res['graphed']}")
    check(worst[name] <= LM_PARITY_RTOL,
          f"dropout 0, buckets 60 and 10 fused against eager: {name} "
          f"differs by {worst[name]!r} of its max (> {LM_PARITY_RTOL})")
    log(f"bucketing: fused arm (MXNET_TPU_BUCKET_FUSED=1): "
        f"{json.dumps(res)}")
    return res


def phase_bucketing(torch, mx, trained, lm_p50):
    """Phase 15: the rnn package and BucketingModule at phase 12's width
    on the card."""
    from mxnet_tpu_torch import executor, passes
    from mxnet_tpu_torch.models import lstm_lm_sym_gen

    widths = {k: LM_CFG[k] for k in ("vocab_size", "num_embed",
                                      "num_hidden", "num_layers")}
    res = {"buckets": list(BUCKETS)}
    # the words' ids are phase 12's token ids (0, the padding label, is
    # not on the cycle), so phase 12's weights already know the walk
    cycle = np.random.RandomState(0).permutation(
        LM_CFG["vocab_size"])[:LM_CYCLE]
    coded, vocab = mx.rnn.encode_sentences(
        _bucket_corpus(cycle), vocab={f"w{i}": int(i) for i in cycle},
        invalid_label=0)
    check(0 not in cycle and len(vocab) == LM_CYCLE,
          f"{len(vocab)} words, 0 on the cycle: {0 in cycle}")
    mx.random.seed(BUCKET_SEED)
    it = mx.rnn.BucketSentenceIter(coded, LM_BATCH, buckets=list(BUCKETS),
                                   invalid_label=0)
    check(it.default_bucket_key == max(BUCKETS) and it.buckets == BUCKETS,
          f"iterator buckets {it.buckets}, default {it.default_bucket_key}")
    shapes = (it.provide_data, it.provide_label)
    firsts = {}
    for batch in it:
        firsts.setdefault(batch.bucket_key, batch)
    check(sorted(firsts) == BUCKETS, f"buckets seen {sorted(firsts)}")

    # (1) dropout 0: the first step of buckets 60 and 10 against the
    # plain composition at that length, from phase 12's weights
    par = mx.mod.BucketingModule(lstm_lm_sym_gen(**widths, dropout=0.0),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0))
    par.bind(*shapes)
    par.set_params(trained, {})
    res["parity_worst"] = {}
    for key in (max(BUCKETS), min(BUCKETS)):
        batch = firsts[key]
        par.forward_backward(batch)
        exe = par._buckets[key]._exec_group.execs[0]
        args = {n: a for n, a in exe.arg_dict.items()
                if n not in ("data", "softmax_label")}
        ref_out, ref_grads = _lm_reference(
            torch, args, batch.data[0].data.to(LM_DEVICE),
            batch.label[0].data.to(LM_DEVICE))
        worst = {"output": _lm_rel(exe.outputs[0].data, ref_out)}
        worst.update({n: _lm_rel(exe.grad_dict[n].data, g)
                      for n, g in ref_grads.items()})
        bad = {n: r for n, r in worst.items() if not r <= LM_PARITY_RTOL}
        check(not bad, f"bucket {key}'s first step against the plain "
              f"composition: {bad} beyond {LM_PARITY_RTOL} of each "
              f"tensor's max")
        res["parity_worst"][key] = max(worst.values())
        del ref_out, ref_grads, args, exe
    log(f"bucketing: dropout 0, the first step of buckets 60 and 10 "
        f"against the plain composition (worst share of each tensor's "
        f"max): {json.dumps(res['parity_worst'])}")
    del par
    torch.cuda.empty_cache()

    # (2) two passes over every bucket at dropout 0.65
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    peak, act = 0, None
    mod = mx.mod.BucketingModule(
        lstm_lm_sym_gen(**widths, dropout=LM_DROPOUT),
        default_bucket_key=it.default_bucket_key, context=mx.gpu(0))
    cold = {}
    t0 = time.perf_counter()
    mod.bind(*shapes)
    cold[it.default_bucket_key] = time.perf_counter() - t0
    mod.set_params(trained, {})
    mod.init_optimizer(optimizer="sgd", optimizer_params=BUCKET_OPT)
    root = mod._cur._exec_group.execs[0]
    names = [n for n in root.arg_dict if n not in ("data", "softmax_label")]
    held = sum(root.arg_dict[n].data.nbytes + root.grad_dict[n].data.nbytes
               for n in names)
    metric = mx.metric.Perplexity(0)
    step_ms = {k: [] for k in BUCKETS}
    ppl, counters = [], []
    step_ppl, schedule = [], []
    for p in range(BUCKET_PASSES):
        it.reset()
        metric.reset()
        schedule.append([])
        for batch in it:
            key = batch.bucket_key
            schedule[-1].append(batch)
            if key not in mod._buckets:
                t0 = time.perf_counter()
                mod.prepare(batch)
                cold[key] = time.perf_counter() - t0
            measure = act is None and key == it.default_bucket_key
            torch.cuda.synchronize()
            if measure:
                peak = max(peak, torch.cuda.max_memory_allocated())
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            mod.forward_backward(batch)
            mod.update()
            torch.cuda.synchronize()
            step_ms[key].append((time.perf_counter() - t0) * 1e3)
            if measure:
                act = torch.cuda.max_memory_allocated() - before
            one = mx.metric.Perplexity(0)
            for m in (metric, one):
                mod.update_metric(m, batch.label)
            step_ppl.append((key, float(one.get()[1])))
        ppl.append(float(metric.get()[1]))
        counters.append((executor.stats(),
                         passes.fusion_stats()["kernels_built"],
                         mod.bucket_stats()["binds"]))
    peak = max(peak, torch.cuda.max_memory_allocated()) - base
    bound = held + 2 * act
    log(f"bucketing: perplexity a step (bucket, value): {step_ppl}")
    res.update({"steps": sum(map(len, step_ms.values())),
                "step_perplexity": step_ppl,
                "cold_bind_s": cold, "peak_mem_bytes": peak,
                "peak_bound_bytes": bound, "default_step_act_bytes": act,
                "params_grads_bytes": held, "perplexity_passes": ppl,
                "bucket_stats": mod.bucket_stats(),
                "executors": counters[-1][0],
                "graphed": {k: _graphed(m) for k, m in mod._buckets.items()}})
    check(res["steps"] >= 2 * len(BUCKETS)
          and all(len(v) == BUCKET_BATCHES * BUCKET_PASSES
                  for v in step_ms.values()),
          f"steps a bucket {[len(v) for v in step_ms.values()]}")
    for key, bucket in mod._buckets.items():
        exe = bucket._exec_group.execs[0]
        for n in ("lstm_parameters", "embed_weight", "pred_weight",
                  "pred_bias"):
            check(exe.arg_dict[n].data.data_ptr()
                  == root.arg_dict[n].data.data_ptr()
                  and exe.grad_dict[n].data.data_ptr()
                  == root.grad_dict[n].data.data_ptr(),
                  f"bucket {key}'s {n} is not the default bucket's storage")
    check(peak < bound, f"peak {peak} B above the bind's base, not under "
          f"the default bucket's parameters and gradients ({held} B) and "
          f"two steps' activations ({act} B each)")
    check(counters[1] == counters[0],
          f"the second pass bound or built: {counters}")
    check(all(np.isfinite(ppl)) and ppl[1] < ppl[0],
          f"perplexity by pass {ppl}")

    # (3) the RNN checkpoint holds the packed blob bit for bit
    cell = mx.rnn.FusedRNNCell(LM_CFG["num_hidden"],
                               num_layers=LM_CFG["num_layers"],
                               mode="lstm", dropout=LM_DROPOUT,
                               prefix="lstm_")
    args, auxs = mod.get_params()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        prefix = os.path.join(tmp, "lm")
        mx.rnn.save_rnn_checkpoint(cell, prefix, 1, mod.symbol, args, auxs)
        _, loaded, _ = mx.rnn.load_rnn_checkpoint(cell, prefix, 1)
    for n, a in args.items():
        check(torch.equal(loaded[n].data.cpu().view(torch.int32),
                          a.data.cpu().view(torch.int32)),
              f"{n} after save_rnn_checkpoint -> load_rnn_checkpoint")
    res["checkpoint_s"] = time.perf_counter() - t0

    per = {}
    for key, ms in step_ms.items():
        per[key] = {"step_ms_p50": float(np.percentile(ms, 50)),
                    "step_ms_p95": float(np.percentile(ms, 95)),
                    "tokens_per_s": LM_BATCH * key * len(ms)
                    / (sum(ms) / 1e3)}
    res["per_bucket"] = per
    res["step_ms"] = step_ms
    res["step_ms_p50_60_over_lm"] = (per[max(BUCKETS)]["step_ms_p50"]
                                     / lm_p50)
    log(f"bucketing: {res['steps']} steps over buckets {BUCKETS} "
        f"({BUCKET_PASSES} passes, {BUCKET_BATCHES} batches a bucket a "
        f"pass), cold binds {json.dumps(cold)} s, peak memory {peak} B "
        f"above the bind's base (bound {bound} B: parameters and "
        f"gradients {held} B + 2 x the default bucket's step {act} B), "
        f"perplexity by pass {ppl}, counters after each pass {counters}, "
        f"checkpoint save+load {res['checkpoint_s']!r} s; bucket 60's "
        f"p50 over phase 12's (35 steps): "
        f"{res['step_ms_p50_60_over_lm']!r} (60/35 = {60 / 35!r})")
    for key, r in per.items():
        log(f"bucketing: bucket {key:2d}: step p50 {r['step_ms_p50']!r} ms "
            f"p95 {r['step_ms_p95']!r} ms, {r['tokens_per_s']!r} tokens/s")
    del mod, root, args, loaded
    torch.cuda.empty_cache()
    res["fused"] = _bucketing_fused(
        torch, mx, shapes, it.default_bucket_key, firsts, widths, trained,
        {"passes": schedule, "step_ms": step_ms,
         "peak_bound_bytes": bound})
    log("phase 15 ok: BucketingModule trains the PTB-large LM over six "
        "buckets sharing one set of parameters, eagerly and with a "
        "captured step a bucket")
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
    res = {}
    part = _parts(res)

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
        "loc_loss_first_last": [loc[0], loc[-1]], "b1_launches": launches,
        "graphed": _graphed(mod)})
    cls_pred = mod.get_outputs()[0].data
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


# ----------------------------------------------------------- phase 19
DP_BATCH = 32                # each worker's rows: the global batch is 64
DP_STEPS = 4                 # cut from 10 with phase 20 (its budget)
DP_GROUP_STEPS = 4           # the executor group's steps in one process
DP_SEED = 19
# step 1 of the two workers against one process's step over the global
# batch, each tensor's difference over its movement: the batch's rows
# are reduced in another order (two sums of 32 and gloo's sum, against
# one of 64) and BatchNorm's statistics by another algorithm, whose
# float32 rounding the net amplifies (eps 2e-5): the worst tensor
# measured 5.4e-2 on the card. A slip of the semantics (each worker's
# own BatchNorm statistics) moved the worst tensor by 2.3 and the median
# by 7.0e-2 in the CPU rehearsal, against 1.8e-2 and 4e-7.
DP_STEP1_WORST = 0.1
DP_STEP1_MEDIAN = 1e-3
DP_WORKERS_TIMEOUT = 480     # phases 19 and 20 in one launch, after the go
# the workers start with the script and wait for phase 19's go
DP_GO_TIMEOUT = 1150
DP_DEVICE = "cuda"
DP_IMAGE = 299
DP_REPEATS = HALF_DEPTH      # cut from the net's own depth with phase 20


def _dp_b2(cfg):
    """B2 launches a step of phase 19's net: one a scale-and-activation
    residual block, sum(repeats) (39 at full depth, 20 at HALF_DEPTH)."""
    return sum(cfg["repeats"] or (10, 20, 9))


def _dp_config():
    """What the parent hands its two workers (config.json in their
    directory): the workers re-enter this script fresh. `mp` is phase
    20's part, which the same workers run after phase 19's."""
    return {"batch": DP_BATCH, "steps": DP_STEPS, "seed": DP_SEED,
            "device": DP_DEVICE, "image": DP_IMAGE, "repeats": DP_REPEATS,
            "mp": _mp_config(), "pe": _pe_config()}


def _dp_net(cfg):
    """Inception-ResNet-v2 at full width, dropout 0: two workers' dropout
    masks cannot be one process's, and step 1 is compared with one
    process's step."""
    from mxnet_tpu_torch.models import get_inception_resnet_v2

    kw = {"repeats": tuple(cfg["repeats"])} if cfg["repeats"] else {}
    return get_inception_resnet_v2(num_classes=1000, dropout=0.0, **kw)


def _dp_ctx(mx, cfg):
    return mx.gpu(0) if cfg["device"] == "cuda" else mx.cpu()


def _dp_sync(torch, cfg):
    if cfg["device"] == "cuda":
        torch.cuda.synchronize()


def _dp_rows(cfg, step, rank, batch=None):
    """Worker `rank`'s rows of step `step`'s global batch (seeded)."""
    batch = batch or cfg["batch"]
    rs = np.random.RandomState(cfg["seed"] * 1000 + 2 * step + rank)
    side = cfg["image"]
    x = rs.uniform(-1, 1, (batch, 3, side, side)).astype(np.float32)
    y = rs.randint(0, 1000, (batch,)).astype(np.float32)
    return x, y


def _digests(arrays):
    """{name: sha256 of the array's bytes} of {name: tensor}."""
    import hashlib

    return {n: hashlib.sha256(v.detach().cpu().numpy().tobytes())
            .hexdigest() for n, v in arrays.items()}


def _dp_group(torch, mx, cfg):
    """Module over [gpu(0), gpu(0)] with kvstore 'device': the executor
    group, each executor on 16 of the 32 rows, the store summing the two
    gradients and running the optimizer once."""
    from mxnet_tpu_torch import passes

    t_start = time.perf_counter()
    res = {}
    ctx = _dp_ctx(mx, cfg)
    mod = mx.mod.Module(_dp_net(cfg), context=[ctx, ctx])
    t0 = time.perf_counter()
    side = cfg["image"]
    mod.bind(data_shapes=[("data", (DP_BATCH, 3, side, side))],
             label_shapes=[("softmax_label", (DP_BATCH,))])
    res["bind_s"] = time.perf_counter() - t0
    mx.random.seed(DP_SEED)
    mod.init_params(initializer=mx.init.Xavier(**_INIT))
    mod.init_optimizer(kvstore="device", optimizer="sgd",
                       optimizer_params=_OPT)
    kv = mod._kvstore
    check(mod._fused_step is None and kv is not None
          and kv.type == "device" and mod._update_on_kvstore
          and len(mod._exec_group.execs) == 2,
          "Module([gpu(0), gpu(0)], kvstore='device') is not the executor "
          f"group with the store: fused {mod._fused_step is not None}, "
          f"store {kv and kv.type}, update_on_kvstore "
          f"{mod._update_on_kvstore}")
    e0, e1 = mod._exec_group.execs
    names = [n for n in mod._param_names
             if e0._grad_req.get(n, "null") != "null"]
    index = {i: n for i, n in enumerate(mod._param_names)}
    updater = kv._updater
    merged_bad = []

    def checked(key, merged, stored):
        n = index[key]
        if not torch.equal(merged.data,
                           e0.grad_dict[n].data + e1.grad_dict[n].data):
            merged_bad.append(n)
        updater(key, merged, stored)

    kv._set_updater(checked)
    passes.reset_launch_counts()
    _dp_sync(torch, cfg)
    step_s, diverged = [], []
    for step in range(DP_GROUP_STEPS):
        x, y = _dp_rows(cfg, step, 0)
        t0 = time.perf_counter()
        mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(x, ctx=ctx)], label=[mx.nd.array(y, ctx=ctx)]))
        mod.update()
        _dp_sync(torch, cfg)
        step_s.append(time.perf_counter() - t0)
        diverged += [(step, n) for n in names
                     if not torch.equal(e0.arg_dict[n].data,
                                        e1.arg_dict[n].data)]
    launches = passes.launch_counts()
    per = {k: v / (2 * DP_GROUP_STEPS) for k, v in launches.items() if v}
    check(not merged_bad, f"the store's merged gradient is not the sum of "
          f"the two executors' for {merged_bad[:5]}")
    check(not diverged, f"the executors' parameters differ after a step: "
          f"{diverged[:5]}")
    check(per.get("elementwise") == 1
          and per.get("scale_bias_act") == _dp_b2(cfg),
          f"B1/B2 launches per executor per step {per}, not 1 and "
          f"{_dp_b2(cfg)}")
    loss_ok = all(np.isfinite(o.asnumpy()).all() for o in mod.get_outputs())
    check(loss_ok, "non-finite outputs of the executor group")
    res.update({"steps": DP_GROUP_STEPS, "step_ms": [s * 1e3 for s in step_s],
                "launches_per_executor_step": per,
                "merged_equals_sum": True, "executors_equal": True,
                "keys": len(names),
                "phase_s": time.perf_counter() - t_start})
    del mod, e0, e1, kv, updater
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    return res


def _dp_worker(out):
    """One worker of phase 19 (tools/launch.py -n 2 re-enters this script
    with --dp-worker): (a) dist_sync push and pull of the model's gradient
    list, (b) Module.fit with kvstore='dist_sync' through the fused step's
    data plane, (c) what this process compiled. Writes out/worker-<rank>
    .json (and rank 0 its step-1 weights); prints nothing after."""
    rank_env = os.environ.get("MXNET_TPU_WORKER_ID", "0")
    for var in ("MXNET_CALIBRATION_CACHE", "MXNET_TUNING_CACHE"):
        if os.environ.get(var):
            os.environ[var] = f"{os.environ[var]}.{rank_env}"
    t_start = time.perf_counter()
    parts = {}
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import kernels, passes
    from mxnet_tpu_torch.parallel import collective

    parts["imports"] = time.perf_counter() - t_start
    # host work first, beside phase 1's builds (the script starts its
    # workers with it); the card and the group only after phase 19's go
    t = time.perf_counter()
    rank = int(rank_env)
    side, batch, steps = cfg["image"], cfg["batch"], cfg["steps"]
    x, y = zip(*[_dp_rows(cfg, s, rank) for s in range(steps)])
    data = mx.io.NDArrayIter(np.concatenate(x), np.concatenate(y),
                             batch_size=batch, shuffle=False,
                             label_name="softmax_label")
    del x, y
    net = _dp_net(cfg)
    # phase 20's weights and batches too, while the parent runs its steps
    mp_inputs = _mp_host_inputs(cfg["mp"])
    parts["data"] = time.perf_counter() - t
    t = time.perf_counter()
    go = os.path.join(out, "go")
    while not os.path.exists(go):
        check(time.perf_counter() - t < DP_GO_TIMEOUT,
              "phase 19's parent never said go")
        try:
            os.kill(cfg["parent"], 0)
        except ProcessLookupError:
            fail("the script that started this worker has ended")
        time.sleep(0.02)
    parts["wait_for_parent"] = time.perf_counter() - t
    # the parameters' shapes, from the parent's bind of the same net (an
    # inference of the graph's shapes here would be the bind's again)
    with open(os.path.join(out, "shapes.json")) as f:
        shapes = [tuple(sh) for sh in json.load(f)]
    t = time.perf_counter()
    kv = mx.kv.create("dist_sync")
    check(kv.rank == rank, f"rank {kv.rank} is not worker {rank}")
    parts["group"] = time.perf_counter() - t
    res = {"rank": rank, "num_workers": kv.num_workers}
    ctx = _dp_ctx(mx, cfg)
    dev = ctx.torch_device()

    # (a) the model's gradient list through dist_sync's push and pull
    # (the worker's first work on the card: on an H100 the bind took
    # 18.3 s as the first work, 4.6 s after this)
    def grads_of(r):
        g = torch.Generator(device=dev)
        g.manual_seed(DP_SEED + 100 + r)
        return [torch.randn(s, generator=g, device=dev) for s in shapes]

    t = time.perf_counter()
    keys = list(range(len(shapes)))
    mine = grads_of(rank)
    kv.init(keys, [mx.nd.zeros(s, ctx=ctx) for s in shapes])
    outs = [mx.nd.zeros(s, ctx=ctx) for s in shapes]
    _dp_sync(torch, cfg)
    t0 = time.perf_counter()
    kv.push(keys, [mx.nd.NDArray(g, ctx=ctx) for g in mine])
    kv.pull(keys, out=outs)
    _dp_sync(torch, cfg)
    push_ms = (time.perf_counter() - t0) * 1e3
    want = [a + b for a, b in zip(grads_of(0), grads_of(1))]
    res["push_pull"] = {
        "elements": int(sum(g.numel() for g in mine)), "keys": len(keys),
        "ms": push_ms,
        "bit_equal": all(torch.equal(o.data, w)
                         for o, w in zip(outs, want))}
    del mine, outs, want, kv
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    parts["push_pull"] = time.perf_counter() - t
    t = time.perf_counter()
    mod = mx.mod.Module(net, context=ctx)
    mod.bind(data.provide_data, data.provide_label)
    parts["bind"] = time.perf_counter() - t
    t = time.perf_counter()
    mx.random.seed(cfg["seed"] + rank)
    mod.init_params(initializer=mx.init.Xavier(**_INIT))
    res["init_digest"] = _digests({n: v.data for n, v in
                                   mod.get_params()[0].items()})
    parts["init"] = time.perf_counter() - t
    # (b) Module.fit through the fused step's data plane
    step_ends, captures = [], {}

    def on_batch(param):
        fs = mod._fused_step
        _dp_sync(torch, cfg)
        if param.nbatch == 0:
            if rank == 0:
                params, auxs = fs.snapshot()
                np.savez(os.path.join(out, "step1.npz"),
                         **{f"arg:{n}": v.cpu().numpy()
                            for n, v in params.items()},
                         **{f"aux:{n}": v.cpu().numpy()
                            for n, v in auxs.items()})
            collective.barrier()    # step 2's clock starts together
        if param.nbatch == 1:
            captures["warm"] = fs.captures
        step_ends.append(time.perf_counter())

    passes.reset_launch_counts()
    _dp_sync(torch, cfg)
    t0 = time.perf_counter()
    mod.fit(data, num_epoch=1, kvstore="dist_sync", optimizer="sgd",
            optimizer_params=_OPT, initializer=mx.init.Xavier(**_INIT),
            batch_end_callback=on_batch,
            eval_metric=mx.metric.create(["acc", "ce"]))
    _dp_sync(torch, cfg)
    fs = mod._fused_step
    parts["fit"] = time.perf_counter() - t0
    launches = passes.launch_counts()
    step_ms = [(e - s) * 1e3 for s, e in zip(step_ends[:-1], step_ends[1:])]
    _dp_sync(torch, cfg)
    t1 = time.perf_counter()
    fs._sum_grads()     # the step's all-reduce alone, once more
    _dp_sync(torch, cfg)
    ar_ms = (time.perf_counter() - t1) * 1e3
    params = {n: v for n, v in fs.params.items()}
    params.update({f"aux:{n}": v for n, v in fs.auxs.items()})
    res["fit"] = {
        "steps": len(step_ends), "fit_s": time.perf_counter() - t0,
        "step_ms": step_ms,
        "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_p95": float(np.percentile(step_ms, 95)),
        "allreduce_ms": ar_ms,
        "allreduce_bytes": int(sum(f.numel() * f.element_size()
                                   for f in fs._grad_flat.values())),
        "captures_after_warmup": fs.captures - captures.get("warm", 0),
        "captures": fs.captures, "segments": fs.segments(),
        "graphed": fs.graphed, "uncaptured_op": fs.uncaptured_op,
        "batchnorm_collectives_per_step": 2 * fs._global_bn,
        "launches_per_step": {k: v / len(step_ends)
                              for k, v in launches.items() if v},
        "nproc": fs._nproc,
        "batch_scale": fs._batch_scale,
        "rescale_grad": mod._optimizer.rescale_grad,
        "finite": all(bool(torch.isfinite(v).all())
                      for v in fs.params.values()),
        "param_digest": _digests(params)}
    parts["after_fit"] = time.perf_counter() - t0 - parts["fit"]
    res["worker_s"] = time.perf_counter() - t_start
    res["parts_s"] = parts
    kv = mod._kvstore
    del mod, fs, params, data
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    mp = _mp_worker(torch, mx, cfg["mp"], out, rank, *mp_inputs)
    mp["worker_s"] = time.perf_counter() - t
    # what this process compiled in both phases
    res["compiled"] = kernels.compiled()
    t = time.perf_counter()
    pe = _pe_worker(torch, mx, cfg["pe"], out, rank)
    pe["worker_s"] = time.perf_counter() - t
    pe["compiled"] = kernels.compiled()[len(res["compiled"]):]
    with open(os.path.join(out, f"pe-{rank}.json"), "w") as f:
        json.dump(pe, f)
    with open(os.path.join(out, f"worker-{rank}.json"), "w") as f:
        json.dump(res, f)
    with open(os.path.join(out, f"mp-{rank}.json"), "w") as f:
        json.dump(mp, f)
    kv._barrier()
    # join the gloo group's threads before the interpreter's teardown,
    # which can otherwise end a worker in std::terminate (rc 250) after
    # its work is written
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


def _dp_reference_step(torch, mx, cfg):
    """One fused step over the global batch of 64 (both workers' rows of
    step 1) in one process from rank 0's initial weights: the GSPMD
    semantics (BatchNorm over 64 rows). Returns the initial weights'
    digest and {"arg:"/"aux:" name: (before, after)} on the host."""
    (x0, y0), (x1, y1) = _dp_rows(cfg, 0, 0), _dp_rows(cfg, 0, 1)
    ctx = _dp_ctx(mx, cfg)
    mod = mx.mod.Module(_dp_net(cfg), context=ctx)
    side = cfg["image"]
    mod.bind(data_shapes=[("data", (2 * DP_BATCH, 3, side, side))],
             label_shapes=[("softmax_label", (2 * DP_BATCH,))])
    mx.random.seed(cfg["seed"])
    mod.init_params(initializer=mx.init.Xavier(**_INIT))
    args, auxs = mod.get_params()
    shapes = [list(args[n].shape) for n in mod._param_names]
    before = {f"arg:{n}": v.data.clone() for n, v in args.items()}
    before.update({f"aux:{n}": v.data.clone() for n, v in auxs.items()})
    digest = _digests({n: v.data for n, v in args.items()})
    mod.init_optimizer(optimizer="sgd", optimizer_params=_OPT)
    mod.forward_backward(mx.io.DataBatch(
        data=[mx.nd.array(np.concatenate([x0, x1]), ctx=ctx)],
        label=[mx.nd.array(np.concatenate([y0, y1]), ctx=ctx)]))
    mod.update()
    fs = mod._fused_step
    after = {f"arg:{n}": v for n, v in fs.params.items()}
    after.update({f"aux:{n}": v for n, v in fs.auxs.items()})
    pairs = {k: (before[k].cpu(), after[k].cpu()) for k in before}
    del mod, fs, before, after
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    return digest, pairs, shapes


def _dp_step1_worst(torch, pairs, step1):
    """{tensor: max |worker's movement - reference's| / max |reference's
    movement|} of step 1 (a tensor that does not move may differ by
    rounding alone: the movement's floor is 1e-6)."""
    worst = {}
    for k, (before, after) in pairs.items():
        moved = after - before
        got = torch.from_numpy(step1[k]) - before
        scale = moved.abs().max().clamp_min(1e-6)
        worst[k] = ((got - moved).abs().max() / scale).item()
    return worst


def _start_dp_workers():
    """Phase 19's two workers through tools/launch.py -n 2, started with
    the script: they import and draw their batches on the host beside
    phase 1's builds, then wait for phase 19's go before they touch the
    card or the group. Returns (process, their directory)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    atexit.register(__import__("shutil").rmtree, out, True)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(_dp_config() | {"parent": os.getpid()}, f)
    # a session of their own: the launcher and both workers are stopped
    # together (`_stop_dp_workers`)
    proc = subprocess.Popen(
        [sys.executable, os.path.join(root, "tools", "launch.py"), "-n",
         "2", sys.executable, os.path.abspath(__file__), "--dp-worker",
         out], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True)
    atexit.register(_stop_dp_workers, proc)
    return proc, out


def _stop_dp_workers(proc):
    """Kill the launcher's process group (the launcher and its workers)
    if it is still running; the launcher's stderr, reaped."""
    import signal

    if proc.poll() is not None:
        return ""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    return proc.communicate()[1] or ""


def phase_data_parallel(torch, mx, card, workers):
    """(1) the executor group over [gpu(0), gpu(0)] with kvstore
    'device'; (2) the two workers (`_start_dp_workers`) on cuda:0:
    dist_sync push/pull of the gradient list, Module.fit with
    kvstore='dist_sync' through the fused step's data plane, nothing
    compiled; step 1 against one process's step over the global batch."""
    cfg = _dp_config()
    res = {"group": _dp_group(torch, mx, cfg)}
    proc, out = workers
    t0 = time.perf_counter()
    try:
        t1 = time.perf_counter()
        digest, pairs, shapes = _dp_reference_step(torch, mx, cfg)
        with open(os.path.join(out, "shapes.json"), "w") as f:
            json.dump(shapes, f)
        res["reference_s"] = time.perf_counter() - t1
        # phase 20's one-process step, also before the workers' go
        t1 = time.perf_counter()
        res["mp_reference"] = _mp_reference(torch, mx, cfg["mp"])
        res["mp_reference_s"] = time.perf_counter() - t1
        # and phase 21's
        t1 = time.perf_counter()
        res["pe_reference"] = _pe_reference(torch, mx, cfg["pe"])
        res["pe_reference_s"] = time.perf_counter() - t1
        with open(os.path.join(out, "go"), "w"):
            pass
        stdout, stderr = proc.communicate(timeout=DP_WORKERS_TIMEOUT)
    except subprocess.TimeoutExpired:
        stderr = _stop_dp_workers(proc)
        fail(f"the two workers did not finish in {DP_WORKERS_TIMEOUT} s: "
             f"{stderr[-3000:]}")
    finally:
        _stop_dp_workers(proc)
    res["workers_s"] = time.perf_counter() - t0
    res["out"] = out
    check(proc.returncode == 0, f"a worker failed (rc {proc.returncode}):\n"
          f"{stdout[-2000:]}\n{stderr[-4000:]}")
    workers = []
    for r in range(2):
        path = os.path.join(out, f"worker-{r}.json")
        check(os.path.exists(path), f"worker {r} wrote no result")
        with open(path) as f:
            workers.append(json.load(f))
    fits = [w["fit"] for w in workers]
    for w in workers:
        pp, fit = w["push_pull"], w["fit"]
        check(w["num_workers"] == 2 and fit["nproc"] == 2
              and fit["batch_scale"] == 2
              and abs(fit["rescale_grad"] - 1 / (2 * DP_BATCH)) < 1e-12,
              f"worker {w['rank']}: not a two-worker data plane {fit}")
        check(pp["bit_equal"], f"worker {w['rank']}: the pulled gradient "
              "sum is not rank 0's plus rank 1's bit for bit")
        check(fit["steps"] == DP_STEPS and fit["finite"],
              f"worker {w['rank']}: {fit['steps']} steps, finite "
              f"{fit['finite']}")
        lps = fit["launches_per_step"]
        check(lps.get("elementwise") == 1
              and lps.get("scale_bias_act") == _dp_b2(cfg),
              f"worker {w['rank']}: B1/B2 launches a step {lps}")
        check(fit["captures_after_warmup"] == 0,
              f"worker {w['rank']}: {fit['captures_after_warmup']} captures "
              "after warmup")
        check(w["compiled"] == [], f"worker {w['rank']} compiled "
              f"{w['compiled']}")
    check(fits[0]["param_digest"] == fits[1]["param_digest"],
          "the ranks' parameters differ after "
          f"{DP_STEPS} steps: " + str([n for n in fits[0]["param_digest"]
                                       if fits[0]["param_digest"][n]
                                       != fits[1]["param_digest"][n]][:5]))
    check(workers[0]["init_digest"] != workers[1]["init_digest"],
          "the ranks were seeded alike: the broadcast was not exercised")
    worst = _dp_step1_worst(torch, pairs,
                            dict(np.load(os.path.join(out, "step1.npz"))))
    name = max(worst, key=worst.get)
    median = float(np.median(list(worst.values())))
    res["summary"] = {
        "group_step_ms": res["group"]["step_ms"],
        "group_launches_per_executor_step":
            res["group"]["launches_per_executor_step"],
        "push_pull_ms": [w["push_pull"]["ms"] for w in workers],
        "push_pull_elements": workers[0]["push_pull"]["elements"],
        "step_ms": [f["step_ms"] for f in fits],
        "step_ms_p50": [f["step_ms_p50"] for f in fits],
        "step_ms_p95": [f["step_ms_p95"] for f in fits],
        "allreduce_ms": [f["allreduce_ms"] for f in fits],
        "allreduce_bytes": fits[0]["allreduce_bytes"],
        "captures": fits[0]["captures"],
        "captures_after_warmup": [f["captures_after_warmup"] for f in fits],
        "segments": fits[0]["segments"],
        "uncaptured_op": fits[0]["uncaptured_op"],
        "batchnorm_collectives_per_step":
            fits[0]["batchnorm_collectives_per_step"],
        "launches_per_step": fits[0]["launches_per_step"],
        "ranks_bit_equal": True,
        "step1_vs_global": {"worst_tensor": name, "worst": worst[name],
                            "median": median,
                            "tol_worst": DP_STEP1_WORST,
                            "tol_median": DP_STEP1_MEDIAN},
        "compiled_in_workers": [w["compiled"] for w in workers],
        "worker_parts_s": [w["parts_s"] for w in workers],
        "worker_s": [w["worker_s"] for w in workers],
        "parts_s": {"group": res["group"]["phase_s"],
                    "workers_both_phases": res["workers_s"],
                    "reference_before_go": res["reference_s"],
                    "phase20_reference_before_go":
                        res["mp_reference_s"],
                    "phase21_reference_before_go":
                        res["pe_reference_s"]},
        "group_bind_s": res["group"]["bind_s"], "card": card}
    log("phase 19: " + json.dumps(res["summary"]))
    check(digest == workers[0]["init_digest"],
          "rank 0's initial weights are not the reference's")
    check(worst[name] <= DP_STEP1_WORST and median <= DP_STEP1_MEDIAN,
          f"step 1 of the two workers against the global-batch step: "
          f"{name} differs by {worst[name]!r} of its movement (limit "
          f"{DP_STEP1_WORST}), the median tensor by {median!r} (limit "
          f"{DP_STEP1_MEDIAN})")
    log("phase 19 ok: the executor group's store sums, two workers train "
        "Inception-ResNet-v2 bit-equal through the fused step's data "
        "plane")
    return res


# ----------------------------------------------------------- phase 20
MP_TOWER = dict(TOWER_CFG, causal=True)   # phase 9's tower, full width
MP_BATCH, MP_SEQ = TOWER_BATCH, TOWER_SEQ  # the global batch: 8 x 2048
MP_STEPS = 6                 # (a)'s fit steps
MP_SIDE_STEPS = 3            # (b)'s and (c)'s steps
MP_SAVE_AFTER = 3            # (d): the checkpoint after (a)'s step 3
MP_SEED = 20
MP_OPT = (("learning_rate", 0.05), ("momentum", 0.9))
MP_DEVICE = "cuda"
# step 1 of the two workers (ring, sequence split; fsdp, rows split)
# against one process's step over the global batch from the same
# weights, each tensor's difference over its movement: the products and
# the gradient sums run in other orders (two halves and gloo's sum; the
# ring's blockwise softmax against one softmax), float32 with TF32 off.
# The CPU rehearsal (d_model 32, 2 layers, batch 2 x 64) measured
# 2.3e-5 (ring), 1.3e-5 (fsdp) and, (b) Ulysses against (a), 2.3e-5.
MP_STEP1_WORST = 1e-3
# (d): the restored module's step 4 against the workers' step 4, as step 1
MP_STEP4_WORST = 1e-3
# the decode tier's ring-prefill arm: prompts whose length bucket
# reaches this prefill through ring attention (phase 3's two longest
# prompts, 1000 and 1024 tokens)
RING_PREFILL = 1024


def _mp_config():
    return {"tower": MP_TOWER, "batch": MP_BATCH, "seq": MP_SEQ,
            "steps": MP_STEPS, "side_steps": MP_SIDE_STEPS,
            "save_after": MP_SAVE_AFTER, "seed": MP_SEED,
            "opt": [list(o) for o in MP_OPT], "device": MP_DEVICE}


def _mp_shape(cfg):
    return (cfg["batch"], cfg["seq"], cfg["tower"]["d_model"])


def _mp_init(cfg):
    """The tower's initial weights, drawn by numpy from the seed: the
    same in the workers and the parent. The parameters' shapes are
    inferred at one row of 8 tokens (they depend on neither; the
    inference runs the graph's ops on the host, 1.7 s at the full
    batch)."""
    from mxnet_tpu_torch.models import get_transformer

    net = get_transformer(**cfg["tower"])
    small = (1, 8, cfg["tower"]["d_model"])
    shapes, _, _ = net.infer_shape(data=small, label=small)
    rs = np.random.RandomState(cfg["seed"])
    return {n: (rs.standard_normal(sh) / np.sqrt(sh[-1])).astype(np.float32)
            for n, sh in zip(net.list_arguments(), shapes)
            if n not in ("data", "label")}


def _mp_batch(cfg, step):
    """Step `step`'s global batch (data, label)."""
    rs = np.random.RandomState(cfg["seed"] * 1000 + step)
    return tuple(rs.uniform(-1, 1, _mp_shape(cfg)).astype(np.float32)
                 for _ in range(2))


def _mp_module(mx, cfg, init, ctx, impl="ring", seq=True, plan=None):
    """The tower in a Module: over the two processes' 'seq' axis (w1/w2
    sharded over it, data and label split "None,seq"), under `plan`, or
    in one process with no mesh; SGD with momentum from `init`."""
    from mxnet_tpu_torch.models import get_transformer

    net = get_transformer(impl=impl, tp_axis="seq" if seq else None,
                          **cfg["tower"])
    kw = dict(mesh_shape={"seq": 2}, data_shardings={
        "data": "None,seq", "label": "None,seq"}) if seq else {}
    mod = mx.mod.Module(net, label_names=("label",), context=ctx,
                        sharding=plan, **kw)
    mod.bind(data_shapes=[("data", _mp_shape(cfg))],
             label_shapes=[("label", _mp_shape(cfg))])
    mod.init_params(arg_params={n: mx.nd.array(v, ctx=ctx)
                                for n, v in init.items()},
                    aux_params={}, force_init=True)
    mod.init_optimizer(kvstore="tpu" if (seq or plan) else "local",
                       optimizer="sgd",
                       optimizer_params=tuple(map(tuple, cfg["opt"])))
    return mod


def _mp_step(mx, mod, ctx, batch):
    x, y = batch
    mod.forward_backward(mx.io.DataBatch(data=[mx.nd.array(x, ctx=ctx)],
                                         label=[mx.nd.array(y, ctx=ctx)]))
    mod.update()


def _mp_whole(fs):
    """The step's whole parameters and momentum on the host (a
    collective: both workers call it)."""
    from mxnet_tpu_torch.sharding.lower import gather

    params = {n: v.cpu().numpy() for n, v in fs.snapshot()[0].items()}
    mom = {}
    for n, st in fs.states.items():
        t = gather(st, fs._shards[n]) if n in fs._shards else st
        mom[n] = t.detach().cpu().numpy()
    return params, mom


def _np_digests(arrays):
    import hashlib

    return {n: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for n, v in arrays.items()}


def _mp_worst(init, got, want):
    """{tensor: max |got - want| / max |want's movement from init|}."""
    out = {}
    for n, w in want.items():
        moved = max(float(np.abs(w - init[n]).max()), 1e-12)
        out[n] = float(np.abs(got[n] - w).max()) / moved
    return out


def _mp_host_inputs(cfg):
    """(initial weights, (a)'s data iterator) on the host."""
    batches = [_mp_batch(cfg, s) for s in range(cfg["steps"])]
    rest = _mp_shape(cfg)[1:]
    import mxnet_tpu_torch as mx

    data = mx.io.NDArrayIter(
        np.stack([b[0] for b in batches]).reshape((-1,) + rest),
        np.stack([b[1] for b in batches]).reshape((-1,) + rest),
        batch_size=cfg["batch"], shuffle=False, label_name="label")
    return _mp_init(cfg), data


def _mp_worker(torch, mx, cfg, out, rank, init, data):
    """Phase 20 in one of the two workers (after phase 19's part): (a)
    the SP+TP tower over the processes' 'seq' axis with ring attention,
    MP_STEPS fit steps, the checkpoint after step MP_SAVE_AFTER; (b)
    Ulysses; (c) ShardingPlan({'fsdp': 2}). Returns the worker's numbers;
    rank 0 writes the step-1 and step-4 weights the parent compares."""
    from mxnet_tpu_torch.parallel import collective
    from mxnet_tpu_torch.sharding import ShardingPlan, device_param_bytes

    ctx = _dp_ctx(mx, cfg)
    res, parts = {}, {}
    t = time.perf_counter()
    mod = _mp_module(mx, cfg, init, ctx)
    fs = mod._fused_step
    parts["a_bind"] = time.perf_counter() - t
    check(fs is not None and fs._nproc == 2 and fs._batch_scale == 1
          and fs.splits_inputs,
          f"worker {rank}: the tower is not a two-process seq mesh")
    state = {"start": None, "step_ms": [], "first": None}
    ck = os.path.join(out, "mp_ck")

    def on_batch(param):
        _dp_sync(torch, cfg)
        state["step_ms"].append((time.perf_counter() - state["start"]) * 1e3)
        k = param.nbatch + 1          # the steps taken
        if k == 1:
            params, _ = _mp_whole(fs)
            state["first"] = params
            if rank == 0:
                np.savez(os.path.join(out, "mp_a_step1.npz"), **params)
            collective.reset_sent_bytes()
        if k == 2:
            state["warm_captures"] = fs.captures
        if k == cfg["save_after"]:
            t0 = time.perf_counter()
            mx.save_sharded(mod, ck)
            state["save_s"] = time.perf_counter() - t0
            params, mom = _mp_whole(fs)
            state["saved_digests"] = {"params": _np_digests(params),
                                      "momentum": _np_digests(mom)}
        if k == cfg["save_after"] + 1:
            params, _ = _mp_whole(fs)
            if rank == 0:
                np.savez(os.path.join(out, "mp_a_step4.npz"), **params)
        _dp_sync(torch, cfg)
        state["start"] = time.perf_counter()

    t = time.perf_counter()
    state["start"] = time.perf_counter()
    mod.fit(data, num_epoch=1, kvstore="tpu", optimizer="sgd",
            optimizer_params=tuple(map(tuple, cfg["opt"])),
            eval_metric="mse", batch_end_callback=on_batch)
    _dp_sync(torch, cfg)
    parts["a_fit"] = time.perf_counter() - t
    steady = state["step_ms"][1:]
    sent, secs = collective.sent_bytes(), collective.collective_seconds()
    timed = len(steady)
    shards = sorted(fs._shards)
    stored = device_param_bytes(fs.params)
    w_local = sum(fs.params[n].numel() * fs.params[n].element_size()
                  for n in shards)
    w_whole = sum(int(np.prod(init[n].shape)) * 4 for n in shards)
    res["a"] = {
        "steps": len(state["step_ms"]), "step_ms": state["step_ms"],
        "step_ms_p50": float(np.percentile(steady, 50)),
        "step_ms_p95": float(np.percentile(steady, 95)),
        "tokens_per_s": cfg["batch"] * cfg["seq"]
        / (float(np.percentile(steady, 50)) / 1e3),
        "ring_bytes_per_step": sent.get("ring", 0) / timed,
        "collective_bytes_per_step": {k: v / timed for k, v in sent.items()},
        "collective_ms_per_step": {k: v * 1e3 / timed
                                   for k, v in secs.items()},
        "captures": fs.captures,
        "captures_after_warmup": fs.captures - state["warm_captures"],
        "segments": fs.segments(), "uncaptured_op": fs.uncaptured_op,
        "sharded": shards,
        "specs": {n: str(tuple(v)) for n, v in fs._param_specs.items()},
        "stored_bytes": stored,
        "whole_bytes": sum(v.nbytes for v in init.values()),
        "sharded_local_bytes": w_local, "sharded_whole_bytes": w_whole,
        "replicated_digest": _digests({n: v for n, v in fs.params.items()
                                       if n not in fs._shards}),
        "finite": all(bool(torch.isfinite(v).all())
                      for v in fs.params.values()),
        "saved_digests": state["saved_digests"],
        "save_s": state["save_s"]}
    first = state["first"]
    del mod, fs, data
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    # (b) Ulysses from the same weights, against (a)'s step 1
    t = time.perf_counter()
    mod = _mp_module(mx, cfg, init, ctx, impl="ulysses")
    step_ms = []
    for s in range(cfg["side_steps"]):
        t0 = time.perf_counter()
        _mp_step(mx, mod, ctx, _mp_batch(cfg, s))
        _dp_sync(torch, cfg)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            params, _ = _mp_whole(mod._fused_step)
            worst = _mp_worst(init, params, first)
    name = max(worst, key=worst.get)
    res["b"] = {"step_ms": step_ms, "vs_ring_step1": {
        "worst_tensor": name, "worst": worst[name]},
        "finite": all(bool(torch.isfinite(v).all())
                      for v in mod._fused_step.params.values())}
    parts["b"] = time.perf_counter() - t
    del mod
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    # (c) FSDP: the plan's rules shard every weight's dim over 'fsdp'
    t = time.perf_counter()
    mod = _mp_module(mx, cfg, init, ctx, seq=False,
                     plan=ShardingPlan({"fsdp": 2}))
    fs = mod._fused_step
    step_ms = []
    for s in range(cfg["side_steps"]):
        t0 = time.perf_counter()
        _mp_step(mx, mod, ctx, _mp_batch(cfg, s))
        _dp_sync(torch, cfg)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if s == 0:
            params, _ = _mp_whole(fs)
            if rank == 0:
                np.savez(os.path.join(out, "mp_c_step1.npz"), **params)
    res["c"] = {"step_ms": step_ms,
                "stored_bytes": device_param_bytes(fs.params),
                "whole_bytes": sum(v.nbytes for v in init.values()),
                "sharded": sorted(fs._shards),
                "specs": {n: str(tuple(v))
                          for n, v in fs._param_specs.items()},
                "plan_digest": fs._plan.digest(),
                "batch_axes": list(fs._split),
                "finite": all(bool(torch.isfinite(v).all())
                              for v in fs.params.values())}
    parts["c"] = time.perf_counter() - t
    del mod, fs
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    res["parts_s"] = parts
    return res


def _mp_reference(torch, mx, cfg):
    """One process's step over the global batch (step 1's), from the
    workers' initial weights, with no mesh: the parameters after it."""
    ctx = _dp_ctx(mx, cfg)
    init = _mp_init(cfg)
    mod = _mp_module(mx, cfg, init, ctx, seq=False)
    _mp_step(mx, mod, ctx, _mp_batch(cfg, 0))
    after = {n: v.cpu().numpy()
             for n, v in mod._fused_step.snapshot()[0].items()}
    del mod
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    return init, after


def phase_model_parallel(torch, mx, card, dp):
    """Phase 20's checks on what the workers of phase 19's launch wrote
    (module docstring), and (d): the sharded checkpoint restored in this
    process into a module with no mesh, then its step 4."""
    cfg = _mp_config()
    out = dp["out"]
    init, ref1 = dp["mp_reference"]
    workers = []
    for r in range(2):
        path = os.path.join(out, f"mp-{r}.json")
        check(os.path.exists(path), f"phase 20: worker {r} wrote no result")
        with open(path) as f:
            workers.append(json.load(f))
    a = [w["a"] for w in workers]
    res = {}
    for r, w in enumerate(workers):
        check(w["a"]["steps"] == cfg["steps"] and w["a"]["finite"]
              and w["b"]["finite"] and w["c"]["finite"],
              f"phase 20: worker {r}: {w['a']['steps']} steps, finite "
              f"{w['a']['finite']}, {w['b']['finite']}, {w['c']['finite']}")
        check(w["a"]["captures_after_warmup"] == 0,
              f"phase 20: worker {r} captured "
              f"{w['a']['captures_after_warmup']} graphs after warmup")
        check(w["a"]["sharded_local_bytes"] * 2
              == w["a"]["sharded_whole_bytes"]
              and w["a"]["stored_bytes"] == w["a"]["whole_bytes"]
              - w["a"]["sharded_whole_bytes"] // 2
              and len(w["a"]["sharded"]) == 2 * cfg["tower"]["num_layers"],
              f"phase 20: worker {r}: w1/w2 not stored a half each: "
              f"{w['a']['sharded_local_bytes']} of "
              f"{w['a']['sharded_whole_bytes']} B, {w['a']['sharded']}")
        check(w["c"]["stored_bytes"] * 2 == w["c"]["whole_bytes"],
              f"phase 20: worker {r}: fsdp stores {w['c']['stored_bytes']} "
              f"of {w['c']['whole_bytes']} B, not half")
        check(w["b"]["vs_ring_step1"]["worst"] <= MP_STEP1_WORST,
              f"phase 20: Ulysses' step 1 against the ring's: "
              f"{w['b']['vs_ring_step1']}")
    check(a[0]["replicated_digest"] == a[1]["replicated_digest"],
          "phase 20: the ranks' replicated parameters differ")
    check(a[0]["saved_digests"] == a[1]["saved_digests"],
          "phase 20: the ranks' gathered step-3 states differ")
    step1 = dict(np.load(os.path.join(out, "mp_a_step1.npz")))
    fsdp1 = dict(np.load(os.path.join(out, "mp_c_step1.npz")))
    ring_worst = _mp_worst(init, step1, ref1)
    fsdp_worst = _mp_worst(init, fsdp1, ref1)
    for label, worst in (("ring", ring_worst), ("fsdp", fsdp_worst)):
        name = max(worst, key=worst.get)
        res[f"{label}_step1_vs_one_process"] = {
            "worst_tensor": name, "worst": worst[name],
            "tol": MP_STEP1_WORST}
        check(worst[name] <= MP_STEP1_WORST,
              f"phase 20: the {label} step 1 against one process's: "
              f"{name} differs by {worst[name]!r} of its movement")
    # (d) the checkpoint into one process with no mesh, then step 4
    t = time.perf_counter()
    ctx = _dp_ctx(mx, cfg)
    mod = _mp_module(mx, cfg, init, ctx, seq=False)
    meta = mx.load_sharded(mod, os.path.join(out, "mp_ck"))
    fs = mod._fused_step
    params = {n: v.cpu().numpy().copy() for n, v in fs.params.items()}
    mom = {n: st.cpu().numpy().copy() for n, st in fs.states.items()}
    loaded = {"params": _np_digests(params), "momentum": _np_digests(mom)}
    check(meta["t"] == cfg["save_after"] and fs._mesh is None
          and loaded == a[0]["saved_digests"],
          "phase 20: the restored parameters and momentum are not the "
          "workers' gathered ones bit for bit: "
          + str([n for n in loaded["params"] if loaded["params"][n]
                 != a[0]["saved_digests"]["params"].get(n)][:4]))
    _mp_step(mx, mod, ctx, _mp_batch(cfg, cfg["save_after"]))
    after = {n: v.cpu().numpy() for n, v in fs.snapshot()[0].items()}
    step4 = dict(np.load(os.path.join(out, "mp_a_step4.npz")))
    worst = _mp_worst(params, after, step4)
    name = max(worst, key=worst.get)
    res["restored_step4_vs_workers"] = {"worst_tensor": name,
                                        "worst": worst[name],
                                        "tol": MP_STEP4_WORST}
    check(worst[name] <= MP_STEP4_WORST,
          f"phase 20: the restored module's step 4 against the workers': "
          f"{name} differs by {worst[name]!r} of its movement")
    res["restore_s"] = time.perf_counter() - t
    del mod, fs
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    res["summary"] = {
        "sp_tp_ring": {k: a[0][k] for k in (
            "step_ms_p50", "step_ms_p95", "tokens_per_s",
            "ring_bytes_per_step", "collective_bytes_per_step",
            "collective_ms_per_step", "captures", "captures_after_warmup",
            "segments", "uncaptured_op", "stored_bytes", "whole_bytes",
            "sharded_local_bytes", "sharded_whole_bytes", "save_s")}
        | {"step_ms_p50_rank1": a[1]["step_ms_p50"],
           "step_ms": [w["a"]["step_ms"] for w in workers],
           "step1_vs_one_process": res["ring_step1_vs_one_process"],
           "ranks_replicated_bit_equal": True,
           "phase9_step_ms_p50": dp.get("phase9_step_ms_p50")},
        "ulysses": {"step_ms": workers[0]["b"]["step_ms"],
                    "vs_ring_step1": [w["b"]["vs_ring_step1"]
                                      for w in workers]},
        "fsdp": {k: workers[0]["c"][k] for k in (
            "step_ms", "stored_bytes", "whole_bytes", "batch_axes")}
        | {"step1_vs_one_process": res["fsdp_step1_vs_one_process"]},
        "checkpoint": {"restored_bit_equal": True,
                       "restored_into": "one process, no mesh",
                       "step4_vs_workers": res["restored_step4_vs_workers"],
                       "restore_s": res["restore_s"]},
        "ring_prefill": dp.get("ring_prefill"),
        "worker_parts_s": [w["parts_s"] for w in workers],
        "worker_s": [w["worker_s"] for w in workers],
        "card": card}
    log("model_parallel: " + json.dumps(res["summary"]))
    log("phase 20 ok: the SP+TP tower, Ulysses and FSDP across two "
        "workers on one card, the sharded checkpoint restored into one "
        "process")
    return res


# ----------------------------------------------------------- phase 21
PE_STAGES, PE_MICRO = 4, 8   # (a): one tower layer a stage, 8 microbatches
PE_PIPE_STEPS = 4
PE_MOE_STEPS = 3             # (b): the MoE tower's steps
PE_EXPERTS, PE_MOE_EVERY = 8, 2
PE_HET_BATCH, PE_HET_MICRO, PE_HET_STEPS = 32, 4, 3   # (c)
PE_SEED = 21
PE_OPT = (("learning_rate", 0.01), ("momentum", 0.9))
PE_DEVICE = "cuda"
PE_IMAGE = 299
PE_REPEATS = HALF_DEPTH
# step 1 of the workers against the parent's one-process step from the
# same weights, each tensor's difference over its movement (moving
# statistics: over their change; a movement below 1e-6 counts as 1e-6,
# as phase 19's rule: a tensor that does not move differs by rounding
# alone): (a) and (c) sum the microbatches' gradients in another order
# (one backward a microbatch), (b) computes the same sums with the
# experts' outputs gathered over gloo. The CPU rehearsal (d_model 32,
# batch 8 x 64; Inception at 75x75, repeats (1, 1, 1), batch 16)
# measured (a) 0.0, (b) 0.0, (c) 1.2e-4 to 2.1e-4 (moving statistics
# 3.6e-6); the card, (a) 0.0, (b) 0.0, (c) 5.5e-4 at lr 0.05 and 2.4e-3
# at lr 0.01 (moving statistics 0.0). cuDNN picks (c)'s convolutions'
# weight-gradient algorithms in each process for itself, so the
# workers' sums run in other orders than the parent's, as in phase 6's
# check of the same net (1e-3 of a gradient's max): (c)'s parameters
# are held to ten times (a) and (b)'s limit. Its moving statistics come
# from the forward alone and are held to their own readings' limit.
# What a wrong schedule reads against the same composition (computed in
# the parent each run and checked to exceed these limits): on the CPU
# rehearsal a dropped last microbatch 1.0 (parameters) and 0.66 (moving
# statistics), the moving statistics updated in reverse order 0.35.
PE_STEP1_WORST = 1e-3
PE_HET_STEP1_WORST = 1e-2
PE_HET_AUX_WORST = 1e-4


def _pe_config():
    return {"tower": dict(TOWER_CFG), "batch": TOWER_BATCH,
            "seq": TOWER_SEQ, "stages": PE_STAGES, "micro": PE_MICRO,
            "pipe_steps": PE_PIPE_STEPS, "moe_steps": PE_MOE_STEPS,
            "experts": PE_EXPERTS, "moe_every": PE_MOE_EVERY,
            "het_batch": PE_HET_BATCH, "het_micro": PE_HET_MICRO,
            "het_steps": PE_HET_STEPS, "image": PE_IMAGE,
            "repeats": list(PE_REPEATS), "seed": PE_SEED,
            "opt": [list(o) for o in PE_OPT], "device": PE_DEVICE}


def _pe_stage(mx, cfg):
    """(a)'s stage: one layer of phase 9's tower, causal attention
    through the RingAttention op and the FFN, each added back."""
    from mxnet_tpu_torch.models import transformer as tr

    t = cfg["tower"]
    x = mx.sym.Variable("data")
    x = x + tr._attention(x, t["d_model"], t["num_heads"], "attn", "ring",
                          True)
    return x + tr._ffn(x, t["d_model"], t["d_ff"], "ffn", None)


def _pe_shape(cfg):
    return (cfg["batch"], cfg["seq"], cfg["tower"]["d_model"])


def _pe_batch(cfg, step, shape=None):
    rs = np.random.RandomState(cfg["seed"] * 1000 + step)
    shape = shape or _pe_shape(cfg)
    return tuple(rs.uniform(-1, 1, shape).astype(np.float32)
                 for _ in range(2))


def _pe_pipe_init(mx, cfg):
    """(a)'s stage-major weights (S, ...), numpy-drawn from the seed."""
    stage = _pe_stage(mx, cfg)
    small = (1, 8, cfg["tower"]["d_model"])
    shapes, _, _ = stage.infer_shape(data=small)
    rs = np.random.RandomState(cfg["seed"])
    return {n: (rs.standard_normal((cfg["stages"],) + tuple(sh))
                / np.sqrt(sh[-1])).astype(np.float32)
            for n, sh in zip(stage.list_arguments(), shapes)
            if n != "data"}


def _pe_moe_net(cfg):
    from mxnet_tpu_torch.models import get_transformer

    return get_transformer(moe_every=cfg["moe_every"],
                           num_experts=cfg["experts"], **cfg["tower"])


def _pe_moe_init(cfg):
    """(b)'s weights, normal over each weight's fan-in: a dense weight's
    (out, in) last dimension, the router's (D, E) first, an expert
    weight's (E, in, out) second."""
    net = _pe_moe_net(cfg)
    small = (1, 8, cfg["tower"]["d_model"])
    shapes, _, _ = net.infer_shape(data=small, label=small)
    rs = np.random.RandomState(cfg["seed"] + 1)

    def fan_in(n, sh):
        return sh[1] if len(sh) == 3 else sh[0] \
            if n.endswith("_gate_weight") else sh[-1]

    return {n: (rs.standard_normal(sh) / np.sqrt(fan_in(n, sh)))
            .astype(np.float32)
            for n, sh in zip(net.list_arguments(), shapes)
            if n not in ("data", "label")}


def _pe_moe_module(mx, cfg, init, ctx, mesh_shape):
    mod = mx.mod.Module(_pe_moe_net(cfg), label_names=("label",),
                        context=ctx, mesh_shape=mesh_shape)
    mod.bind(data_shapes=[("data", _pe_shape(cfg))],
             label_shapes=[("label", _pe_shape(cfg))])
    mod.init_params(arg_params={n: mx.nd.array(v, ctx=ctx)
                                for n, v in init.items()},
                    aux_params={}, force_init=True)
    mod.init_optimizer(kvstore="tpu" if mesh_shape else "local",
                       optimizer="sgd",
                       optimizer_params=tuple(map(tuple, cfg["opt"])))
    return mod


def _pe_het_stages(cfg):
    """(c)'s stages: Inception-ResNet-v2 at full width cut into 4 stage
    symbols between blocks (models/inception_resnet_v2.py
    `get_pipeline_stages`)."""
    from mxnet_tpu_torch.models import inception_resnet_v2 as irv

    return irv.get_pipeline_stages(repeats=tuple(cfg["repeats"]))


def _pe_het_init(layout):
    """{"stage{s}/{name}": array} of (c)'s parameters and aux states from
    [(stage, name, shape, is_aux)], numpy-drawn from the seed: weights
    normal over the fan-in, BatchNorm's gamma 1 and beta 0, moving means
    0 and variances 1."""
    rs = np.random.RandomState(PE_SEED + 2)
    args, auxs = {}, {}
    for s, n, sh, is_aux in layout:
        key = f"stage{s}/{n}"
        if is_aux:
            auxs[key] = (np.ones if n.endswith("_var") else np.zeros)(
                sh, np.float32)
        elif n.endswith("_gamma"):
            args[key] = np.ones(sh, np.float32)
        elif n.endswith("_beta") or n.endswith("_bias"):
            args[key] = np.zeros(sh, np.float32)
        else:
            fan = int(np.prod(sh[1:])) if len(sh) > 1 else sh[0]
            args[key] = (rs.standard_normal(sh) / np.sqrt(fan)).astype(
                np.float32)
    return args, auxs


def _pe_het_batch(cfg, step):
    rs = np.random.RandomState(cfg["seed"] * 1000 + 500 + step)
    side = cfg["image"]
    x = rs.uniform(-1, 1, (cfg["het_batch"], 3, side, side)).astype(
        np.float32)
    y = rs.randint(0, 1000, (cfg["het_batch"],)).astype(np.float32)
    return x, y


def _pe_timed_steps(torch, mx, cfg, ctx, pm_or_mod, batches, on_step):
    """Each batch a step through forward_backward + update, the card
    synchronised and the workers lined up before each; [ms a step]."""
    from mxnet_tpu_torch.parallel import collective

    ms = []
    for s, (x, y) in enumerate(batches):
        _dp_sync(torch, cfg)
        collective.barrier()
        t0 = time.perf_counter()
        pm_or_mod.forward_backward(mx.io.DataBatch(
            data=[mx.nd.array(x, ctx=ctx)], label=[mx.nd.array(y, ctx=ctx)]))
        pm_or_mod.update()
        _dp_sync(torch, cfg)
        ms.append((time.perf_counter() - t0) * 1e3)
        on_step(s)
    return ms


def _pe_worker(torch, mx, cfg, out, rank):
    """Phase 21 in one of the two workers (after phase 20's part): (a)
    the tower's layers pipelined, 2 stages a worker; (b) the MoE tower on
    mesh {'expert': 2}, the whole batch on both; (c) Inception-ResNet-v2
    as 4 pipelined stages. Rank 0 writes each arm's step-1 state."""
    from mxnet_tpu_torch import passes
    from mxnet_tpu_torch.parallel import collective, moe

    ctx = _dp_ctx(mx, cfg)
    res, parts = {}, {}
    # (a) the pipelined tower
    t = time.perf_counter()
    init = _pe_pipe_init(mx, cfg)
    pm = mx.mod.PipelineModule(_pe_stage(mx, cfg),
                               num_stages=cfg["stages"],
                               num_microbatches=cfg["micro"], context=ctx,
                               loss="l2")
    pm.bind(data_shapes=[("data", _pe_shape(cfg))])
    pm.init_params(arg_params=init)
    pm.init_optimizer(optimizer="sgd",
                      optimizer_params=tuple(map(tuple, cfg["opt"])))
    parts["a_bind"] = time.perf_counter() - t
    a = {"local_bytes": int(sum(v.numel() * v.element_size()
                                for v in pm.params.values())),
         "whole_bytes": int(sum(v.nbytes for v in init.values())),
         "local_stages": int(pm.params["ffn_w1_weight"].shape[0]),
         "losses": []}

    def a_step(s):
        a["losses"].append(pm.loss_value)
        if s == 0:
            sent = dict(collective.sent_bytes())
            secs = dict(collective.collective_seconds())
            a["p2p_bytes_step1"] = sent.get("p2p", 0)
            a["p2p_s_step1"] = secs.get("p2p", 0.0)
            args, _ = pm.get_params()
            outs = pm.get_outputs()[0].asnumpy()
            a["outs_digest"] = _np_digests({"outs": outs})["outs"]
            if rank == 0:
                np.savez(os.path.join(out, "pe_a_step1.npz"), outs=outs,
                         **{n: v.asnumpy() for n, v in args.items()})
            collective.reset_sent_bytes()

    collective.reset_sent_bytes()
    t = time.perf_counter()
    a["step_ms"] = _pe_timed_steps(
        torch, mx, cfg, ctx, pm,
        [_pe_batch(cfg, s) for s in range(cfg["pipe_steps"])], a_step)
    parts["a_steps"] = time.perf_counter() - t
    later = len(a["step_ms"]) - 1
    sent, secs = collective.sent_bytes(), collective.collective_seconds()
    a["p2p_bytes_per_step"] = sent.get("p2p", 0) / later
    a["p2p_ms_per_step"] = secs.get("p2p", 0.0) * 1e3 / later
    a["finite"] = bool(np.isfinite(a["losses"]).all())
    res["a"] = a
    del pm
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    # (b) the MoE tower over mesh {'expert': 2}
    t = time.perf_counter()
    mod = _pe_moe_module(mx, cfg, _pe_moe_init(cfg), ctx, {"expert": 2})
    fs = mod._fused_step
    parts["b_bind"] = time.perf_counter() - t
    b = {"digests": [], "uncaptured_op": fs.uncaptured_op,
         "graphed": fs.graphed}
    moe.reset_stats()
    collective.reset_sent_bytes()

    def b_step(s):
        params = {n: v.cpu().numpy() for n, v in fs.snapshot()[0].items()}
        b["digests"].append(_np_digests(params))
        if s == 0 and rank == 0:
            np.savez(os.path.join(out, "pe_b_step1.npz"), **params)

    t = time.perf_counter()
    b["step_ms"] = _pe_timed_steps(
        torch, mx, cfg, ctx, mod,
        [_pe_batch(cfg, 100 + s) for s in range(cfg["moe_steps"])], b_step)
    parts["b_steps"] = time.perf_counter() - t
    st = moe.stats()
    b.update({"experts_computed": st["experts_computed"],
              "experts": st["experts"], "calls": st["calls"],
              "gloo_bytes_per_step": sum(collective.sent_bytes().values())
              / cfg["moe_steps"],
              "gloo_ms_per_step": sum(collective.collective_seconds()
                                      .values()) * 1e3 / cfg["moe_steps"],
              "batch_scale": fs._batch_scale, "nproc": fs._nproc})
    res["b"] = b
    del mod, fs
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    # (c) Inception-ResNet-v2 as 4 pipelined stages
    t = time.perf_counter()
    side = cfg["image"]
    pm = mx.mod.PipelineModule(_pe_het_stages(cfg),
                               num_microbatches=cfg["het_micro"],
                               context=ctx, loss="softmax_ce")
    pm.bind(data_shapes=[("data", (cfg["het_batch"], 3, side, side))])
    args, auxs = _pe_het_init(_pe_het_layout(pm))
    pm.init_params(arg_params=args, aux_params=auxs)
    pm.init_optimizer(optimizer="sgd",
                      optimizer_params=tuple(map(tuple, cfg["opt"])))
    parts["c_bind"] = time.perf_counter() - t
    c = {"local_rows": int(pm.params["pipeline_flat"].shape[0]),
         "bound_stages": [s for s, ex in enumerate(pm._stage_execs)
                          if ex is not None],
         "losses": []}
    c.update(_pe_het_bytes(pm))

    def c_step(s):
        c["losses"].append(pm.loss_value)
        if s == 0:
            c["launches_step1"] = passes.launch_counts()
            c["p2p_bytes_step1"] = collective.sent_bytes().get("p2p", 0)
            got_a, got_x = pm.get_params()
            if rank == 0:
                np.savez(os.path.join(out, "pe_c_step1.npz"),
                         **{f"arg:{n}": v.asnumpy()
                            for n, v in got_a.items()},
                         **{f"aux:{n}": v.asnumpy()
                            for n, v in got_x.items()})

    passes.reset_launch_counts()
    collective.reset_sent_bytes()
    t = time.perf_counter()
    c["step_ms"] = _pe_timed_steps(
        torch, mx, cfg, ctx, pm,
        [_pe_het_batch(cfg, s) for s in range(cfg["het_steps"])], c_step)
    parts["c_steps"] = time.perf_counter() - t
    c["launches_per_step"] = {k: v / cfg["het_steps"] for k, v in
                              passes.launch_counts().items() if v}
    c["finite"] = bool(np.isfinite(c["losses"]).all())
    res["c"] = c
    res["parts_s"] = parts
    del pm
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    return res


def _pe_het_bytes(pm):
    """{"stored_bytes": the parameter and aux bytes this process keeps
    on its device for a bound hetero PipelineModule (its rows of the
    flat buckets, its stage executors' parameter and aux arrays),
    "whole_bytes": the same for all S stages}."""
    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    stored = nbytes([pm.params["pipeline_flat"], pm._flat_auxs])
    for s, ex in enumerate(pm._stage_execs):
        if ex is not None:
            inputs = set(pm._stage_in_names[s])
            stored += nbytes([a._data for n, a in ex.arg_dict.items()
                              if n not in inputs])
            stored += nbytes([a._data for a in ex.aux_dict.values()])
    segs = [seg for ss in pm._param_segs + pm._aux_segs for seg in ss]
    whole = 4 * pm._num_stages * (pm._lmax + pm._amax) + sum(
        sz * np.dtype(dt).itemsize for (_n, _o, sz, _s, dt) in segs)
    return {"stored_bytes": int(stored), "whole_bytes": int(whole)}


def _pe_het_layout(pm):
    """[(stage, name, shape, is_aux)] of a bound hetero PipelineModule."""
    out = []
    for s, (segs, asegs) in enumerate(zip(pm._param_segs, pm._aux_segs)):
        out += [(s, n, shp, False) for (n, _o, _z, shp, _d) in segs]
        out += [(s, n, shp, True) for (n, _o, _z, shp, _d) in asegs]
    return out


def _pe_reference(torch, mx, cfg):
    """The parent's one-process references, before the workers' go: (a)
    the 4 layers composed microbatch by microbatch, their step 1; (b) the
    MoE tower with no mesh, PE_MOE_STEPS steps; (c) the 4 Inception
    stages composed microbatch by microbatch, step 1 and the moving
    statistics."""
    from mxnet_tpu_torch.parallel import moe

    ctx = _dp_ctx(mx, cfg)
    dev = ctx.torch_device()
    lr = dict(map(tuple, cfg["opt"]))["learning_rate"]
    res, parts = {}, {}
    # (a) a stage executor at one microbatch, composed S times
    t = time.perf_counter()
    init = _pe_pipe_init(mx, cfg)
    shape = _pe_shape(cfg)
    mb = (shape[0] // cfg["micro"],) + shape[1:]
    ex = _pe_stage(mx, cfg).simple_bind(ctx=ctx, grad_req="null", data=mb)
    leaves = {n: torch.tensor(v, device=dev).requires_grad_(True)
              for n, v in init.items()}
    x, y = _pe_batch(cfg, 0)
    outs = []
    for m in range(cfg["micro"]):
        rows = slice(m * mb[0], (m + 1) * mb[0])
        with torch.enable_grad():
            h = torch.tensor(x[rows], device=dev)
            for s in range(cfg["stages"]):
                h = ex._run_graph({**{n: v[s] for n, v in leaves.items()},
                                   "data": h}, True, aux_vals={})[0][0]
            yt = torch.tensor(y[rows], device=dev)
            loss = torch.mean(torch.square(h - yt)) / cfg["micro"]
            loss.backward()
        outs.append(h.detach().cpu().numpy())
    res["a"] = {"init": init, "outs": np.concatenate(outs),
                "after": {n: (v - lr * v.grad).detach().cpu().numpy()
                          for n, v in leaves.items()}}
    del leaves, ex, outs, h
    parts["a"] = time.perf_counter() - t
    # (b) the MoE tower in one process, no mesh
    t = time.perf_counter()
    binit = _pe_moe_init(cfg)
    mod = _pe_moe_module(mx, cfg, binit, ctx, None)
    fs = mod._fused_step
    b = {"step_ms": [], "dropped": [], "aux": []}
    for s in range(cfg["moe_steps"]):
        moe.reset_stats()
        _dp_sync(torch, cfg)
        t0 = time.perf_counter()
        _mp_step(mx, mod, ctx, _pe_batch(cfg, 100 + s))
        _dp_sync(torch, cfg)
        b["step_ms"].append((time.perf_counter() - t0) * 1e3)
        b["dropped"].append(moe.stats()["dropped"])
        b["aux"].append(float(mod.get_outputs()[1].asnumpy()))
        if s == 0:
            b["after"] = {n: v.cpu().numpy()
                          for n, v in fs.snapshot()[0].items()}
            st = moe.stats()
            b["tokens_per_layer_step"] = st["tokens"] // max(st["calls"], 1)
    b.update({"init": binit, "uncaptured_op": fs.uncaptured_op,
              "graphed": fs.graphed, "params": int(sum(
                  v.size for v in binit.values()))})
    res["b"] = b
    del mod, fs
    parts["b"] = time.perf_counter() - t
    # (c) the Inception stages composed
    t = time.perf_counter()
    stages = _pe_het_stages(cfg)
    side = cfg["image"]
    mbn = cfg["het_batch"] // cfg["het_micro"]
    shape = (mbn, 3, side, side)
    execs, layout = [], []
    for s, sym in enumerate(stages):
        e = sym.simple_bind(ctx=ctx, grad_req="null", data=shape)
        execs.append(e)
        _, out_shapes, _ = sym.infer_shape(data=shape)
        layout += [(s, n, tuple(e.arg_dict[n].shape), False)
                   for n in e._arg_names if n != "data"]
        layout += [(s, n, tuple(e.aux_dict[n].shape), True)
                   for n in e._aux_names]
        shape = tuple(out_shapes[0])
    args, auxs = _pe_het_init(layout)
    leaves = {k: torch.tensor(v, device=dev).requires_grad_(True)
              for k, v in args.items()}
    state = {k: torch.tensor(v, device=dev) for k, v in auxs.items()}
    x, y = _pe_het_batch(cfg, 0)

    def compose(h, state):
        for s, e in enumerate(execs):
            pre = f"stage{s}/"
            a = {n[len(pre):]: v for n, v in leaves.items()
                 if n.startswith(pre)}
            xs = {n[len(pre):]: v for n, v in state.items()
                  if n.startswith(pre)}
            outs, upd = e._run_graph({**a, "data": h}, True, aux_vals=xs)
            for n, v in upd.items():
                state[pre + n] = v.detach()
            h = outs[0]
        return h

    def stepped(grads):
        return {k: (v - lr * grads[k]).detach().cpu().numpy()
                if k in grads   # fix_gamma's gamma has no gradient
                else v.detach().cpu().numpy() for k, v in leaves.items()}

    def host(state):
        return {k: v.cpu().numpy() for k, v in state.items()}

    last = cfg["het_micro"] - 1
    for m in range(cfg["het_micro"]):
        rows = slice(m * mbn, (m + 1) * mbn)
        if m == last:   # what a schedule that dropped it would hold
            dropped = {k: v.grad.clone() for k, v in leaves.items()
                       if v.grad is not None}
            dropped_state = host(state)
        with torch.enable_grad():
            h = compose(torch.tensor(x[rows], device=dev), state)
            logp = torch.log_softmax(h, dim=-1)
            lab = torch.tensor(y[rows], device=dev).long()
            loss = -logp.gather(-1, lab[:, None])[:, 0].mean() \
                / cfg["het_micro"]
            loss.backward()
    after = stepped({k: v.grad for k, v in leaves.items()
                     if v.grad is not None})
    after_aux = host(state)
    # a schedule that updates the moving statistics in reverse order
    reversed_state = {k: torch.tensor(v, device=dev)
                      for k, v in auxs.items()}
    with torch.no_grad():
        for m in reversed(range(cfg["het_micro"])):
            compose(torch.tensor(x[m * mbn:(m + 1) * mbn], device=dev),
                    reversed_state)
    # the readings phase 21's checks would give for those two faults
    faults = {
        "dropped_microbatch": max(_pe_worst(
            args, stepped(dropped), after).values()),
        "dropped_microbatch_moving_stats": max(_pe_worst(
            auxs, dropped_state, after_aux).values()),
        "moving_stats_reversed": max(_pe_worst(
            auxs, host(reversed_state), after_aux).values())}
    res["c"] = {"init": args, "init_aux": auxs, "after": after,
                "after_aux": after_aux, "fault_readings": faults}
    del dropped, reversed_state
    del leaves, state, execs, h
    parts["c"] = time.perf_counter() - t
    res["parts_s"] = parts
    if cfg["device"] == "cuda":
        torch.cuda.empty_cache()
    return res


def _pe_worst(init, got, want, floor=1e-6):
    """{tensor: max |got - want| / max |want - init|}."""
    out = {}
    for n, w in want.items():
        moved = max(float(np.abs(w - init[n]).max()), floor)
        out[n] = float(np.abs(got[n] - w).max()) / moved
    return out


def phase_pipe_expert(torch, mx, card, dp):
    """Phase 21's checks on what the workers of phase 19's launch wrote
    and the parent's references (module docstring)."""
    cfg = _pe_config()
    out = dp["out"]
    ref = dp["pe_reference"]
    workers = []
    for r in range(2):
        path = os.path.join(out, f"pe-{r}.json")
        check(os.path.exists(path), f"phase 21: worker {r} wrote no result")
        with open(path) as f:
            workers.append(json.load(f))
    res = {}
    for r, w in enumerate(workers):
        check(w["compiled"] == [], f"phase 21: worker {r} compiled "
              f"{w['compiled']}")
    # (a) the pipelined tower
    a = [w["a"] for w in workers]
    for r, w in enumerate(a):
        check(w["finite"] and len(w["step_ms"]) == cfg["pipe_steps"],
              f"phase 21 (a): worker {r}: {len(w['step_ms'])} steps, "
              f"finite {w['finite']}")
        check(w["local_stages"] == cfg["stages"] // 2
              and 2 * w["local_bytes"] == w["whole_bytes"],
              f"phase 21 (a): worker {r} stores {w['local_bytes']} of "
              f"{w['whole_bytes']} B ({w['local_stages']} stages), not half")
    check(a[0]["losses"] == a[1]["losses"]
          and a[0]["outs_digest"] == a[1]["outs_digest"],
          f"phase 21 (a): the ranks' losses or outputs differ: "
          f"{a[0]['losses']} {a[1]['losses']}")
    step1 = dict(np.load(os.path.join(out, "pe_a_step1.npz")))
    out_err = float(np.abs(step1.pop("outs") - ref["a"]["outs"]).max())
    out_scale = float(np.abs(ref["a"]["outs"]).max())
    worst = _pe_worst(ref["a"]["init"], step1, ref["a"]["after"])
    name = max(worst, key=worst.get)
    tokens = cfg["batch"] * cfg["seq"]
    later = [ms for w in a for ms in w["step_ms"][1:]]
    res["a"] = {
        "step_ms": [w["step_ms"] for w in a],
        "step_ms_p50": float(np.percentile(later, 50)),
        "step_ms_p95": float(np.percentile(later, 95)),
        "tokens_per_s": tokens / (float(np.percentile(later, 50)) / 1e3),
        "boundary_bytes_per_step_each_way": a[0]["p2p_bytes_per_step"],
        "boundary_bytes_per_microbatch": a[0]["p2p_bytes_per_step"]
        / cfg["micro"],
        "send_recv_ms_per_step": [w["p2p_ms_per_step"] for w in a],
        "stored_bytes": [w["local_bytes"] for w in a],
        "whole_bytes": a[0]["whole_bytes"],
        "step1_outputs_vs_composition": out_err / max(out_scale, 1e-12),
        "step1_vs_one_process": {"worst_tensor": name,
                                 "worst": worst[name],
                                 "tol": PE_STEP1_WORST},
        "losses": a[0]["losses"], "ranks_equal": True}
    check(out_err <= PE_STEP1_WORST * out_scale,
          f"phase 21 (a): step 1's outputs against the composition: "
          f"{out_err!r} of {out_scale!r}")
    check(worst[name] <= PE_STEP1_WORST,
          f"phase 21 (a): step 1 against one process's: {name} differs by "
          f"{worst[name]!r} of its movement")
    # (b) the MoE tower
    b = [w["b"] for w in workers]
    for r, w in enumerate(b):
        layers = cfg["tower"]["num_layers"] // cfg["moe_every"]
        check(2 * w["experts_computed"] == w["experts"]
              and w["calls"] == layers * cfg["moe_steps"],
              f"phase 21 (b): worker {r} computed {w['experts_computed']} "
              f"of {w['experts']} expert products in {w['calls']} calls")
        check(w["nproc"] == 2 and w["batch_scale"] == 1,
              f"phase 21 (b): worker {r}: not a two-process expert mesh")
    check(b[0]["digests"] == b[1]["digests"],
          "phase 21 (b): the ranks' parameters differ")
    step1 = dict(np.load(os.path.join(out, "pe_b_step1.npz")))
    worst = _pe_worst(ref["b"]["init"], step1, ref["b"]["after"])
    name = max(worst, key=worst.get)
    res["b"] = {
        "params": ref["b"]["params"],
        "one_process_step_ms": ref["b"]["step_ms"],
        "one_process_uncaptured_op": ref["b"]["uncaptured_op"],
        "dropped_per_step": ref["b"]["dropped"],
        "tokens_per_moe_layer": ref["b"]["tokens_per_layer_step"],
        "aux_per_step": ref["b"]["aux"],
        "step_ms": [w["step_ms"] for w in b],
        "gloo_bytes_per_step": [w["gloo_bytes_per_step"] for w in b],
        "gloo_ms_per_step": [w["gloo_ms_per_step"] for w in b],
        "experts_computed_of": [b[0]["experts_computed"],
                                b[0]["experts"]],
        "uncaptured_op": b[0]["uncaptured_op"],
        "step1_vs_one_process": {"worst_tensor": name,
                                 "worst": worst[name],
                                 "tol": PE_STEP1_WORST},
        "ranks_bit_equal": True}
    check(worst[name] <= PE_STEP1_WORST,
          f"phase 21 (b): step 1 against one process's: {name} differs by "
          f"{worst[name]!r} of its movement")
    # (c) the Inception pipeline
    c = [w["c"] for w in workers]
    launches = {}
    for r, w in enumerate(c):
        check(w["finite"] and w["local_rows"] == 2
              and w["bound_stages"] == [2 * r, 2 * r + 1],
              f"phase 21 (c): worker {r}: finite {w['finite']}, "
              f"{w['local_rows']} stages, executors bound for "
              f"{w['bound_stages']}")
        for k, v in w["launches_per_step"].items():
            launches[k] = launches.get(k, 0) + v
    want = {"elementwise": cfg["het_micro"],
            "scale_bias_act": cfg["het_micro"] * sum(cfg["repeats"])}
    stored = [w["stored_bytes"] for w in c]
    check(sum(stored) == c[0]["whole_bytes"],
          f"phase 21 (c): the workers store {stored} B of parameters and "
          f"aux state, not {c[0]['whole_bytes']} B between them")
    check(all(launches.get(k) == v for k, v in want.items()),
          f"phase 21 (c): B1/B2 launches a step summed over the workers "
          f"{launches}, expected {want}")
    faults = ref["c"]["fault_readings"]
    step1 = dict(np.load(os.path.join(out, "pe_c_step1.npz")))
    got = {k[4:]: v for k, v in step1.items() if k.startswith("arg:")}
    got_aux = {k[4:]: v for k, v in step1.items() if k.startswith("aux:")}
    worst = _pe_worst(ref["c"]["init"], got, ref["c"]["after"])
    worst_aux = _pe_worst(ref["c"]["init_aux"], got_aux,
                          ref["c"]["after_aux"])
    name = max(worst, key=worst.get)
    aname = max(worst_aux, key=worst_aux.get)
    later = [ms for w in c for ms in w["step_ms"][1:]]
    res["c"] = {
        "step_ms": [w["step_ms"] for w in c],
        "step_ms_p50": float(np.percentile(later, 50)),
        "images_per_s": cfg["het_batch"]
        / (float(np.percentile(later, 50)) / 1e3),
        "boundary_bytes_step1": [w["p2p_bytes_step1"] for w in c],
        "launches_per_step_summed": launches,
        "launches_per_step": [w["launches_per_step"] for w in c],
        "step1_vs_one_process": {"worst_tensor": name,
                                 "worst": worst[name],
                                 "tol": PE_HET_STEP1_WORST},
        "moving_stats_step1_vs_one_process": {
            "worst_tensor": aname, "worst": worst_aux[aname],
            "tol": PE_HET_AUX_WORST},
        "fault_readings": faults,
        "stored_bytes": stored, "whole_bytes": c[0]["whole_bytes"],
        "losses": [w["losses"] for w in c]}
    check(worst[name] <= PE_HET_STEP1_WORST
          and worst_aux[aname] <= PE_HET_AUX_WORST,
          f"phase 21 (c): step 1 against the composition: {name} "
          f"{worst[name]!r}, {aname} {worst_aux[aname]!r} of the movement")
    # the limits sit below what a wrong schedule reads
    check(faults["dropped_microbatch"] > PE_HET_STEP1_WORST
          and faults["dropped_microbatch_moving_stats"] > PE_HET_AUX_WORST
          and faults["moving_stats_reversed"] > PE_HET_AUX_WORST,
          f"phase 21 (c): the limits do not separate the schedule faults' "
          f"readings {faults}")
    res["summary"] = {
        "pipe_tower": res["a"], "moe_tower": res["b"],
        "inception_pipeline": res["c"],
        "worker_parts_s": [w["parts_s"] for w in workers],
        "reference_parts_s": ref["parts_s"], "card": card}
    log("pipe_expert: " + json.dumps(res["summary"]))
    log("phase 21 ok: the tower's layers pipelined over two workers, the "
        "MoE tower on an expert mesh, Inception-ResNet-v2 as 4 pipelined "
        "stages")
    return res


# -------------------------------------------------------------- main
# ----------------------------------------------------------- phase 22
BUNDLE_PAGES = 256
BUNDLE_PAGE_BUCKETS = (8, 40)      # a 512-token prompt and 32 new tokens
BUNDLE_PROMPT_LENS = (32, 128, 320, 512)
BUNDLE_DECODE_NEW = 32
BUNDLE_SERVE_BATCHES = (1, 8)
BUNDLE_SEED = 22
BUNDLE_DEVICE = "cuda"
BUNDLE_WORKER_TIMEOUT = 300        # each worker's part, after its go
BUNDLE_GO_TIMEOUT = 1150
FAULT_ROWS = 1024
FAULT_WIDTHS = (784, 128, 64, 10)  # the examples' MLP (mlp.py, get_mlp)
FAULT_BATCH = 64                   # 16 batches an epoch
FAULT_EPOCHS = 3
FAULT_KILL_STEP = 24               # epoch 1, after its 8th batch
FAULT_LR = 0.1


def _bundle_config():
    return {"device": BUNDLE_DEVICE, "parent": os.getpid(),
            "decode_new": BUNDLE_DECODE_NEW,
            "serve_batches": list(BUNDLE_SERVE_BATCHES),
            "fault": {"rows": FAULT_ROWS, "widths": list(FAULT_WIDTHS),
                      "batch": FAULT_BATCH, "epochs": FAULT_EPOCHS,
                      "kill_step": FAULT_KILL_STEP, "lr": FAULT_LR,
                      "seed": BUNDLE_SEED}}


def _worker_env(drop_nvcc):
    """The environment of a phase 22 worker: no disk root of the exec
    cache; for the restore worker no nvcc on PATH and no CUDA_HOME; for
    the fault workers the cuBLAS workspace deterministic algorithms
    need."""
    env = dict(os.environ)
    env.pop("MXNET_EXEC_CACHE_DIR", None)
    env["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    if drop_nvcc:
        for var in ("CUDA_HOME", "CUDA_PATH"):
            env.pop(var, None)
        env["PATH"] = os.pathsep.join(
            d for d in env.get("PATH", "").split(os.pathsep)
            if d and not os.path.exists(os.path.join(d, "nvcc")))
    return env


def _start_bundle_workers():
    """Phase 22's three workers, started with the script at a lower
    priority: each waits for the go to import (given after phase 1's
    builds, which the host's cores are busy with), imports, and waits
    for its phase 22 go. The restore worker runs this script's copy
    beside a copy of mxnet_tpu_torch/ with no _build/, and the two fault
    workers run fit_auto_resume (one killed, one resuming). Returns
    (processes, their directory)."""
    import shutil

    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="chip_smoke_bundles_")
    atexit.register(shutil.rmtree, out, True)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(_bundle_config(), f)
    pkg = os.path.join(out, "pkg")
    shutil.copytree(os.path.join(root, "mxnet_tpu_torch"),
                    os.path.join(pkg, "mxnet_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.abspath(__file__), pkg)
    procs = {}
    for name, cmd, cwd, env in (
            ("restore", [os.path.join(pkg, "chip_smoke.py"),
                         "--restore-worker", out], pkg, _worker_env(True)),
            ("kill", [os.path.abspath(__file__), "--fault-worker", out,
                      "kill"], root, _worker_env(False)),
            ("resume", [os.path.abspath(__file__), "--fault-worker", out,
                        "resume"], root, _worker_env(False))):
        procs[name] = subprocess.Popen(
            [sys.executable, *cmd], cwd=cwd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
    atexit.register(_stop_bundle_workers, procs)
    return procs, out


def _stop_bundle_workers(procs):
    import signal

    for proc in procs.values():
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.communicate()


def _wait_go(out, name, cfg):
    t = time.perf_counter()
    go = os.path.join(out, name)
    while not os.path.exists(go):
        check(time.perf_counter() - t < BUNDLE_GO_TIMEOUT,
              f"phase 22's parent never wrote {name}")
        try:
            os.kill(cfg["parent"], 0)
        except ProcessLookupError:
            fail("the script that started this worker has ended")
        time.sleep(0.02)
    return time.perf_counter() - t


def _go(out, name):
    with open(os.path.join(out, name), "w"):
        pass


def _finish_worker(proc, name):
    try:
        stdout, stderr = proc.communicate(timeout=BUNDLE_WORKER_TIMEOUT)
    except subprocess.TimeoutExpired:
        _stop_bundle_workers({name: proc})
        fail(f"phase 22's {name} worker did not finish in "
             f"{BUNDLE_WORKER_TIMEOUT} s")
    return proc.returncode, stdout, stderr


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _restore_worker(out):
    """Phase 22 (c), in a fresh process: this script's copy beside a
    copy of the package with no _build/, no nvcc reachable. Restores both
    bundles through ModelServer.load_bundle after the go, serves the
    parent's inputs and writes what it counted into out/restore.json and
    its outputs into out/restore.npz."""
    os.nice(10)
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    _wait_go(out, "go-import", cfg)
    t_start = time.perf_counter()
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import exec_cache, kernels, passes
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.decoding import attention
    from mxnet_tpu_torch.profiling import device_stats

    here = os.path.dirname(os.path.abspath(__file__))
    check(os.path.dirname(os.path.abspath(mx.__file__))
          == os.path.join(here, "mxnet_tpu_torch"),
          f"the restore worker imported {mx.__file__}, not its copy")
    check(not os.path.exists(kernels.BUILD_DIR),
          f"the package's copy has a {kernels.BUILD_DIR}")

    def no_nvcc():
        raise MXNetError("the restore worker runs no nvcc")

    kernels.nvcc_path = no_nvcc
    if cfg["device"] != "cpu":
        # the card's context, cuDNN and cuBLAS, as any process's start
        # pays them (counted in start_s, before the go)
        x = torch.ones(1, 3, 8, 8, device="cuda")
        torch.nn.functional.conv2d(x, torch.ones(4, 3, 3, 3, device="cuda"))
        x.flatten(1) @ torch.ones(192, 4, device="cuda")
        torch.cuda.synchronize()
    res = {"start_s": time.perf_counter() - t_start}
    res["wait_s"] = _wait_go(out, "go-restore", cfg)
    with open(os.path.join(out, "restore-config.json")) as f:
        job = json.load(f)
    inputs = np.load(os.path.join(out, "inputs.npz"))
    ctx = mx.cpu() if cfg["device"] == "cpu" else mx.gpu(0)
    t0 = time.perf_counter()
    server = mx.serving.ModelServer(max_batch=max(cfg["serve_batches"]))
    try:
        with ctx:
            served = server.load_bundle(job["served"])
        res["served_ready_s"] = time.perf_counter() - t0
        outs = {}
        for b in cfg["serve_batches"]:
            outs[f"served{b}"] = np.asarray(served.infer(
                {"data": inputs["images"][:b]}, b, 0)[0])
        res["served_first_answer_s"] = time.perf_counter() - t0
        served_stats = exec_cache.cache_stats()
        t1 = time.perf_counter()
        with ctx:
            lm = server.load_bundle(job["decoded"])
        res["decoder_ready_s"] = time.perf_counter() - t1
        res["decoder_traces"] = lm.engine.traces()
        prompts = [list(map(int, inputs[f"prompt{i}"]))
                   for i in range(len(job["prompt_lens"]))]
        streams = []
        for i, p in enumerate(prompts):
            streams.append(lm.generate(p, max_new_tokens=cfg["decode_new"],
                                       timeout=600))
            if i == 0:
                res["decoder_first_stream_s"] = time.perf_counter() - t1
        res["streams"] = streams
        res["decoder_traces_after"] = lm.engine.traces()
        res["kv_dtype"] = lm.engine.kv_dtype
    finally:
        server.stop()
    s = exec_cache.cache_stats()
    stats = device_stats()
    totals = stats.get("totals", {})
    recs = stats.get("executables", {}).values()
    res.update({
        # bind plans built here (a restored one is a disk load), and the
        # decoder's graphs captured at warmup (a graph is not serialized)
        "bind_builds": sum(r["executables"] - r.get("disk_loads", 0)
                           for r in recs if r["kind"] == "bind"),
        "bind_restore_s": sum(r["compile_s"] for r in recs
                              if r["kind"] == "bind"),
        "graph_captures": sum(r["executables"] for r in recs
                              if r["kind"] != "bind"),
        "traces": s["traces"], "misses": s["misses"],
        "disk_hits": s["disk_hits"], "disk_stale": s["disk_stale"],
        "disk_quarantined": s["disk_quarantined"],
        "exe_loads": s["exe_loads"],
        "served_binds": len(served._by_bucket),
        "served_disk_hits": served_stats["disk_hits"],
        "compiles": totals.get("compiles", 0),
        "disk_loads": totals.get("disk_loads", 0),
        "nvcc_runs": kernels.nvcc_runs(),
        "loaded": kernels.loaded(),
        "codegen_launches": passes.launch_counts(),
        "paged_launches": attention.launch_counts(),
        "process_s": time.perf_counter() - t_start})
    np.savez(os.path.join(out, "restore.npz"), **outs)
    with open(os.path.join(out, "restore.json"), "w") as f:
        json.dump(res, f)


def _fault_arrays(fc):
    rs = np.random.RandomState(fc["seed"])
    x = rs.rand(fc["rows"], fc["widths"][0]).astype(np.float32)
    w = rs.randn(fc["widths"][0], fc["widths"][-1]).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    return x, y


def _fault_net(mx, widths):
    h = mx.sym.Variable("data")
    for i, n in enumerate(widths[1:]):
        h = mx.sym.FullyConnected(h, num_hidden=n, name=f"fc{i + 1}")
        if i < len(widths) - 2:
            h = mx.sym.Activation(h, act_type="relu", name=f"relu{i + 1}")
    return mx.sym.SoftmaxOutput(h, name="softmax")


def _fault_fit(mx, fault, data, fc, ctx, arrays, prefix, log_path, spec):
    """fit_auto_resume of the MLP over a seeded data pipeline with the
    resume protocol; each batch's sha1 appended to `log_path` as it is
    taken (so a killed run leaves its log). Returns the parameters."""
    import hashlib

    x, y = arrays

    class Logged:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def __iter__(self):
            return self

        def __next__(self):
            return self.next()

        def next(self):
            b = self._inner.next()
            with open(log_path, "a") as f:
                f.write(hashlib.sha1(
                    b.data[0].asnumpy().tobytes()).hexdigest() + "\n")
                f.flush()
            return b

    mx.random.seed(fc["seed"])
    it = Logged(data.make_pipeline(x, fc["batch"], label=y, ctx=ctx,
                                   seed=fc["seed"], shard_id=0,
                                   num_shards=1))
    mod = mx.mod.Module(_fault_net(mx, fc["widths"]), context=ctx)
    try:
        fault.fit_auto_resume(
            mod, it, prefix, num_epoch=fc["epochs"],
            fault_injector=fault.FaultInjector(spec), optimizer="sgd",
            optimizer_params={"learning_rate": fc["lr"]})
    finally:
        it._inner.close()
    arg, aux = mod.get_params()
    return {k: v.asnumpy() for k, v in {**arg, **aux}.items()}


def _fault_worker(out, mode):
    """Phase 22 (d), one of two fresh processes with deterministic
    algorithms: "kill" runs fit_auto_resume until kill:step:N takes it
    down by SIGKILL (its finally and atexit markers must not print);
    "resume", meanwhile, runs the uninterrupted reference and the same
    schedule with the 'step:N' exception in place of the kill and a
    resume in this process, then, after the parent's word that the kill
    happened, resumes the killed run from its files."""
    os.nice(10)
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    fc = cfg["fault"]
    _wait_go(out, "go-import", cfg)
    import torch

    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.allow_tf32 = False
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import data, fault

    arrays = _fault_arrays(fc)
    ctx = mx.cpu() if cfg["device"] == "cpu" else mx.gpu(0)
    killed = os.path.join(out, "fault-killed")
    _wait_go(out, "go-fault", cfg)
    if mode == "kill":
        atexit.register(lambda: print("ATEXIT-RAN", flush=True))
        try:
            _fault_fit(mx, fault, data, fc, ctx, arrays,
                       os.path.join(killed, "run"),
                       os.path.join(out, "log-kill.txt"),
                       f"kill:step:{fc['kill_step']}")
        finally:
            print("FINALLY-RAN", flush=True)
        print("SURVIVED", flush=True)
        return
    res, params = {}, {}
    t = time.perf_counter()
    params["ref"] = _fault_fit(mx, fault, data, fc, ctx, arrays,
                               os.path.join(out, "fault-ref", "run"),
                               os.path.join(out, "log-ref.txt"), "")
    res["reference_s"] = time.perf_counter() - t
    t = time.perf_counter()
    raised = os.path.join(out, "fault-raise", "run")
    try:
        _fault_fit(mx, fault, data, fc, ctx, arrays, raised,
                   os.path.join(out, "log-raise.txt"),
                   f"step:{fc['kill_step']}")
        fail("the 'step:N' fault did not fire")
    except RuntimeError as e:
        check("fault-injection" in str(e), f"unexpected error {e}")
    params["raise"] = _fault_fit(mx, fault, data, fc, ctx, arrays, raised,
                                 os.path.join(out, "log-raise.txt"), "")
    res["raise_resume_s"] = time.perf_counter() - t
    _wait_go(out, "go-resume", cfg)
    t = time.perf_counter()
    params["resume"] = _fault_fit(mx, fault, data, fc, ctx, arrays,
                                  os.path.join(killed, "run"),
                                  os.path.join(out, "log-resume.txt"), "")
    res["resume_s"] = time.perf_counter() - t
    np.savez(os.path.join(out, "fault.npz"),
             **{f"{k}:{n}": v for k, p in params.items()
                for n, v in p.items()})
    with open(os.path.join(out, "fault.json"), "w") as f:
        json.dump(res, f)


def _start_fault(out):
    """(d), first half: go to both fault workers (the kill run and the
    references run beside (a) and (b))."""
    for name in ("fault-killed", "fault-ref", "fault-raise"):
        os.makedirs(os.path.join(out, name), exist_ok=True)
    _go(out, "go-fault")


def _bundle_fault(out, procs, fc):
    """(d), second half: the kill worker must have died by SIGKILL with
    no teardown, leaving the data state at its step; then the resume
    worker resumes its files. The logs and parameters they leave,
    against each other."""
    import signal

    from mxnet_tpu_torch import data, fault

    t_wait = time.perf_counter()
    prefix = os.path.join(out, "fault-killed", "run")
    rc, stdout, stderr = _finish_worker(procs["kill"], "kill")
    check(rc == -signal.SIGKILL,
          f"the kill worker ended with {rc}, not -SIGKILL: {stderr[-3000:]}")
    for marker in ("FINALLY-RAN", "ATEXIT-RAN", "SURVIVED"):
        check(marker not in stdout, f"the killed worker printed {marker}")
    per_epoch = fc["rows"] // fc["batch"]
    state = data.read_state(fault.data_state_path(prefix))
    check(state is not None and state["epoch"]
          == fc["kill_step"] // per_epoch
          and state["position"] == fc["kill_step"] % per_epoch,
          f"data state after the kill {state}")
    check(fault.latest_checkpoint(prefix) == fc["kill_step"] // per_epoch,
          f"checkpoint after the kill {fault.latest_checkpoint(prefix)}")
    _go(out, "go-resume")
    rc, stdout, stderr = _finish_worker(procs["resume"], "resume")
    check(rc == 0, f"the resume worker failed: {stderr[-3000:]}")
    with open(os.path.join(out, "fault.json")) as f:
        res = json.load(f)

    def log(name):
        with open(os.path.join(out, f"log-{name}.txt")) as f:
            return f.read().split()

    logs = {n: log(n) for n in ("kill", "resume", "ref", "raise")}
    check(len(logs["kill"]) == fc["kill_step"],
          f"the killed run took {len(logs['kill'])} batches")
    check(logs["kill"] + logs["resume"] == logs["ref"],
          "killed + resumed batches are not the uninterrupted run's")
    check(logs["raise"] == logs["ref"],
          "the in-process raise and resume took other batches")
    z = np.load(os.path.join(out, "fault.npz"))
    names = sorted(k.split(":", 1)[1] for k in z.files
                   if k.startswith("ref:"))
    same = all(np.array_equal(z[f"resume:{n}"], z[f"raise:{n}"])
               for n in names)
    check(same, "the resumed parameters differ from the same schedule run "
          "without a kill")
    lost = max(float(np.abs(z[f"resume:{n}"] - z[f"ref:{n}"]).max()
                   / max(float(np.abs(z[f"ref:{n}"]).max()), 1e-30))
               for n in names)
    res.update({"killed_rc": -signal.SIGKILL,
                "batches_killed": len(logs["kill"]),
                "batches_resumed": len(logs["resume"]),
                "batches_uninterrupted": len(logs["ref"]),
                "resume_vs_same_schedule": 0.0,
                "resume_vs_uninterrupted_rel": lost,
                "after_restore_s": time.perf_counter() - t_wait})
    return res


def phase_bundles(torch, mx, served, decoder, cfg, card, workers,
                  images, one_shot_parts, build_s):
    """Phase 22 (module docstring): bundles of phase 16's warm served
    model and of an int8 decoder at the serving width, restored in a
    fresh process that builds no plan and runs no nvcc; fit_auto_resume
    killed by SIGKILL and resumed."""
    import shutil

    from mxnet_tpu_torch import decoding as dec
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.serving import bundle as sb
    from mxnet_tpu_torch.serving import quant as sq

    procs, out = workers
    timing = {}
    part = _parts(timing)
    res = {}
    tmp = os.path.join(out, "bundles")
    os.makedirs(tmp)
    dev = torch.device(BUNDLE_DEVICE)
    saved_cudnn = (torch.backends.cudnn.deterministic,
                   torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    # (d)'s runs are small: they go beside (a) and (b), on their own
    _start_fault(out)
    try:
        # (a) save: the served model as phase 16 warmed it
        t = time.perf_counter()
        served_dir = sb.save_bundle(served, os.path.join(tmp, "irv2"))
        res["served_save_s"] = time.perf_counter() - t
        part("save_served")
        # the int8 decoder at the serving width, on phase 16's weights
        t = time.perf_counter()
        lm = dec.DecodedModel(
            "lm8", 1, decoder, cfg, max_batch=2, num_pages=BUNDLE_PAGES,
            page_buckets=BUNDLE_PAGE_BUCKETS, kv_dtype="int8",
            prefix_cache=False, device=dev)
        res["decoder_warmup_s"] = time.perf_counter() - t
        res["decoder_traces_parent"] = lm.engine.traces()
        part("decoder_warmup")
        try:
            t = time.perf_counter()
            decoded_dir = sb.save_bundle(lm, os.path.join(tmp, "lm8"),
                                         quantize="int8")
            res["decoded_save_s"] = time.perf_counter() - t
            part("save_decoded")
            for key, path in (("served", served_dir),
                              ("decoded", decoded_dir)):
                manifest = sb.read_manifest(path)
                with np.load(os.path.join(path, sb.PARAMS)) as z:
                    stored = {k: z[k] for k in z.files}
                t = time.perf_counter()
                digest = sb.param_content_hash(stored)
                check(digest == manifest["params"]["content_hash"],
                      f"{key} bundle's content hash")
                res[key] = {
                    "bytes": _dir_bytes(path),
                    "params_bytes": os.path.getsize(
                        os.path.join(path, sb.PARAMS)),
                    "exec_cache_bytes": _dir_bytes(
                        os.path.join(path, sb.EXEC_CACHE)),
                    "hash_s": time.perf_counter() - t,
                    "content_hash": digest,
                    "programs": len(manifest["programs"]),
                    "libraries": sorted({p["kind"] for p in
                                         manifest["programs"]
                                         if p["kind"] != "record"})}
                if key == "decoded":
                    qrec = manifest["quantization"]
                    deq = sq.dequantize_params(stored, qrec)
            f32_bytes = 4 * sum(p.numel() for p in decoder.parameters())
            res["decoded"]["float32_weights_bytes"] = f32_bytes
            res["decoded"]["params_over_float32"] = \
                res["decoded"]["params_bytes"] / f32_bytes
            check(res["decoded"]["params_bytes"] < 0.3 * f32_bytes,
                  f"the int8 bundle's params.npz "
                  f"{res['decoded']['params_bytes']} B is not about a "
                  f"quarter of the float32 weights' {f32_bytes} B")
            check(len(res["served"]["libraries"]) > 0
                  and res["decoded"]["libraries"] == ["paged_attention"],
                  f"the bundles' libraries {res['served']['libraries']} "
                  f"{res['decoded']['libraries']}")
            part("hash")

            # (b) the parent's reference outputs
            rs = np.random.RandomState(BUNDLE_SEED)
            prompts = [rs.randint(2, cfg.vocab, size=n).tolist()
                       for n in BUNDLE_PROMPT_LENS]
            feeds = {"images": images[:max(BUNDLE_SERVE_BATCHES)]}
            feeds.update({f"prompt{i}": np.asarray(p, np.int32)
                          for i, p in enumerate(prompts)})
            np.savez(os.path.join(out, "inputs.npz"), **feeds)
            want = {b: np.asarray(served.infer(
                {"data": feeds["images"][:b]}, b, 0)[0])
                for b in BUNDLE_SERVE_BATCHES}
            f32 = [lm.generate(p, max_new_tokens=BUNDLE_DECODE_NEW,
                               timeout=600) for p in prompts]
            original = {n: p.detach().clone() for n, p in
                        lm.engine.model.named_parameters()}
            lm.engine.model.load_flat(deq)   # in place: the graphs read it
            q8 = [lm.generate(p, max_new_tokens=BUNDLE_DECODE_NEW,
                              timeout=600) for p in prompts]
            with torch.no_grad():
                for n, p in lm.engine.model.named_parameters():
                    p.copy_(original[n])
            del original, deq
            agree = sum(a == b for s, r in zip(q8, f32)
                        for a, b in zip(s, r)) / sum(map(len, f32))
            res["int8_weights_top1_agreement"] = agree
            part("references")
        finally:
            lm.close()

        # (c) the restore, in the fresh process
        with open(os.path.join(out, "restore-config.json"), "w") as f:
            json.dump({"served": served_dir, "decoded": decoded_dir,
                       "prompt_lens": list(BUNDLE_PROMPT_LENS)}, f)
        t = time.perf_counter()
        _go(out, "go-restore")
        rc, stdout, stderr = _finish_worker(procs["restore"], "restore")
        res["restore_wall_s"] = time.perf_counter() - t
        check(rc == 0, f"the restore worker failed: {stderr[-4000:]}")
        with open(os.path.join(out, "restore.json")) as f:
            got = json.load(f)
        part("restore")
        check(got["traces"] == 0, f"the restore built {got['traces']} plans")
        check(got["nvcc_runs"] == 0,
              f"the restore ran nvcc {got['nvcc_runs']} times")
        check(got["bind_builds"] == 0
              and got["compiles"] == got["graph_captures"] > 0,
              f"deviceStats: {got['bind_builds']} bind plans built, "
              f"{got['compiles']} compiles, {got['graph_captures']} graph "
              f"captures")
        check(got["served_disk_hits"] >= got["served_binds"] > 0,
              f"disk hits {got['served_disk_hits']} for "
              f"{got['served_binds']} binds")
        check(got["disk_loads"] > 0 and got["disk_stale"] == 0
              and got["disk_quarantined"] == 0,
              f"disk loads {got['disk_loads']}, stale {got['disk_stale']}, "
              f"quarantined {got['disk_quarantined']}")
        roots = [os.path.join(p, sb.EXEC_CACHE) + os.sep
                 for p in (served_dir, decoded_dir)]
        outside = {k: v for k, v in got["loaded"].items()
                   if not any(v.startswith(r) for r in roots)}
        check(got["loaded"] and not outside,
              f"libraries loaded from outside the bundles: {outside}")
        restored = np.load(os.path.join(out, "restore.npz"))
        for b in BUNDLE_SERVE_BATCHES:
            check(np.array_equal(restored[f"served{b}"], want[b]),
                  f"the restored model's batch-{b} outputs differ from the "
                  f"parent's")
        check(got["streams"] == q8,
              "the restored int8 decoder's streams differ from the "
              "parent's on the same dequantized weights")
        check(got["kv_dtype"] == "int8", f"kv dtype {got['kv_dtype']}")
        gen = got["codegen_launches"]
        check(gen.get("elementwise", 0) > 0
              and gen.get("scale_bias_act", 0) > 0
              and got["paged_launches"]["paged_attention_int8"] > 0,
              f"launches in the restore {gen} {got['paged_launches']}")
        check(got["decoder_traces_after"] == got["decoder_traces"],
              "the restored decoder traced after warmup")
        res["restore"] = {k: got[k] for k in (
            "start_s", "served_ready_s", "served_first_answer_s",
            "decoder_ready_s", "decoder_first_stream_s",
            "decoder_traces", "bind_builds", "bind_restore_s",
            "graph_captures",
            "compiles", "traces", "misses", "disk_hits",
            "disk_loads", "exe_loads", "served_binds", "nvcc_runs",
            "codegen_launches", "paged_launches", "process_s")}
        res["restore"]["libraries_loaded"] = sorted(got["loaded"])
        res["cold_start"] = {
            "restore_served_first_answer_s": got["served_first_answer_s"],
            "from_process_start_s": got["start_s"]
            + got["served_first_answer_s"],
            "phase16_load_and_warmup_s": one_shot_parts.get(
                "load_and_warmup"),
            "phase1_build_s": build_s}
        # the served bundle stays for phase 23's predict replica
        shutil.rmtree(decoded_dir, ignore_errors=True)
        res["served_dir"] = served_dir

        # (d) fault: killed by SIGKILL, resumed
        res["fault"] = _bundle_fault(out, procs, _bundle_config()["fault"])
        part("fault")
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = saved_cudnn
    res["parts_s"] = timing["parts_s"]
    res["card"] = card
    log("phase 22 ok: bundles of the served Inception-ResNet-v2 and the "
        "int8 decoder restored in a fresh process with no plan built and "
        "no nvcc run, outputs bit for bit and streams token for token; "
        "fit_auto_resume killed by SIGKILL and resumed")
    return res


# ----------------------------------------------------------- phase 23
FLEET_REPLICAS = 3
FLEET_MAX_BATCH = 8
FLEET_PAGES = 256
FLEET_PAGE_BUCKETS = (24,)     # a 288-token prompt and 64 new tokens: 22
FLEET_PREFIX = 256             # tokens (16 pages) a family shares
FLEET_TAIL = 32                # each request's own tokens after it
FLEET_REQUESTS = 12            # two families, alternating
FLEET_NEW = 64
FLEET_SEED = 2300              # request i samples from seed 2300 + i
FLEET_KILL_AFTER = 256         # tokens out in all before the SIGKILL
FLEET_TIMEOUT = 600
# the predict replica's batcher waits this long for a batch to fill, so
# that (e)'s 8 requests, which reach it one JSON frame at a time (5.3 MB
# each, 2.0-3.0 s for the 8 on the H100 machine), run as phase 22's
# batch of 8
FLEET_PREDICT_WAIT_US = 8_000_000
FLEET_PREDICT_BATCHES = (1, 8)


def _fleet_replica(out, argv):
    """Phase 23's replica process (started through the routers'
    spawn_fn): `mxnet_tpu_torch.fleet.replica.main(argv)`, the router's
    default command's entry point, with phase 22's restore settings
    (cuDNN deterministic, TF32 off, no nvcc); it counts kernel launches
    from its first served request and, at a clean exit (stop or drain),
    writes them with its decode stats to out/<id>.json. The file is
    written when the worker closes its channel: the router kills a
    drained replica as soon as it sees the channel's end."""
    t_start = time.time()
    rid = argv[argv.index("--id") + 1]
    with open(os.path.join(out, f"{rid}.start.json"), "w") as f:
        json.dump({"start": t_start}, f)
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    from mxnet_tpu_torch import kernels, passes
    from mxnet_tpu_torch.base import MXNetError
    from mxnet_tpu_torch.decoding import attention
    from mxnet_tpu_torch.fleet import replica

    def no_nvcc():
        raise MXNetError("a fleet replica runs no nvcc")

    kernels.nvcc_path = no_nvcc
    path = os.path.join(out, f"{rid}.json")
    lock = threading.Lock()

    def write_exit(model):
        res = {"paged_launches": attention.launch_counts(),
               "codegen_launches": passes.launch_counts(),
               "nvcc_runs": kernels.nvcc_runs(),
               "process_s": time.time() - t_start}
        if hasattr(model, "scheduler"):
            snap = model.stats.snapshot()
            res["steps"] = snap["steps"]
            res["decode_tokens"] = snap["decode_tokens"]
        with open(path + ".tmp", "w") as f:
            json.dump(res, f)
        os.replace(path + ".tmp", path)

    run = replica.ReplicaWorker.run

    def counted_run(self):
        attention.reset_launch_counts()
        passes.reset_launch_counts()
        close = self.chan.close

        def close_counted():
            with lock:
                if not os.path.exists(path):
                    write_exit(self.model)
            close()

        self.chan.close = close_counted
        return run(self)

    replica.ReplicaWorker.run = counted_run
    sys.exit(replica.main(argv))


def _fleet_env(predict):
    """A replica's environment: no disk root of the exec cache, no nvcc
    on PATH and no CUDA_HOME (phase 22's restore worker's); the predict
    replica also takes that worker's cuBLAS workspace and a batcher wait
    long enough to collect (e)'s batch of 8."""
    env = _worker_env(True)
    if predict:
        env["MXNET_SERVING_MAX_WAIT_US"] = str(FLEET_PREDICT_WAIT_US)
    else:
        env.pop("CUBLAS_WORKSPACE_CONFIG", None)
    return env


def _fleet_spawner(out, bundle, hb_ms, predict, spawned):
    """A spawn_fn that starts this script as a replica (`_fleet_replica`)
    with the arguments of the router's default command, its output to
    files in `out`; records each spawn's wall time."""
    from mxnet_tpu_torch import gpu
    from mxnet_tpu_torch.fleet.router import replica_command

    def spawn(rid, port):
        argv = replica_command(bundle, port, rid, hb_ms, gpu(0))[3:]
        spawned[rid] = time.time()
        with open(os.path.join(out, f"{rid}.out"), "w") as so, \
                open(os.path.join(out, f"{rid}.err"), "w") as se:
            return subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--fleet-replica", out, *argv],
                env=_fleet_env(predict), stdout=so, stderr=se,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                start_new_session=True)

    return spawn


def _fleet_tails(dirs):
    """The last lines of every replica's stderr (a failed phase names
    them)."""
    tails = []
    for d in dirs.values():
        for name in sorted(os.listdir(d)):
            if name.endswith(".err"):
                with open(os.path.join(d, name)) as f:
                    text = f.read()
                if text.strip():
                    tails.append(f"[{os.path.basename(d)}/{name}] "
                                 f"{text[-1500:]}")
    return " ".join(tails)


def _fleet_exits(d, rids):
    """{replica id: what it wrote at its clean exit, and its start}."""
    exits = {}
    for rid in rids:
        with open(os.path.join(d, f"{rid}.start.json")) as f:
            start = json.load(f)["start"]
        path = os.path.join(d, f"{rid}.json")
        exits[rid] = {"start": start}
        if os.path.exists(path):
            with open(path) as f:
                exits[rid].update(json.load(f))
    return exits


class _FleetWatch:
    """First wall time each replica id appears among a router's live
    handles (its hello), polled every 5 ms on a thread; keyed by
    (router name, replica id)."""

    def __init__(self, routers):
        self.routers = routers
        self.hello = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._poll, daemon=True)
        self._thread.start()

    def _poll(self):
        while not self._stop.wait(0.005):
            now = time.time()
            for r in self.routers:
                with r._lock:
                    rids = list(r._handles)
                for rid in rids:
                    self.hello.setdefault((r.name, rid), now)

    def stop(self):
        self._stop.set()
        self._thread.join(5)


def _fleet_prompts(vocab):
    rs = np.random.RandomState(FLEET_SEED)
    heads = [rs.randint(2, vocab, size=FLEET_PREFIX).tolist()
             for _ in range(2)]
    return [heads[i % 2] + rs.randint(2, vocab, size=FLEET_TAIL).tolist()
            for i in range(FLEET_REQUESTS)]


def _fleet_traffic(router, prompts, samplings, first=None):
    """Submit every request (the first `first` alone, then, once their
    families' prefixes are advertised, the rest) and stream each on its
    own thread. Returns (futures, token lists, first-token times, the
    tokens-out counter, threads)."""
    n = len(prompts)
    toks = [[] for _ in range(n)]
    t_first = [None] * n
    out = {"n": 0}
    lock = threading.Lock()
    futs, threads = [None] * n, []

    def consume(i, t0):
        for tok in futs[i].stream(timeout=FLEET_TIMEOUT):
            if not toks[i]:
                t_first[i] = time.perf_counter() - t0
            toks[i].append(tok)
            with lock:
                out["n"] += 1

    def send(i):
        t0 = time.perf_counter()
        futs[i] = router.submit(prompts[i], max_new_tokens=FLEET_NEW,
                                sampling=samplings[i])
        th = threading.Thread(target=consume, args=(i, t0), daemon=True)
        th.start()
        threads.append(th)

    order = list(range(n))
    if first:
        for i in order[:first]:
            send(i)
        live = [h.id for h in router._candidates()]
        t = time.perf_counter()
        while not all(router.affinity.best(prompts[i], live)[1]
                      >= FLEET_PREFIX // 16 for i in order[:first]):
            check(time.perf_counter() - t < FLEET_TIMEOUT,
                  "the replicas never advertised the families' prefixes")
            time.sleep(0.01)
        order = order[first:]
    for i in order:
        send(i)
    return futs, toks, t_first, out, threads


def _fleet_finish(futs, toks, threads, label):
    for th in threads:
        th.join(FLEET_TIMEOUT)
    check(not any(th.is_alive() for th in threads),
          f"{label}: a stream did not finish")
    errs = [f.exception(timeout=FLEET_TIMEOUT) for f in futs]
    check(not any(errs), f"{label}: failed requests {errs}")
    for f, t in zip(futs, toks):
        check(f.result(timeout=FLEET_TIMEOUT) == t,
              f"{label}: a stream and its result differ")
    return toks


def _served_batches(router):
    """Batches the one-replica fleet's served model has run (its
    ServingStats, fetched from the replica)."""
    (rid,) = router.status()["replicas"]
    return router.replica_stats(rid, timeout=FLEET_TIMEOUT)["stats"][
        "batches"]


def _busiest(router):
    """The live replica holding the most live decodes."""
    with router._lock:
        counts = {}
        for p in router._pending.values():
            if p.kind == "decode" and p.replica_id in router._handles:
                counts[p.replica_id] = counts.get(p.replica_id, 0) + 1
    return max(sorted(counts), key=lambda r: counts[r]), counts


def _wait_until(pred, what, timeout=FLEET_TIMEOUT):
    t = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t < timeout, f"timed out: {what}")
        time.sleep(0.01)


def phase_fleet(torch, mx, served, decoder, cfg, card, out, served_dir,
                images):
    """Phase 23 (module docstring): three decoder replicas restored from
    one float32 bundle behind FleetRouter, a SIGKILL mid-stream, a drain
    through the admin plane, streams against the same requests decoded
    alone in this process; Inception-ResNet-v2 behind a one-replica
    fleet, bit for bit against phase 22's restored outputs."""
    from mxnet_tpu_torch import decoding as dec
    from mxnet_tpu_torch import fleet
    from mxnet_tpu_torch.decoding import SamplingParams
    from mxnet_tpu_torch.fleet.cli import admin_call
    from mxnet_tpu_torch.serving import bundle as sb

    import signal

    timing = {}
    part = _parts(timing)
    res = {}
    dev = torch.device(BUNDLE_DEVICE)
    work = os.path.join(out, "fleet")
    dirs = {"fleet23": os.path.join(work, "decode"),
            "fleet23_predict": os.path.join(work, "predict")}
    for d in dirs.values():
        os.makedirs(d)
    hb_ms = fleet.config.heartbeat_ms()
    # (a) the float32 bundle of phase 3's weights, prefix cache on
    lm = dec.DecodedModel(
        "fleet_lm", 1, decoder, cfg, max_batch=FLEET_MAX_BATCH,
        num_pages=FLEET_PAGES, page_buckets=FLEET_PAGE_BUCKETS,
        kv_dtype="float32", prefix_cache=True, device=dev)
    try:
        t = time.perf_counter()
        lm_dir = sb.save_bundle(lm, os.path.join(work, "lm.bundle"))
        res["save_s"] = time.perf_counter() - t
    finally:
        lm.close()
    del lm
    res["bundle_bytes"] = _dir_bytes(lm_dir)
    part("bundle")
    spawned = {name: {} for name in dirs}
    router = fleet.FleetRouter(
        lm_dir, replicas=FLEET_REPLICAS, name="fleet23",
        spawn_fn=_fleet_spawner(dirs["fleet23"], lm_dir, hb_ms, False,
                                spawned["fleet23"]))
    predictor = fleet.FleetRouter(
        served_dir, replicas=1, name="fleet23_predict",
        spawn_fn=_fleet_spawner(dirs["fleet23_predict"], served_dir, hb_ms,
                                True, spawned["fleet23_predict"]))
    watch = _FleetWatch([router, predictor])
    ref = None
    try:
        t_spawn = time.perf_counter()
        router.start(wait=False)
        predictor.start(wait=False)
        # the references while the replicas restore: each request alone,
        # prefix cache off, on the same weights
        prompts = _fleet_prompts(cfg.vocab)
        samplings = [SamplingParams(seed=FLEET_SEED + i, **SAMPLED)
                     for i in range(FLEET_REQUESTS)]
        ref = dec.DecodedModel(
            "fleet_ref", 1, decoder, cfg, max_batch=FLEET_MAX_BATCH,
            num_pages=FLEET_PAGES, page_buckets=FLEET_PAGE_BUCKETS,
            kv_dtype="float32", prefix_cache=False, device=dev)
        want, ttft_ref = [], None
        for i, p in enumerate(prompts):
            t = time.perf_counter()
            toks = []
            for tok in ref.stream(p, max_new_tokens=FLEET_NEW,
                                  sampling=samplings[i],
                                  timeout=FLEET_TIMEOUT):
                if ttft_ref is None:
                    ttft_ref = time.perf_counter() - t
                toks.append(tok)
            want.append(toks)
        part("references")
        try:
            router.wait_ready(FLEET_REPLICAS, timeout=FLEET_TIMEOUT)
            predictor.wait_ready(1, timeout=FLEET_TIMEOUT)
        except Exception as e:
            fail(f"phase 23's replicas did not start: {e} "
                 f"{_fleet_tails(dirs)}")
        res["ready_s"] = time.perf_counter() - t_spawn
        log(f"fleet: 4 replicas ready {res['ready_s']!r} s after their "
            f"spawn; references {timing['parts_s']['references']!r} s")
        res["hellos"] = {
            f"{r.name}/{rid}": [row["traces"], row["compiles"]]
            for r in (router, predictor)
            for rid, row in sorted(r.status()["replicas"].items())}
        check(all(v == [0, 0] for v in res["hellos"].values()),
              f"a replica's hello reports traces/compiles "
              f"{res['hellos']}")
        part("start")

        # (b) traffic: one request of each family first, then the rest
        t = time.perf_counter()
        futs, got, t_first, n_out, threads = _fleet_traffic(
            router, prompts, samplings, first=2)
        snap = router.stats.snapshot()
        res["routed"] = {k: snap[k] for k in (
            "routed_affinity", "routed_least_loaded",
            "affinity_pages_covered")}
        check(snap["routed_affinity"] >= 8
              and snap["affinity_pages_covered"] >= 8 * FLEET_PREFIX // 16,
              f"affinity routing: {res['routed']}")
        # (c) SIGKILL the replica with the most live decodes mid-stream
        _wait_until(lambda: n_out["n"] >= FLEET_KILL_AFTER,
                    "tokens before the kill")
        victim, live = _busiest(router)
        pid = router.status()["replicas"][victim]["pid"]
        os.kill(pid, signal.SIGKILL)
        res["killed"] = {"replica": victim, "live_decodes": live,
                         "tokens_out": n_out["n"]}
        got_b = _fleet_finish(futs, got, threads, "(b)/(c)")
        res["traffic_b_s"] = time.perf_counter() - t
        res["tokens_per_s_b"] = sum(map(len, got_b)) / res["traffic_b_s"]
        res["ttft_router_s"] = t_first[0]
        res["ttft_in_process_s"] = ttft_ref
        snap = router.stats.snapshot()
        check(snap["replica_deaths"] == 1 and snap["readmissions"] >= 1,
              f"deaths {snap['replica_deaths']}, readmissions "
              f"{snap['readmissions']}")
        router.wait_ready(FLEET_REPLICAS, timeout=FLEET_TIMEOUT)
        rows = router.status()["replicas"]
        for rid, row in rows.items():
            res["hellos"][f"{router.name}/{rid}"] = [row["traces"],
                                                     row["compiles"]]
        check(len(rows) == FLEET_REPLICAS and victim not in rows
              and all(v == [0, 0] for v in res["hellos"].values()),
              f"the heal: {sorted(rows)}, hellos {res['hellos']}")
        res["readmissions"] = snap["readmissions"]
        part("traffic_kill")
        log(f"fleet: (b)/(c) {res['traffic_b_s']!r} s, killed "
            f"{res['killed']}, healed in {timing['parts_s']['traffic_kill']!r}"
            f" s of traffic and heal")

        # (d) the same traffic again; drain the busiest replica through
        # the admin plane once tokens flow
        addr = f"127.0.0.1:{router.port}"
        t = time.perf_counter()
        futs, got, _, n_out, threads = _fleet_traffic(router, prompts,
                                                      samplings)
        _wait_until(lambda: n_out["n"] >= FLEET_REQUESTS,
                    "tokens before the drain")
        drained, live = _busiest(router)
        drain = admin_call(addr, "drain", replica=drained, timeout_ms=0)
        got_d = _fleet_finish(futs, got, threads, "(d)")
        res["traffic_d_s"] = time.perf_counter() - t
        res["tokens_per_s_d"] = sum(map(len, got_d)) / res["traffic_d_s"]
        res["drained"] = {"replica": drained, "live_decodes": live,
                          "handoffs": drain["handoffs"]}
        check(drain["handoffs"] >= 1, f"the drain handed off {drain}")
        _wait_until(lambda: drained not in router.status()["replicas"],
                    "the drained replica's exit")
        time.sleep(3 * hb_ms / 1e3)       # a heal would have started
        survivors = sorted(admin_call(addr, "status")["replicas"])
        snap = router.stats.snapshot()
        check(len(survivors) == FLEET_REPLICAS - 1
              and drained not in survivors
              and snap["replica_deaths"] == 1 and snap["handoffs"] >= 1
              and router.ledger.snapshot()["drains_escalated"] == 0,
              f"after the drain: survivors {survivors}, {snap}")
        res["survivors"] = survivors
        res["stats"] = {k: v for k, v in snap.items() if k != "replicas"}
        part("traffic_drain")
        log(f"fleet: (d) {res['traffic_d_s']!r} s, drained "
            f"{res['drained']}")
        router.stop()

        # the streams against the references: exact, or a counted near
        # tie on a replica whose prefix cache was hit
        ties = _divergences(ref.engine, prompts, got_b + got_d,
                            want + want, samplings + samplings,
                            "fleet streams vs each request alone")
        res["near_ties"] = len(ties)
        part("streams")

        # (e) one-shot predict through the one-replica fleet
        restored = np.load(os.path.join(out, "restore.npz"))
        pred = {}
        for b in FLEET_PREDICT_BATCHES:
            rows_out = [None] * b

            def one(i):
                rows_out[i] = predictor.predict(
                    {"data": images[i]}, timeout=FLEET_TIMEOUT)

            batches0 = _served_batches(predictor)
            t = time.perf_counter()
            ths = [threading.Thread(target=one, args=(i,), daemon=True)
                   for i in range(b)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(FLEET_TIMEOUT)
            fleet_ms = (time.perf_counter() - t) * 1e3
            check(all(r is not None for r in rows_out),
                  f"predict at batch {b} did not answer")
            flushes = _served_batches(predictor) - batches0
            check(flushes == 1, f"the replica ran the {b} requests as "
                  f"{flushes} batches, not as one of {b}")
            got_rows = np.stack([np.asarray(r[0], np.float32)
                                 for r in rows_out])
            check(np.array_equal(got_rows, restored[f"served{b}"]),
                  f"predict through the fleet at batch {b} differs from "
                  f"phase 22's restored outputs")
            t = time.perf_counter()
            np.asarray(served.infer({"data": images[:b]}, b, 0)[0])
            pred[b] = {"fleet_ms": fleet_ms,
                       "in_process_ms": (time.perf_counter() - t) * 1e3,
                       "request_json_bytes": b * len(json.dumps(
                           images[0].tolist(), separators=(",", ":")))}
        res["predict"] = pred
        res["predict_batcher_wait_ms"] = FLEET_PREDICT_WAIT_US / 1e3
        part("predict")
        predictor.stop()
    finally:
        watch.stop()
        router.stop()
        predictor.stop()
        if ref is not None:
            ref.close()
    # what the replicas counted at their clean exits
    dexits = _fleet_exits(dirs["fleet23"], spawned["fleet23"])
    pexits = _fleet_exits(dirs["fleet23_predict"],
                          spawned["fleet23_predict"])
    killed = res["killed"]["replica"]
    b4 = {}
    for rid, e in dexits.items():
        if rid == killed:
            check("steps" not in e, f"the killed replica {rid} wrote {e}")
            continue
        check("steps" in e, f"replica {rid} did not exit cleanly "
              f"{_fleet_tails(dirs)}")
        n = e["paged_launches"]["paged_attention_float"]
        b4[rid] = {"launches": n, "steps": e["steps"]}
        check(n == cfg.n_layers * e["steps"],
              f"replica {rid} launched B4 {n} times in {e['steps']} decode "
              f"steps of {cfg.n_layers} layers")
        check(e["nvcc_runs"] == 0, f"replica {rid} ran nvcc")
    check(sum(v["steps"] for v in b4.values()) > 0, f"no decode step {b4}")
    (pexit,) = pexits.values()
    check("codegen_launches" in pexit,
          f"the predict replica did not exit cleanly {_fleet_tails(dirs)}")
    gen = pexit["codegen_launches"]
    check(gen.get("elementwise", 0) > 0 and gen.get("scale_bias_act", 0) > 0
          and pexit["nvcc_runs"] == 0,
          f"the predict replica's B1/B2 launches {gen}, nvcc runs "
          f"{pexit['nvcc_runs']}")
    res["launches"] = {"b4_by_replica": b4,
                       "b4": sum(v["launches"] for v in b4.values()),
                       "b1": gen.get("elementwise", 0),
                       "b2": gen.get("scale_bias_act", 0)}
    res["hello_s"] = {}
    for name, exits in (("fleet23", dexits), ("fleet23_predict", pexits)):
        for rid, e in exits.items():
            hello = watch.hello.get((name, rid))
            if hello is not None:
                res["hello_s"][f"{name}/{rid}"] = {
                    "from_spawn": hello - spawned[name][rid],
                    "from_process_start": hello - e["start"]}
    res["parts_s"] = timing["parts_s"]
    res["card"] = card
    log("phase 23 ok: three decoder replicas and the heal's replacement "
        "restored from one bundle with no trace and no compile, a SIGKILL "
        "and a drain mid-stream with no request lost, streams equal to "
        "each request alone, predict through a one-replica fleet bit for "
        "bit")
    return res


def _kernel_line(rows, launches_float, launches_int8, spec_launches,
                 ring_launches):
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
    # phase 20's decode arm: the decode steps after ring-attention prefill
    out[0]["launches_ring_prefill"] = ring_launches
    return out


# the Pallas kernels the generated CUDA kernels replace
_CODEGEN_REPLACES = {
    "elementwise": "mxnet_tpu/passes/pallas_codegen.py:408",
    "scale_bias_act": "mxnet_tpu/passes/pallas_codegen.py:444",
    "reduction": "mxnet_tpu/passes/pallas_codegen.py:455",
}


def _codegen_line(template_rows, train_rows, train_launches,
                  executor_launches, pipeline_launches):
    """B1 and B2 at the training shapes (for B2 the group with the most
    launches per step), launched on the training path (and, as
    `launches_pipeline`, on phase 18's fit from RecordIO); B3 at the
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
        if template != "reduction":
            out[-1]["launches_pipeline"] = pipeline_launches[template]
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


# ----------------------------------------------------------- phase 24
ELASTIC_ROWS = 1024            # 8 global steps an epoch at 2 x 64
ELASTIC_BATCH = 64
ELASTIC_SHARDS = 2
ELASTIC_EPOCHS = 2
ELASTIC_SEED = 24
ELASTIC_KILL_STEP = 6          # (b)'s victim: SIGKILL after its 6th step
ELASTIC_JOIN_STEP = 5          # (c)'s joiner dials once 5 steps are done
ELASTIC_DEVICE = "gpu"         # the agents' --ctx
ELASTIC_TIMEOUT = 180
ELASTIC_ENTRY = "chip_smoke:elastic_lenet_job"


def elastic_lenet_job(config=None):
    """Phase 24's job, in the elastic ci_job convention (a config dict
    to a JobSpec, built alike in every process that resolves it): LeNet
    (models/lenet.py) at its published width, 1x28x28 inputs, 10
    classes, over ELASTIC_ROWS seeded synthetic images; micro-batch 64
    over 2 logical shards, 2 epochs, momentum SGD (lr 0.001: the
    SoftmaxOutput gradient is summed over the micro-batch's 64 rows). In
    a process whose
    environment names CHIP_SMOKE_ELASTIC_PROBE (phase 24's agents), the
    ModuleStepper writes what it computed with to
    $CHIP_SMOKE_ELASTIC_PROBE/<pid>.json (`_elastic_probe`)."""
    from mxnet_tpu_torch.elastic.trainer import JobSpec
    from mxnet_tpu_torch.models import get_lenet

    c = {"rows": ELASTIC_ROWS, "batch_size": ELASTIC_BATCH,
         "logical_shards": ELASTIC_SHARDS, "epochs": ELASTIC_EPOCHS,
         "seed": ELASTIC_SEED, "lr": 0.001, "momentum": 0.9}
    c.update(config or {})
    rs = np.random.RandomState(int(c["seed"]))
    x = rs.uniform(-1.0, 1.0, (int(c["rows"]), 1, 28, 28)).astype(
        np.float32)
    y = rs.randint(0, 10, int(c["rows"])).astype(np.float32)
    if os.environ.get("CHIP_SMOKE_ELASTIC_PROBE"):
        _elastic_probe(os.environ["CHIP_SMOKE_ELASTIC_PROBE"])
    return JobSpec(get_lenet(num_classes=10), x, y,
                   batch_size=c["batch_size"],
                   logical_shards=c["logical_shards"], epochs=c["epochs"],
                   seed=c["seed"], lr=c["lr"], momentum=c["momentum"])


def _elastic_probe(out):
    """In an agent's process: after each micro-batch's gradients,
    out/<pid>.json holds the device types of the parameters the
    executor computes with, the exec cache's traces after the warmup
    micro-batch (the stepper's first) and now, and the micro-batches
    run."""
    from mxnet_tpu_torch import exec_cache
    from mxnet_tpu_torch.elastic import trainer

    if getattr(trainer.ModuleStepper.grads, "probed", False):
        return
    orig = trainer.ModuleStepper.grads
    rec = {"pid": os.getpid(), "grads": 0}

    def grads(self, x, y):
        g = orig(self, x, y)
        rec["grads"] += 1
        rec["traces"] = int(exec_cache.cache_stats()["traces"])
        rec.setdefault("traces_after_warmup", rec["traces"])
        rec["devices"] = sorted({t.device.type for t in
                                 self.device_params().values()})
        path = os.path.join(out, f"{os.getpid()}.json")
        with open(path + ".tmp", "w") as f:
            json.dump(rec, f)
        os.replace(path + ".tmp", path)
        return g

    grads.probed = True
    trainer.ModuleStepper.grads = grads


def _elastic_coordinator(name, initial_world, workdir, config):
    """An ElasticCoordinator that stamps each phase change of its step
    engine (`_set_phase_locked`, the one writer of the phase, runs under
    the coordinator's lock): entering "slices" is the moment every
    shard's gradients are in; leaving it, a step has completed."""
    from mxnet_tpu_torch.elastic import ElasticCoordinator

    class Timed(ElasticCoordinator):
        def _set_phase_locked(self, phase):
            stamps = self.__dict__.setdefault("stamps", [])
            stamps.append((time.perf_counter(), self._phase, phase,
                           self._step, self._gen))
            super()._set_phase_locked(phase)

    return Timed(ELASTIC_ENTRY, config, name=name, workdir=workdir,
                 initial_world=initial_world).start()


def _elastic_step_times(stamps):
    """Per completed step (within one generation): its ms from the last
    completion, the ms until every shard's gradients were in, and the ms
    from there to the completion."""
    out = []
    last = None
    grads_in = None
    done = 0
    for t, old, new, step, gen in stamps:
        if new == "slices":
            grads_in = t
        elif old == "slices" and step > done:
            done = step
            if last is not None and last[1] == gen and grads_in:
                out.append({"step": step, "ms": (t - last[0]) * 1e3,
                            "grads_ms": (grads_in - last[0]) * 1e3,
                            "update_ms": (t - grads_in) * 1e3})
            last = (t, gen)
        elif new == "grads" and old in ("forming", "quiesce", "boundary",
                                        "parked"):
            last = (t, gen)
    return out


def _elastic_audit(spec, logs):
    """Every (epoch, shard, step) batch of the job in `logs` exactly once,
    each with the one-member sampler's indices: the number of lines."""
    seen = {}
    for path in logs:
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                key = (rec["epoch"], rec["shard"], rec["step"])
                check(key not in seen, f"elastic: {key} consumed twice "
                      f"({logs})")
                seen[key] = rec["idx"]
    n = len(seen)
    truth = spec.make_sampler()
    for epoch in range(spec.epochs):
        truth.set_epoch(epoch)
        truth.set_membership(0, 1)
        for p in range(spec.batches_per_epoch):
            for s in range(spec.logical_shards):
                got = seen.pop((epoch, s, p), None)
                check(got == truth.shard_batch(s, p).tolist(),
                      f"elastic: batch {(epoch, s, p)} of {logs} is "
                      f"{'missing' if got is None else 'not the sampler'}"
                      f"'s")
    check(not seen, f"elastic: batches outside the job {sorted(seen)}")
    return n


def _elastic_grads_ms(torch, mx, spec, reps=10):
    """One micro-batch's gradients (forward, backward, the host copy of
    the gradients) on the card in this process, ms p50, with the agents'
    deterministic settings (restored after)."""
    from mxnet_tpu_torch.elastic import trainer

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        stepper = trainer.ModuleStepper(spec, ctx=mx.gpu(0))
        stepper.install(spec.initial_params(spec.param_shapes()))
        x, y = spec.batch_arrays(np.arange(spec.batch_size))
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stepper.grads(x, y)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    return float(np.percentile(ms, 50))


def phase_elastic(torch, mx, card):
    """Phase 24: elastic/ on one H100. A coordinator in this process for
    each of three jobs of LeNet (`elastic_lenet_job`) and the agents as
    real processes (`python -m mxnet_tpu_torch.elastic.agent --ctx gpu`)
    on cuda:0, started together: (a) one worker uninterrupted; (b) two
    workers, one SIGKILLed by its own kill:step:6; (c) one worker, joined
    by a second (warm, held at its start gate) once 5 steps are done.
    (b)'s and (c)'s final parameters must equal (a)'s bit for bit."""
    import shutil
    import signal

    from mxnet_tpu_torch.elastic import stats as estats

    res = {"card": card}
    part = _parts(res)
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    out = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    probe = os.path.join(out, "probe")
    os.makedirs(probe)
    config = {}
    spec = elastic_lenet_job(config)
    env = dict(os.environ)
    env.update(PYTHONPATH=root + os.pathsep + env.get("PYTHONPATH", ""),
               CUBLAS_WORKSPACE_CONFIG=":4096:8",
               CHIP_SMOKE_ELASTIC_PROBE=probe)
    for var in ("MXNET_EXEC_CACHE_DIR", "MXNET_TPU_FAULT_INJECT",
                "MXNET_ELASTIC_LOGICAL_SHARDS", "MXNET_ELASTIC_MIN_WORLD"):
        env.pop(var, None)
    coords = {
        "a": _elastic_coordinator("elastic24_a", 1,
                                  os.path.join(out, "a"), config),
        "b": _elastic_coordinator("elastic24_b", 2,
                                  os.path.join(out, "b"), config),
        "c": _elastic_coordinator("elastic24_c", 1,
                                  os.path.join(out, "c"), config)}
    gate = os.path.join(out, "c1.go")
    ready = os.path.join(out, "c1.ready")
    agents = {"a0": ("a", {}, []), "b0": ("b", {}, []),
              "b1": ("b", {"MXNET_TPU_FAULT_INJECT":
                           f"kill:step:{ELASTIC_KILL_STEP}"}, []),
              "c0": ("c", {}, []),
              "c1": ("c", {}, ["--ready-file", ready, "--start-gate", gate])}
    procs, started, logs = {}, {}, {}
    try:
        for name, (job, extra_env, extra) in agents.items():
            logs[name] = os.path.join(out, f"{name}.jsonl")
            started[name] = time.perf_counter()
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "mxnet_tpu_torch.elastic.agent",
                 "--connect", f"127.0.0.1:{coords[job].port}",
                 "--entry", ELASTIC_ENTRY, "--config", json.dumps(config),
                 "--name", name, "--consumed-log", logs[name],
                 "--ctx", ELASTIC_DEVICE, *extra],
                cwd=root, env=env | extra_env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True, start_new_session=True)
        pid_name = {p.pid: n for n, p in procs.items()}
        hello, gate_at, ready_at = {}, None, None
        deadline = time.perf_counter() + ELASTIC_TIMEOUT
        while not all(c.wait(0) for c in coords.values()):
            now = time.perf_counter()
            check(now < deadline, "elastic: the jobs did not complete in "
                  f"{ELASTIC_TIMEOUT} s: " + json.dumps(
                      {k: c.status() for k, c in coords.items()},
                      default=str)[:4000])
            for job, c in coords.items():
                for m in c.status()["members"]:
                    hello.setdefault(pid_name.get(m["pid"]), now)
            if ready_at is None and os.path.exists(ready):
                ready_at = now
            if (gate_at is None and ready_at is not None
                    and coords["c"].status()["step"] >= ELASTIC_JOIN_STEP):
                with open(gate, "w"):
                    pass
                gate_at = now
            for name, p in procs.items():
                if p.poll() not in (None, 0) and name != "b1":
                    _, err = p.communicate()
                    fail(f"elastic: agent {name} exited {p.returncode}: "
                         f"{err[-3000:]}")
            time.sleep(0.005)
        part("jobs")
        results = {}
        for name, p in procs.items():
            try:
                so, se = p.communicate(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                so, se = p.communicate()
            results[name] = (p.returncode, so, se)
        snaps = {k: estats.elastic_stats()[c._name]
                 for k, c in coords.items()}
        finals = {k: c.final_params() for k, c in coords.items()}
        members = {k: c.status()["members"] for k, c in coords.items()}
        stamps = {k: list(c.stamps) for k, c in coords.items()}
    finally:
        for c in coords.values():
            c.stop()
        for p in procs.values():
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.communicate()
    detail = {n: (rc, se[-1500:]) for n, (rc, _, se) in results.items()}
    check(results["b1"][0] == -signal.SIGKILL,
          f"elastic: (b)'s victim exited {results['b1'][0]}, not -9: "
          f"{detail['b1']}")
    for name, (rc, so, _) in results.items():
        if name == "b1":
            continue
        last = so.strip().splitlines()[-1] if so.strip() else ""
        check(rc == 0 and last == json.dumps({"result": "complete"}),
              f"elastic: agent {name} exited {rc} with {last!r}: "
              f"{detail[name]}")
    # (b) and (c) end where (a) ends, bit for bit
    for job in ("b", "c"):
        for n, v in finals["a"].items():
            check(np.array_equal(v, finals[job][n]),
                  f"elastic: ({job})'s {n} differs from (a)'s by "
                  f"{float(np.abs(v - finals[job][n]).max())!r}")
    init = spec.initial_params(spec.param_shapes())
    moved = {n: float(np.abs(finals["a"][n] - init[n]).max())
             for n in init}
    check(all(v > 0 for v in moved.values()),
          f"elastic: a parameter did not move {moved}")
    lines = {"a": _elastic_audit(spec, [logs["a0"]]),
             "b": _elastic_audit(spec, [logs["b0"], logs["b1"]]),
             "c": _elastic_audit(spec, [logs["c0"], logs["c1"]])}
    with open(logs["b1"]) as f:
        victim_lines = len(f.read().splitlines())
    check(victim_lines == ELASTIC_KILL_STEP,
          f"elastic: the victim logged {victim_lines} batches, not "
          f"{ELASTIC_KILL_STEP} (one shard a step)")
    check(snaps["b"]["transitions_shrink"] == 1
          and snaps["b"]["transitions_grow"] == 0,
          f"elastic: (b) {snaps['b']}")
    check(snaps["c"]["transitions_grow"] == 1
          and snaps["c"]["transitions_shrink"] == 0,
          f"elastic: (c) {snaps['c']}")
    check(snaps["a"]["transitions"] == 0, f"elastic: (a) {snaps['a']}")
    for job, s in snaps.items():
        check(s["digest_mismatches"] == 0,
              f"elastic: ({job}) {s['digest_mismatches']} digest "
              f"mismatches")
        check(s["steps_completed"] == spec.total_steps,
              f"elastic: ({job}) completed {s['steps_completed']} steps")
        if s["transitions"]:
            check(s["reshard_bytes_moved"] < s["reshard_bytes_full_restore"],
                  f"elastic: ({job}) moved {s['reshard_bytes_moved']} "
                  f"bytes, the full restore is "
                  f"{s['reshard_bytes_full_restore']}")
    for job, rows in members.items():
        for row in rows:
            check(row["trace_history"] == [],
                  f"elastic: ({job}) member {row['wid']} traced after its "
                  f"warmup: {row}")
    probes = {}
    for name, p in procs.items():
        path = os.path.join(probe, f"{p.pid}.json")
        check(os.path.exists(path), f"elastic: agent {name} wrote no probe")
        with open(path) as f:
            probes[name] = json.load(f)
        check(probes[name]["devices"] == ["cuda"],
              f"elastic: agent {name}'s parameters are on "
              f"{probes[name]['devices']}")
        check(probes[name]["traces"] == probes[name]["traces_after_warmup"],
              f"elastic: agent {name} traced after its warmup "
              f"{probes[name]}")
    part("checks")
    res["grads_ms_p50_in_process"] = _elastic_grads_ms(torch, mx, spec)
    part("grads_in_process")
    steps = {k: _elastic_step_times(v) for k, v in stamps.items()}
    res["step_ms_p50"] = {k: float(np.percentile([s["ms"] for s in v], 50))
                          for k, v in steps.items() if v}
    res["grads_ms_p50"] = {k: float(np.percentile([s["grads_ms"]
                                                   for s in v], 50))
                           for k, v in steps.items() if v}
    res["update_ms_p50"] = {k: float(np.percentile([s["update_ms"]
                                                    for s in v], 50))
                            for k, v in steps.items() if v}
    # (a): one worker computes both shards' micro-batches a step; the
    # rest of its step is the wire, the JSON codec, the coordinator's
    # combine and the owners' update
    res["wire_share_a"] = 1.0 - (spec.logical_shards
                                 * res["grads_ms_p50_in_process"]
                                 / res["step_ms_p50"]["a"])
    res["start_to_hello_s"] = {n: hello[n] - started[n]
                               for n in procs if n in hello}
    res["start_to_ready_s_c1"] = (ready_at - started["c1"]
                                  if ready_at else None)
    res["gate_at_step"] = ELASTIC_JOIN_STEP
    res["quiesce_wall_ms"] = {k: snaps[k]["quiesce_wall_ms_last"]
                              for k in ("b", "c")}
    res["reshard_bytes_moved"] = {k: snaps[k]["reshard_bytes_moved"]
                                  for k in ("b", "c")}
    res["reshard_bytes_full_restore"] = {
        k: snaps[k]["reshard_bytes_full_restore"] for k in ("b", "c")}
    res["examples_rekeyed"] = {k: snaps[k]["examples_rekeyed"]
                               for k in ("b", "c")}
    res["consumed_lines"] = lines
    res["params"] = int(sum(v.size for v in init.values()))
    res["total_steps"] = spec.total_steps
    res["victim_rc"] = results["b1"][0]
    res["moved_from_init_max"] = moved
    res["phase_s"] = time.perf_counter() - t_phase
    shutil.rmtree(out, ignore_errors=True)
    log("elastic: " + json.dumps(res))
    log("phase 24 ok: LeNet trained by elastic agents on the card through "
        "a SIGKILL shrink and a 1->2 re-grow to the uninterrupted run's "
        "parameters, bit for bit")
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number as JSON here")
    ap.add_argument("--dp-worker", metavar="DIR",
                    help="run as one of phase 19's two workers (started "
                    "by the script itself through tools/launch.py), "
                    "writing results into DIR")
    ap.add_argument("--restore-worker", metavar="DIR",
                    help="run as phase 22's restore worker (started by "
                    "the script itself from a copy of the package with no "
                    "_build/), reading and writing DIR")
    ap.add_argument("--fault-worker", nargs=2, metavar=("DIR", "MODE"),
                    help="run as one of phase 22's fit_auto_resume "
                    "workers (MODE kill or resume), started by the script "
                    "itself")
    ap.add_argument("--profile", action="store_true",
                    help="also run torch.profiler over a training step "
                    "(phases 6 and 9) and print where the device time "
                    "goes (phase 3's serving window is profiled in every "
                    "run)")
    if sys.argv[1:2] == ["--fleet-replica"]:
        # phase 23's replica: the rest is the replica's own arguments
        _fleet_replica(sys.argv[2], sys.argv[3:])
        return
    args = ap.parse_args()
    if args.dp_worker:
        _dp_worker(args.dp_worker)
        return
    if args.restore_worker:
        _restore_worker(args.restore_worker)
        return
    if args.fault_worker:
        _fault_worker(*args.fault_worker)
        return
    t_start = time.perf_counter()
    # fresh calibration and tuning files: a record left by an earlier run
    # could change the tuner's choice
    import shutil

    caches = tempfile.mkdtemp(prefix="chip_smoke_caches_")
    atexit.register(shutil.rmtree, caches, True)
    os.environ["MXNET_CALIBRATION_CACHE"] = os.path.join(
        caches, "calibration.json")
    os.environ["MXNET_TUNING_CACHE"] = os.path.join(caches, "tuning.json")
    # the examples' process starts first, beside the imports and phase
    # 1's builds, and is killed on any exit that leaves it running (with
    # no card it fails at once, and so does this script below)
    examples = _start_examples()
    atexit.register(lambda p=examples: p.poll() is None and p.kill())
    # the examples' scripts are host-bound Python (dec_cluster took 11-31
    # s beside the compilers): phase 1's nvcc and source finding run a
    # step below them in priority, and the script returns to its own
    # after phase 1
    os.nice(PHASE1_NICE)
    # phase 19's workers too, at the builds' priority: their imports and
    # batches (about 21 s that phase 19 waited for) run beside phase 1
    dp_workers = _start_dp_workers()
    # and phase 22's: the restore worker and the two fault workers
    bundle_workers = _start_bundle_workers()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs one "
             "CUDA card")
    try:
        import mxnet_tpu_torch as mx
        from mxnet_tpu_torch import decoding as dec
        from mxnet_tpu_torch.kernels import compiled as kernels_compiled
    except ImportError as e:
        fail(f"mxnet_tpu_torch is not importable ({e}); run from the "
             "root of the repository")
    check(not any(m == "jax" or m == "mxnet_tpu" or m.startswith(
        ("jax.", "mxnet_tpu.")) for m in sys.modules),
        "the port imported jax or mxnet_tpu")

    cfg = dec.DecoderConfig(**SERVE_CFG)
    host_weights = {}
    drawer = threading.Thread(target=lambda: host_weights.update(
        flat=dec.init_decoder_params(cfg, seed=0), s=time.perf_counter()))
    t = time.perf_counter()
    drawer.start()
    card, build_s, examples = phase_environment(torch, examples)
    # phase 22's workers import now, beside phase 2's device-timed kernels
    _go(bundle_workers[1], "go-import")
    try:
        os.nice(-PHASE1_NICE)
    except OSError:     # not permitted: the rest of the run has no rival
        pass
    built_ahead = len(kernels_compiled())
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_s": build_s,
              "phase_s": {"environment": time.perf_counter() - t}}

    def run(key, fn, *a, **kw):
        t = time.perf_counter()
        out = report[key] = fn(*a, **kw)
        report["phase_s"][key] = time.perf_counter() - t
        return out

    rows = run("kernel_rows", phase_kernels, torch)
    t = time.perf_counter()
    drawer.join()
    decoder = dec.params_from_jax(host_weights.pop("flat"), cfg,
                                  torch.device("cuda")).eval()
    log(f"weights: {sum(p.numel() for p in decoder.parameters())} "
        f"parameters drawn on the host in a thread during phase 1 (done "
        f"{host_weights['s'] - t_start!r} s into the run), copied to the "
        f"card in {time.perf_counter() - t!r} s")
    run("serving", phase_serving, torch, decoder, cfg, "cuda")
    serving, hot, cold_model = report["serving"]
    report["serving"] = serving
    kv = run("kv_dtypes", phase_kv_dtypes, torch, decoder, cfg, "cuda")
    tier = run("decode_tier", phase_decode_tier, torch, decoder, cfg,
               serving, hot, cold_model)
    # the decoder's weights stay on the card for phase 16
    del cold_model
    torch.cuda.empty_cache()
    codegen = run("codegen", phase_codegen, torch, mx)
    training, groups, trained, train_mod = run(
        "training", phase_training, torch, mx, profile=args.profile)
    report["training"] = training
    train_rows = run("train_kernels", phase_train_kernels, torch, groups,
                     training["launches_per_step_by_digest"])

    def fused_phases():
        half, base = _half_depth_module(torch, mx, trained)

        def pipeline(fused_so_far):
            # phase 18 on phase 6's module: at full depth the loader keeps
            # ahead of the step, which its no-stall check needs
            run("pipeline", phase_pipeline, torch, mx, train_mod, training,
                fused_so_far)

        try:
            return phase_fused(torch, mx, half,
                               _train_data(mx, TRAIN_STEPS, TRAIN_BATCH),
                               base, pipeline=pipeline)
        finally:
            del half
            torch.cuda.empty_cache()

    fused = run("fused", fused_phases)
    # phase 18 ran inside phase 17's call
    report["phase_s"]["fused"] -= report["phase_s"]["pipeline"]
    pipe = report["pipeline"]
    del train_mod
    torch.cuda.empty_cache()
    attn = run("attention", phase_attention, torch)
    run("transformer", phase_transformer, torch, mx, profile=args.profile)
    rtc_res = run("rtc", phase_rtc, torch, mx)
    surface = run("surface", phase_surface, torch, mx, trained, card,
                  examples)
    def bundles(model, images, parts):
        res = run("bundles", phase_bundles, torch, mx, model, decoder,
                  cfg, card, bundle_workers, images, parts, build_s)
        # phase 23 on phase 22's served bundle and phase 3's weights
        run("fleet", phase_fleet, torch, mx, model, decoder, cfg, card,
            bundle_workers[1], res.pop("served_dir"), images)
        return res

    one_shot = run("one_shot", phase_one_shot, torch, mx, trained, decoder,
                   cfg, serving, card, bundles=bundles)
    # phases 22 and 23 ran inside phase 16's call
    report["phase_s"]["one_shot"] -= (report["phase_s"]["bundles"]
                                      + report["phase_s"]["fleet"])
    fleet_res = report["fleet"]
    bundle_res = one_shot.pop("bundles")
    report["bundles"] = bundle_res
    del trained, decoder
    torch.cuda.empty_cache()
    lm, lm_params = run("lm", phase_lm, torch, mx)
    report["lm"] = lm
    bucketing = run("bucketing", phase_bucketing, torch, mx, lm_params,
                    lm["step_ms_p50"])
    del lm_params
    torch.cuda.empty_cache()
    vision = run("vision", phase_vision, torch, mx)
    dp = run("data_parallel", phase_data_parallel, torch, mx, card,
             dp_workers)
    dp["phase9_step_ms_p50"] = report["transformer"].get("step_ms_p50")
    dp["ring_prefill"] = tier["ring"]
    mp = run("model_parallel", phase_model_parallel, torch, mx, card, dp)
    dp.pop("mp_reference", None)
    pe = run("pipe_expert", phase_pipe_expert, torch, mx, card, dp)
    dp.pop("pe_reference", None)
    elastic = run("elastic", phase_elastic, torch, mx, card)

    line = {"kernels": _kernel_line(
        rows, serving["launches"]["paged_attention_float"],
        kv["int8"]["launches"]["paged_attention_int8"],
        {k: r["b4_launches"] for k, r in tier["spec"].items()},
        tier["ring"]["b4_launches"])
        + _codegen_line(codegen["rows"], train_rows, training["launches"],
                        codegen["launches"],
                        pipe["prefetch_on"]["launches"])
        + _flash_line(attn) + _rtc_line(rtc_res) + _vision_line(vision)}
    # phase 21 (c): B1/B2 in the pipelined Inception stages, both workers'
    # launches over its steps
    het = pe["summary"]["inception_pipeline"]["launches_per_step_summed"]
    for k in line["kernels"]:
        template = k["name"][len("fusion_"):]
        if template in ("elementwise", "scale_bias_act"):
            k["launches_pipe_expert"] = int(het.get(template, 0)
                                            * PE_HET_STEPS)
    # phase 22 (c): B1/B2 and B5 in the restored process
    restored = bundle_res["restore"]
    for k in line["kernels"]:
        template = k["name"][len("fusion_"):]
        if template in ("elementwise", "scale_bias_act"):
            k["launches_bundle_restore"] = \
                restored["codegen_launches"].get(template, 0)
        elif k["name"] == "paged_attention_int8":
            k["launches_bundle_restore"] = \
                restored["paged_launches"]["paged_attention_int8"]
    # phase 23: B4 in the decoder replicas that exited cleanly, B1/B2 in
    # the predict replica
    for k in line["kernels"]:
        key = {"fusion_elementwise": "b1", "fusion_scale_bias_act": "b2",
               "paged_attention_float": "b4"}.get(k["name"])
        if key is not None:
            k["launches_fleet"] = fleet_res["launches"][key]
    report["kernels"] = line["kernels"]
    report["phase_s"]["total"] = time.perf_counter() - t_start
    # how each training phase's module trained (phases 6 and 17 must be
    # graphed; _graphed says "uncaptured: <op>" or "eager" otherwise)
    graphed = {"training": training["graphed"],
               "transformer": report["transformer"]["graphed"],
               "rtc": rtc_res["graphed"],
               "surface": surface["lifecycle"]["graphed"],
               "lm": lm["graphed"], "vision": vision["graphed"],
               "bucketing": bucketing["graphed"]}
    check(training["graphed"] == "graphed",
          f"phase 6 trained {training['graphed']}")
    log("graphed: " + json.dumps(graphed))
    log("fused: " + json.dumps(
        {k: fused[k] for k in (
            "fused_vs_eager_worst", "eager_step_ms_p50", "step_ms_p50",
            "step_ms_p95", "captures_in_steps", "launches_per_step",
            "run_steps_vs_single_worst", "single_vs_single_worst",
            "fit_k4_s", "numerics",
            "device_monitor", "eager_monitor", "injected",
            "measured_peak_bytes", "graph_pool_bytes", "device_stats",
            "step_tflops")}
        | {"busy_share": fused["profile"]["busy_share"],
           "preflight_total_bytes": fused["preflight"]["total_bytes"],
           "phase6_step_ms_p50": training["step_ms_p50"],
           "phase_s": report["phase_s"]["fused"],
           "parts_s": fused["parts_s"], "card": card}))
    log("pipeline: " + json.dumps(pipe["summary"]
                                  | {"phase_s": report["phase_s"]["pipeline"],
                                     "card": card}))
    log("surface: " + json.dumps(surface["summary"]))
    log("one_shot: " + json.dumps(one_shot["summary"]
                                  | {"phase_s": report["phase_s"]["one_shot"]}))
    log("bundles: " + json.dumps(
        {k: bundle_res[k] for k in (
            "served", "decoded", "served_save_s", "decoded_save_s",
            "decoder_warmup_s", "decoder_traces_parent",
            "int8_weights_top1_agreement", "restore_wall_s", "restore",
            "cold_start", "fault", "parts_s", "card")}
        | {"phase_s": report["phase_s"]["bundles"]}))
    log("fleet: " + json.dumps(
        {k: fleet_res[k] for k in (
            "hello_s", "ready_s", "hellos", "ttft_router_s",
            "ttft_in_process_s", "tokens_per_s_b", "tokens_per_s_d",
            "routed", "killed", "drained", "readmissions", "survivors",
            "stats", "near_ties", "launches", "predict",
            "predict_batcher_wait_ms", "save_s", "bundle_bytes", "parts_s",
            "card")}
        | {"phase_s": report["phase_s"]["fleet"]}))
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
    log("bucketing: " + json.dumps(
        {k: bucketing[k] for k in (
            "buckets", "steps", "per_bucket", "cold_bind_s",
            "peak_mem_bytes", "peak_bound_bytes", "perplexity_passes",
            "parity_worst", "bucket_stats", "step_ms_p50_60_over_lm")}
        | {"fused": {k: bucketing["fused"][k] for k in (
            "captures_by_pass", "adopted_param_bytes_by_pass",
            "one_storage", "step_ms_p50", "eager_step_ms_p50",
            "peak_mem_bytes", "pool_bytes", "eager_peak_bound_bytes",
            "dropout0_fused_vs_eager_worst")}}
        | {"phase_s": report["phase_s"]["bucketing"], "card": card}))
    log("data_parallel: " + json.dumps(
        dp["summary"] | {"phase_s": report["phase_s"]["data_parallel"]}))
    late = kernels_compiled()[built_ahead:]
    report["compiled_after_phase_1"] = late
    log(f"nvcc runs after phase 1: {len(late)} {late}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True, default=str)
    log(f"total {report['phase_s']['total']!r} s (PR 15's runs: "
        f"182.94-203.16 s; kernel build {build_s!r} s; each phase's s: "
        f"{json.dumps(report['phase_s'])})")
    log(card)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))

if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU: text-to-image
serving and interleaved generation (BitDance-14B-64x), ImageNet class-conditional training
(BitDance-H-1x, 256 px), ImageNet class-conditional sampling
(BitDance-H-1x at 10 of 40 layers and BitDance-B-16x, 256 px), packed
multimodal training of
BitDance-14B-64x (full width, 2 of 40 layers), the data-parallel (FSDP)
train steps at world 1, tensor-parallel T2I serving (two ranks on the one
card over gloo at tp 2; BitDance-14B-64x at full width, 2 of 40 layers),
tokenizer reconstruction
(the release VQ tokenizer, 256 and 1024 px) and the tokenizer family (the
GAN decoder, the W8A8 decoder, UniWeTok, BatchedEncoder, cli.recon), the
plain-MLP T2I head, the alt heads and SwiGLUConnector, the training commands
(cli.train_imagenet at BitDance-B-1x with checkpoints and resume,
cli.sample_fid, tokenizer training, cli.train_mllm), the DPG / GenEval
harnesses and the demo server (BitDance-14B-64x, full width and depth), the
hard-kill training proof (BitDance-B-1x), and the release directory of
BitDance-14B-64x (export, load_t2i_pipeline, the CLI and the eval commands;
full width, 2 of 40 layers).

    python3 chip_smoke.py

Phases, run in this order, one line each, any failure exits non-zero:
  device            torch / CUDA / nvcc versions, card name and power limit
  build             nvcc builds bitdance_tpu_torch/csrc into build/
  decode_attention  kernel vs its plain version at the path's shapes: the
                    three decode windows and one with its edges where the
                    cache's splits meet, window-off-by-one check, two launches
                    bit-equal, the split count, kernel (eager, device-only,
                    host per call), plain and SDPA times at each window, and
                    device times around the split count at 1024 and 512 px,
                    B 2 and 4
  sampler           whole-sampler kernel vs its plain version at the 14B head
  e2e               full-width random BitDance-14B-64x bundle (with its
                    lm_head and VQ encoder), T2IPipeline.generate: two
                    prompts at 512 px, one at 1024 px
  interleaved       InterleavedGenerator on the same bundle: plan A (chat
                    text, the e2e phase's first image, 16 sampled text
                    tokens, a 512 px image at cfg 7.5), plan B (a 256 px
                    image at cfg 1: one stream, the per-call head), plan C
                    (plan A with the int8 LLM and lm_head, a 256 px image):
                    text ids, images, ±1 grids, the streams' spans and each
                    kernel's launches against their formulas, s per plan and
                    span, ms per text token, peak memory; #14 and #15 at 64
                    x 5120 and #1 at batch 1 and the plans' longest kv_len
                    against their plain versions, the int8 lm_logits against
                    float64 on its dequantized operands; then the bundle
                    drops lm_head and encoder, which T2I serving never loads
  profile           torch.profiler over one more 256 px
                    request: device busy share and time by kernel
  eval_serve        on the same bundle at 512 px, 50 steps: the DPG harness
                    (eval/dpg.py) on the first 2 vendored prompts and the
                    GenEval harness on the first long GenEval line, 4 images
                    a prompt, each grid equal to a direct generate tiled
                    2x2 (GenEval's layout, metadata and samples too); the
                    demo's fallback server (cli/app.py) on a free port: its
                    page's control ids and one 1-image request equal to a
                    direct generate; s a prompt, #1 / #2 launches
  quant_kernels     the quantized serving kernels vs their plain versions, from
                    the same bf16 weights: the W4A8 matmul at the seven Qwen3
                    projections (M = 5, 128, 132 and 300; bit-equal, also at
                    split counts 1 and all stages), warm, cold over six
                    layers' weights, the GEMM alone, torch._int_mm warm and
                    cold, a split sweep at M 128; the fused-KV decode on bf16
                    and int8 buffers with decode_attention's checks and times,
                    the sampler's W8A8 and W4A8 modes
                    at the 14B head (4 steps, then sign agreement over 50,
                    times, launches a net call against their formula, one
                    net call by stage), each of their four integer head
                    GEMM products bit-equal to its plain twin at the planned,
                    1 and the most splits with off-by-one checks, times cold
                    beside torch._int_mm, and #16's swap-AB GEMM on the int4
                    wo product
  e2e_quant         the bundle quantized layer by layer: the int8 configuration
                    (W8A8 Qwen3, W8A8 head, int8 KV) on the first 512 px
                    request, freed; then the int4 flagship (packed-int4 W4A8
                    Qwen3, int8 embedding, W4A8 head, int8 KV) on the same
                    three requests as e2e: s/image, phases, peak memory, the
                    quantized weights' GiB, launch counts, token agreement with
                    bf16 (reported; also over the first AR step) and int4 !=
                    int8 grids (checked); the W4A8 matmul at every (M, N, K)
                    the int4 requests gave it; torch.profiler over one more
                    int4 256 px request
  flash_attention   the forward, dq and dk/dv kernels vs the plain version and
                    its autograd grads: the training path's shapes, B-16x
                    block windows, two packed documents, GQA at head dim 128
  train             random full-width BitDance-H-1x train state (the T2I
                    bundle freed first), 16 seeded synthetic 256 px images ->
                    encode_batch -> train_step: s/step, images/s, MFU, peak
                    memory, launch counts, and one step on the plain
                    attention path from the same state
  imagenet_kernels  random bf16 BitDance-H-1x (10 of its 40 backbone layers)
                    and BitDance-B-16x samplers (the training state freed
                    first); the head-block kernels
                    fused_mlp_block (H-1x: 8 rows, C 1280; B-16x: 512 rows,
                    C 768) and fused_attn_block (32 and 64 windows of 16, C
                    768, 12 heads, with a window-off-by-one check; two
                    launches bit-equal, launches a call captured, warm, cold
                    and host times; its qkv and wo products against their
                    split twins at 1 / planned / most splits with
                    off-by-one checks) and the sampler's
                    MlpEncoder and unbounded TransEncoder families vs plain,
                    each sampler's call eager and device-only with and
                    without PDL against the per-net-call bound, its launches
                    per net call (captured); every product of #3/#4's head
                    GEMM at 64 (H-1x) and 1024 (B-16x) rows against its split
                    twin (a row, an output column and a K stage off by one
                    must move the twin >= 4x the bound; two launches
                    bit-equal), cold-L2 times against torch.matmul
  imagenet_h1x      32 classes at cfg 4.55 (linear schedule), 100 sampling
                    steps, 256 AR steps, VQ decoder to uint8; then 8 classes
                    unguided through the per-call head
  imagenet_b16x     32 classes at cfg 6.1 and unguided, 16 AR steps; the
                    guided batch again with its head at every AR step through
                    both the whole sampler and the per-call blocks, whose +-1
                    tokens must agree; the guided batch free-running at 50
                    sampling steps (each path's tokens fed back) through the
                    per-call and whole-sampler kernels and through their
                    plain versions, whose agreements are reported;
                    torch.profiler over one guided and one unguided batch
  fused_net         the one-call DiffNet forward (#5) vs its plain version at
                    the H-1x MlpEncoder's unguided 8 and guided 64 rows and
                    the B-16x TransEncoder's 32 windows of 16, on the
                    sampler's stack and on one with its adaLN groups
                    poisoned so a group read one block late (and for B-16x
                    windows one row off) moves the output >= 4x the bound;
                    each block alone against a bound that the plain twin
                    with fp32 qkv and h12 (#14 / #15's rounding) exceeds;
                    kernels per call counted in a captured CUDA graph and
                    held to net_launches; its time, plain time and bound
                    beside the per-call route's (DiffNet.forward: #14 / #15
                    and torch glue); then the unguided H-1x and B-16x
                    batches again from the same draws with every net call
                    through #5: s/batch and token agreement with the
                    per-call route
  flash_sparse      the sparse-iteration flash kernels (forward, dq, dk/dv) vs
                    their plain versions over the same tile lists and the
                    autograd Function vs autograd of the plain forward, on 7
                    T2I samples packed into 8,192 tokens at 40 / 8 heads, head
                    dim 128; three maps one tile off (a diagonal tile dropped
                    where a document starts, a middle tile dropped deep in a
                    document, that tile listed twice) must each move o by >=
                    4x its per-row bound, an undersized max_live_kv must
                    raise; equal to the dense kernels on the same inputs
  mllm              random bf16 BitDance-14B-64x train state (MLLM_LAYERS of
                    40 layers at full width, vocab 152,064, no EMA; the
                    ImageNet samplers freed first), one packed sequence from
                    GreedyPacker at the yaml's budget (37,376 tokens; text and
                    vision loss rows at the packer's default budget, as the
                    JAX trainer packs them), steps on the sparse kernels:
                    per-step losses, grad norm, launch counts (2 x layers
                    forward, layers dq and dk/dv), s/step, tokens/s, MFU,
                    peak memory, a profile, the chunked CE's time at the
                    budget and at the loss rows, the sparse kernels at the
                    step's shape vs their plain versions (run in chunks)
                    and equal to the dense kernels, one step on the
                    dense kernels from the same state and draws, and the
                    forward and backward with remat_policy "dots" beside
                    "full" (loss, gradients, s, peak GiB)
  parallel          the data-parallel steps at world 1 (an NCCL group of one,
                    FSDP2 on a (1, 1, 1) mesh): BitDance-B-1x, batch 16, 3
                    steps, and the 14B yaml at full width and 2 of 40
                    layers, one step, each through make_sharded_train_step
                    and the unsharded train_step from one state and seed:
                    max |delta| of losses and parameters (bit-equal or
                    within the CPU tests' tolerance), s/step and peak GiB
                    both ways, the sharded runs' kernel launches
  tp                tensor-parallel T2I serving: two spawned ranks on the
                    one card joined over gloo (NCCL refuses two ranks on
                    one card) on a (1, 1, 2) mesh, each building the random
                    BitDance-14B-64x at full width and 2 of 40 layers from
                    one seed; a tp 1 run of one guided 256 px request, then
                    the bundle sharded in place (Qwen3 by whole heads: 20 q
                    / 4 kv heads a rank through #1; the head's sampler
                    head-major, its products on the head GEMM with fp32
                    all-reduces) and the same request: the ranks' grids
                    equal, teacher-forced hidden states and one head sample
                    against tp 1 within stated bounds, the free-running
                    grids' agreement reported, s/request, all-reduces and
                    their seconds, peak GiB a rank, launches; then the
                    plain-MLP head (no sampler stack, #15 per call) beside
                    the same LLM at tp 1 and tp 2: the head whole on each
                    rank, a head sample from one cond bit-equal, the grids;
                    then #1 at the local heads and the head GEMM's four
                    products at a rank's shapes against their plain versions
  encode_kernel     the encode tail vs its plain version at the release
                    tokenizer's trunk shapes (256, 512, 1024 px), bf16 and
                    fp32, two launches bit-equal, eager and device-only times
  tokenizer         the release VQ tokenizer (random bf16): reconstruct 16
                    images at 256 px (batch 8) and 2 at 1024 px through the
                    encode tail: exact ±1 latents, shapes, images/s, encode /
                    decode times, PSNR (reported)
  tokenizer_family  at the release tokenizer's geometry: the GAN decoder
                    (bf16, 8 x 256 and 1 x 1024 px; one seed twice
                    bit-equal, two differ; a 256 px decode in fp32 and bf16
                    against the CPU's fp32), the W8A8 decoder against bf16
                    at 256 and 1024 px with s/image, one W8A8 conv's int32
                    sums against the CPU's float64 twin, BatchedEncoder
                    (vt_forward against its batches' encodes, the maxpad
                    crops, #13's launches), cli.recon plain and --uni
                    against the in-process reconstruct, UniWeTok (s/image,
                    peak, the card's fp32 encode against the CPU's signs)
  head_leftovers    the T2I head at C 5120 with plain-MLP blocks on the
                    per-call route against the plain route (one net call, a
                    guided 4-step sample, signs after 50; #15's launches),
                    the SwiGLU head beside it; the alt heads and
                    SwiGLUConnector at 5120 in bf16 against the CPU's fp32
  train_cli         the training entry points in this process through their
                    main(argv): a synthetic tar in the official layout (8
                    classes x 8 JPEGs) whose native index must equal the
                    Python walk; cli.train_imagenet at BitDance-B-1x (full
                    width and depth), 256 px, batch 16 on it, 4 steps
                    straight and 2 + 2 resumed in a second directory
                    through its FSDP step at world 1 and its sharded
                    checkpoints (shards.rank00000.json, meta's world 1),
                    the final checkpoints bit-equal; cli.sample_fid from the
                    straight checkpoint (32 samples, 2 batches, cfg 4.6,
                    50 steps): 32 PNGs, the npz, the first batch equal to
                    a direct sample on the restored EMA weights; 3 tokenizer
                    training steps at the commands' tokenizer width;
                    cli.train_mllm on the 14B yaml cut to 2 layers at hidden
                    1024 and a 1024-wide head (the whole script may write 45
                    GiB to the machine's disk), 4 steps straight against 2
                    + 2 resumed, bit-equal;
                    s/step, save / restore seconds and checkpoint GB
  train_proof       python -m bitdance_tpu_torch.cli.train_proof as a real
                    process pair at BitDance-B-1x, 256 px, world 1: the run
                    phase killed with os._exit(9) after its save, the resume
                    phase restoring it: one bit-identical resume, steps 1..N,
                    the loss descended; s/step, GB written, flash launches
  release           random bf16 BitDance-14B-64x at 2 of 40 layers exported
                    as a release directory under build/ (fp32 LLM, bf16
                    head, decoder and projector; free space checked first),
                    loaded by load_t2i_pipeline: a 512 px grid equal to the
                    in-memory bundle's, a 2-image request, a quantized load
                    (int8 LLM and embedding, int4 head) equal to the same
                    quantizers in memory, the CLI's PNG equal to the
                    in-memory image, cli.interleaved on that PNG (the export
                    carries lm_head and the VQ encoder) equal to the
                    in-memory generator; then the directory served again
                    through a linked sibling with a random GAN decoder
                    (gan_decoder: true): a 256 px grid equal to the plain
                    release's, the same image twice; eval.dpg.main and
                    eval.geneval.main on the directory (1 prompt, 256 px, 4
                    steps), their files equal to the evaluators in this
                    process; export / load times and GB on disk
The last lines are the kernels' JSON record (each kernel's launches on the
main paths, error against its plain version, times, bound and, where one
PyTorch call computes the same function, that call's time), the card's name
and power limit, and {"ok": true, "device": {...}}. There is no CPU fallback: the
script refuses to run without a CUDA device.

    python3 chip_smoke.py --train-memory DIR [DIR ...]

compares the training commands of checkouts of this repository on one card
(a parent commit unpacked beside the tree; give the order parent, change,
change, parent): each DIR in a process of its own runs its chip_smoke.py's
device, build and train_cli phases, each command's s/step and its peak
device memory logged (a chip_smoke.py from before the peaks gets this
file's), then, where its chip_smoke.py has parallel_mllm_run, the 14B
step at full width and TRAIN_MEMORY_MLLM_LAYERS layers sharded and
unsharded, each one's s/step and peak or its out-of-memory error.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time

# Bounds (PERF.md has the reasoning and the readings they were set from).
# decode attention: the kernel rounds P to bf16 for the PV product and writes
# bf16; the plain version is fp32 on the same bf16 inputs. Each case's bound
# is a few times its own reading on the H100. The keys at both edges of each
# row's window get a large v (inside +, outside -), so a window off by one
# key moves the output by far more than the bound; the run checks that too.
# Readings (NVIDIA H100 80GB HBM3, 700 W): 1.6e-2 at kv_len 130 (one bf16
# ulp of outputs up to ~4), 9.8e-4 at 2178, 4.9e-4 at 4226.
DECODE_MAX_ABS_ERR = {"prefill_pass2": 4e-2, "mid_decode": 4e-3,
                      "last_step": 2e-3}
DECODE_EDGE_V = 8.0
# sampler, few steps, max abs error relative to max |plain x|: the kernel
# and the plain version both add each product's bias to its fp32 sum and
# split K alike, so they differ in fp32 summation order only; where that
# order moves a stage activation (qkv, LN + modulate, h1 / h2, the SwiGLU
# output, all stored bf16) across a rounding boundary, one bf16 ulp carries
# through 6 blocks x 4 net calls. Readings (NVIDIA H100 80GB HBM3, 700 W):
# 1.3-1.7e-2 at R 128, 1.4-1.6e-2 at R 256.
SAMPLER_MAX_REL_ERR = 5e-2
# sampler, 50 steps: signs can only flip where |x| is within the bf16 drift
# accumulated over 51 chained net calls of 0; nearly all latents end far
# from 0, so at least 90% of the +-1 tokens must agree.
SAMPLER_SIGN_AGREEMENT_FLOOR = 0.90
# flash attention: max abs error of each kernel output against the plain
# version (fp32 math on the same bf16 inputs; its autograd grads for dq, dk,
# dv), relative to the largest |value| of that output, per case. The kernels
# round P and dS to bf16 as product operands and write bf16 (2^-8 = 3.9e-3
# relative). Bounds are a few times the readings on the H100 (PERF.md).
# Readings (NVIDIA H100 80GB HBM3, 700 W), over the four cases: o 2.7-3.0e-3,
# lse 1.3-1.9e-7, dq 2.6-4.1e-3, dk 3.0-4.7e-3, dv 2.7-3.4e-3.
_FLASH_BOUNDS = {"o": 1.2e-2, "lse": 1e-6, "dq": 1.5e-2, "dk": 1.5e-2, "dv": 1.2e-2}
FLASH_MAX_REL_ERR = {name: dict(_FLASH_BOUNDS)
                     for name in ("path", "b16x", "packed", "gqa_d128")}
# keys at the edges of each window and document carry v = FLASH_EDGE_V, so a
# mask off by one moves the output by far more than the bound
FLASH_EDGE_V = 8.0
# train step, kernel vs plain attention from the same state and draws: both
# bf16; they differ by the flash kernels' bf16 rounding of P and dS. Readings
# (H100, 700 W): loss 9.8e-6, grad norm 7.6e-5 relative.
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_NORM_REL = 5e-4
# ImageNet sampling. The head blocks (#14, #15) and the sampler's MlpEncoder
# and unbounded TransEncoder families against their plain versions at the
# paths' shapes: max abs error relative to max |plain output| (bf16 outputs,
# one ulp is 3.9e-3 of the value). Bounds are a few times the readings on the
# H100 (PERF.md).
# Readings (NVIDIA H100 80GB HBM3, 700 W): #14 1.9e-3 (H-1x), 3.0e-3 (B-16x),
# 3.3e-3 (14B, 64 x 5120); #15 2.0e-3 (B-16x), 2.7e-3 (14B, one window of 64),
# 6.1e-3 (14B, two windows of 64); the sampler over 4 steps 1.7e-2 (H-1x) and
# 2.0e-2 (B-16x). One bound for both kernels at every call site.
HEAD_BLOCK_MAX_REL_ERR = 1e-2
IMAGENET_SAMPLER_MAX_REL_ERR = 5e-2
# #3/#4's head GEMM (csrc/head_gemm.cuh) per product against its split twin
# (the same K splits summed in the same order, then the same bf16 epilogue),
# max |error| / max |twin|: the in-split sums differ in fp32 order only, so
# an output moves by a bf16 ulp where it sits at a rounding boundary.
# Readings (NVIDIA H100 80GB HBM3, 700 W) over the H-1x and B-16x products:
# bias 3.2e-3, gated 1.5e-3-1.7e-3, swiglu 4.7e-4-2.2e-3
# Kernel #2's modes at the 14B head's products and 128 rows: gated_f32 keeps
# the residual in fp32, so only the fp32 order of sums over K 5120-7680
# differs; swiglu_f32's bf16 output moves by a bf16 ulp at a boundary.
# Readings (NVIDIA H100 80GB HBM3, 700 W): bias 3.2e-3 (qkv), gated_f32
# 1.5e-6 (wo) and 2.8e-6 (w2), swiglu_f32 2.5e-3 (w1)
# The per-call head blocks' modes: #14's swiglu_h32 and gated_bf16 round
# their bf16 output once, #5's out_f32 keeps the fp32 sums. Readings (NVIDIA
# H100 80GB HBM3, 700 W) at H-1x's 8 and B-16x's 512 rows over 1 / 4 / 8
# splits: swiglu_h32 1.5e-4-1.2e-3, gated_bf16 0-1.3e-3, out_f32 2.3e-7-1.6e-6.
# #15's bias_f32 keeps qkv in fp32 (the sums plus the bias), as out_f32.
HEAD_GEMM_MAX_REL_ERR = {"bias": 1e-2, "gated": 5e-3, "swiglu": 1e-2,
                         "gated_f32": 1e-5, "swiglu_f32": 1e-2, "swiglu_h32": 1e-2,
                         "gated_bf16": 5e-3, "out_f32": 1e-5, "bias_f32": 1e-5}
# block product -> (head GEMM mode, its bias): the round route (#3/#4) and
# kernel #2's fp32-residual route
HEAD_GEMM_PRODUCTS = {"wqkv": ("bias", "bqkv"), "wo": ("gated", "bo"),
                      "w1": ("swiglu", "b1"), "w2": ("gated", "b2")}
T2I_GEMM_PRODUCTS = {"wqkv": ("bias", "bqkv"), "wo": ("gated_f32", "bo"),
                     "w1": ("swiglu_f32", "b1"), "w2": ("gated_f32", "b2")}
# the MLP block #14's products (fused_mlp_block) and #5's fp32 adaLN-group
# product (fused_diffnet_forward; "mods": the groups' rows of modcat_w)
MLP_BLOCK_PRODUCTS = {"w1": ("swiglu_h32", "b1"), "w2": ("gated_bf16", "b2")}
# the attention block #15's products (fused_attn_block)
ATTN_BLOCK_PRODUCTS = {"wqkv": ("bias_f32", "bqkv"), "wo": ("gated_bf16", "bo")}
NET_GEMM_PRODUCTS = {"mods": ("out_f32", None)}
# the first and last token of every window get shift + IMAGENET_EDGE_SHIFT,
# which makes their q, k and v large: a window boundary off by one row then
# moves the attention block's output by far more than its bound
IMAGENET_EDGE_SHIFT = 8.0
# the guided B-16x batch's head through the per-call path (#15 + #14 under
# cfg_mult 2) and through the whole sampler, on the same conditioning and
# draws at every AR step: their +-1 tokens must agree on this share. (Left
# to run free, the per-call tokens feed back and the two batches drift apart:
# 0.856 agreement over 16 AR steps on the H100, PERF.md.)
CROSS_CHECK_AGREEMENT_FLOOR = 0.90
# kernel #5 (the whole net per call) vs its plain version: both round at
# _block_body's points and accumulate every product in fp32, so only
# summation order and the bf16 roundings it flips differ. Whole net, max abs
# error relative to max |plain output|, on the poisoned stack (adaLN groups
# 1.. scaled by -3; B-16x with the window-edge rows) and on the sampler's
# own: about 3x the H100 readings (NVIDIA H100 80GB HBM3, 700 W) 3.7e-3 /
# 1.9e-3 (H-1x, 8 and 64 rows) and 2.2e-2 / 9.3e-3 (B-16x). Through 6-12
# blocks that round every op, the flips compound until the plain twin with
# fp32 qkv and h12 (the per-call blocks' rounding) reads no further from
# plain than the kernel does (3.5e-3 / 2.7e-3 and 2.6e-2 / 9.1e-3), so the
# rounding is held one block at a time: each block run alone on the
# sampler's stack, mean |error| / mean |plain| averaged over the blocks.
# There the kernel read 1.1-1.8e-4 (H-1x) and 2.3e-4 (B-16x), the twin
# 5.6-6.3e-4 and 7.0e-4; each bound sits between, and the twin must read
# above it, so a kernel that rounds as #14 / #15 do fails.
FUSED_NET_MAX_REL_ERR = {"h1x": {"poisoned": 1e-2, "sampler": 6e-3},
                         "b16x": {"poisoned": 6e-2, "sampler": 3e-2}}
FUSED_NET_BLOCK_MEAN_REL_ERR = {"h1x": 2.8e-4, "b16x": 4e-4}
IMAGENET_BATCH = 32          # sample_fid's per-process batch
IMAGENET_STEPS = 100         # sampling steps of every ImageNet run
UNGUIDED_H1X_IMAGES = 8
# the H-1x sampler's backbone depth (of its 40 layers, full width): its
# batches' AR steps are host-bound by layer (~100 s of decode at 40 layers
# on a slow host, where the whole script took 968 s of phases; cut to 20,
# then to 10 when PR 23's phases brought it to 1,020 s); the head, and so
# every kernel check and launch count, is whole
IMAGENET_H1X_LAYERS = 10
# the unguided H-1x batch runs 25,856 per-call net calls at 100 steps, 2.9 ms
# each from the host (90 s, PERF.md); it is cut to this many sampling steps
# (25 until PR 23)
UNGUIDED_H1X_STEPS = 12
# Quantized serving. W4A8 matmul vs its plain version: the same int8 rows,
# the integer sums exact on both sides (at every split count of K) and the
# scaling in the same fp32 order, so the outputs must be equal bit for bit.
# The seven projections of one Qwen3-14B layer, (N, K) in layer order.
QWEN3_14B_PROJS = {"q_proj": (5120, 5120), "k_proj": (1024, 5120),
                   "v_proj": (1024, 5120), "o_proj": (5120, 5120),
                   "gate_proj": (17408, 5120), "up_proj": (17408, 5120),
                   "down_proj": (5120, 17408)}
# cold timing: the seven products in layer order over this many layers'
# packed weights (165 MB a layer), so each layer's weights come from HBM
# after the other layers have passed through the 50 MB L2, as in a decode
# step
W4A8_COLD_LAYERS = 6
# the quantized samplers over 4 steps against their plain versions: both
# quantize the same fp32 stage inputs, but an fp32 summation-order
# difference moves an activation across an int8 step now and then, and the
# kernel keeps qkv and h1/h2 in bf16 as the bf16 sampler does: the bf16
# sampler's bound; over 50 steps the bf16 sampler's sign-agreement floor.
QUANT_SAMPLER_MAX_REL_ERR = 5e-2
# the quant modes' four integer head GEMM products (csrc/head_gemm.cuh)
# against their plain twin: the same int8 rows and weights, exact int32
# sums, the dequantization and epilogue in the same fp32 steps, so bit for
# bit at every split count; an activation row, an output column (a weight
# row) and a K stage off by one must each move the twin by at least
# QUANT_GEMM_MOVE of its max |value| (they move it by O(1))
QUANT_GEMM_MOVE = 1e-2
# block product -> (integer head GEMM mode, its bias): kernel #2's quant
# modes, and the round route's (#3/#4 with a quantized ImageNet stack)
QUANT_GEMM_PRODUCTS = {"wqkv": ("bias", "bqkv"), "wo": ("gated_f32", "bo"),
                       "w1": ("swiglu_q", "b1"), "w2": ("gated_f32", "b2")}
ROUND_QUANT_GEMM_PRODUCTS = {"wqkv": ("bias", "bqkv"), "wo": ("gated", "bo"),
                             "w1": ("swiglu_round", "b1"), "w2": ("gated", "b2")}
# quantized ImageNet sampling (the imagenet_int8 phase): the whole sampler's
# round route in its quant modes against its plain version. Both quantize
# the same bf16 stage values and the kernel's bf16 ops round as the plain
# version's do, but an fp32 sum order that differs now and then moves a
# value across a bf16 step, and then an int8 step moves a whole product row:
# after one step (two net calls) the mean gap relative to max |x| was
# 3.6e-5 (H-1x int8) and 1.03e-3 (B-16x int8, where window attention spreads
# a row's flip over its 16-token window) on the H100: the bound is 4x the
# larger; over 4
# steps the max gap compounds (1.4e-2 to 4.8e-2 measured on the H100, the
# bf16 samplers 1.9e-2 and 3.2e-2): twice the bf16 samplers' bound; then
# the sign-agreement floor over IMAGENET_STEPS; each integer product bit for
# bit against its twin (QUANT_GEMM_MOVE for the off-by-one checks)
IMAGENET_QUANT_STEP_MEAN_GAP = 4e-3
IMAGENET_QUANT_SAMPLER_MAX_REL_ERR = 1e-1
# sparse flash attention (#10-#12) against its plain version on a packed
# 8,192-token case and at the 14B step's 37,376 tokens (40 / 8 heads, head
# dim 128): the dense kernels' bounds (the sparse kernels are the same
# arithmetic over listed tiles; a few times the readings of the first H100
# run, PERF.md), relative to max |value|; o also per token row, relative to
# that row's own max |o| over heads and dims (rows deep in a long document
# are far below the tensor's max, and a wrong tile there shows only so)
FLASH_SPARSE_MAX_REL_ERR = {"o": 1.5e-2, "o_row": 1.5e-2, "lse": 1e-6, "dq": 1.5e-2,
                            "dk": 1.5e-2, "dv": 1.5e-2}
# BitDance-14B-64x packed training: full width, MLLM_LAYERS of its 40 layers
# (all 40 need the FSDP of ROADMAP A11; 4 until PR 23, cut for the script's
# time; the parallel phase's 14B step has 2 too), MLLM_STEPS steps on the sparse
# kernels (cut from 6 to 4, then 2, for the script's time: steps 2-6 of a
# 6-step run read 7.033-7.066 s on an H100 at 700 W, so one steady step
# tells the same)
MLLM_LAYERS = 2
MLLM_STEPS = 2
MLLM_PEAK_GIB = 75.0
# the dense-kernel step from the same state and draws: the sparse and dense
# kernels compute the same tiles in the same order (0 difference in o), so
# the step differs only by atomics' order in bf16 backward sums (embedding)
MLLM_DENSE_LOSS_REL = 1e-4
MLLM_DENSE_GRAD_NORM_REL = 1e-3
# the data-parallel steps (ROADMAP A11) at world 1, an NCCL group of one:
# BitDance-B-1x (the step cli.train_imagenet trains) PARALLEL_STEPS steps and
# the 14B yaml at full width and PARALLEL_MLLM_LAYERS of 40 layers one step,
# each through make_sharded_train_step and the unsharded train_step from one
# state and seed. One process holds every shard, so bit-equality is expected;
# the run fails only past the CPU tests' tolerances (tests/
# test_torch_parallel*.py: bf16 mixed ImageNet, the first step's loss and
# grad norm 1e-4 relative, every loss 1e-3, 99% of the parameter moves
# within 0.1 lr; the 14B step's losses 2e-5 relative and its parameters
# within 1e-5 but the head's key biases, within 2 lr)
PARALLEL_STEPS = 3
PARALLEL_MLLM_LAYERS = 2
PARALLEL_MLLM_LR = 1e-3      # bf16 weights move by more than an ulp in one step
TRAIN_MEMORY_MLLM_LAYERS = 4   # --train-memory's 14B step (the mllm phase's depth until PR 23)
# tensor-parallel T2I serving: two ranks on the one card over gloo at tp 2,
# mesh (1, 1, 2), the random BitDance-14B-64x at full width and TP_LAYERS of
# its 40 layers, one guided 256 px request (prompt, px, seed), against a tp 1
# run of the same seed on the card. Teacher-forced hidden states (both runs
# fed the tp 1 run's grid): max |delta| / max |tp 1| over the prefill and every
# AR step. The two differ where a row-parallel product's fp32 partials, summed
# over the group and rounded once, land on the other side of a bf16 rounding
# boundary than the one-pass product; one bf16 ulp is 3.9e-3 of a value.
# Readings (NVIDIA H100 80GB HBM3, 700 W): 9.8e-3-1.32e-2 max, 6.5-7.1e-3
# mean over the prefill and 4 AR steps; the bound is about twice the max.
# The head sample from the same cond and draws (kernel #2 at tp 1 against the
# tensor-parallel plain-precision sampler on the head GEMM at tp 2) is held
# as #2 is held against its plain version: SAMPLER_MAX_REL_ERR over 4 steps'
# latents, SAMPLER_SIGN_AGREEMENT_FLOOR of the signs clear of SIGN_MARGIN
# after TP_STEPS (25 sampling steps: 50 until PR 23, cut for the script's
# time; each step of the head is ~100 gloo all-reduces a rank).
TP_LAYERS = 2
TP_REQUEST = ("a harbour at dawn, tensor-parallel", 256, 5)
TP_STEPS = 25
TP_CFG = 7.5
TP_HIDDEN_MAX_REL_ERR = 3e-2
TP_DEADLINE_S = 600
# the head-major sampler's four block products at tp 2: each rank's share on
# the head GEMM, fp32 sums (the all-reduce adds the bias after)
TP_GEMM_PRODUCTS = {"wqkv": ("out_f32", None), "wo": ("out_f32", None),
                    "w1": ("out_f32", None), "w2": ("out_f32", None)}
# the encode tail (#13) vs its plain version: raw output relative to max |x|
# (bf16 output: a few ulps; fp32: summation order), and exact signs wherever
# the plain raw value clears the repo's sign margin
ENCODE_MAX_REL_ERR = {True: 1.6e-2, False: 1e-5}   # keyed by "is bf16"
SIGN_MARGIN = 1e-3
# the tokenizer family at the release tokenizer's geometry
# (train/configs/bitdance_14b_64x.yaml:9-16); UniWeTok adds its
# UniVQModel defaults (no published UniWeTok ddconfig is in the repository)
UNI_EXTRA = dict(attn_blocks=2, n_heads=16)
FAMILY_IMAGES = ((256, 8, 8), (1024, 1, 1))      # px, images, batch
# a decode or encode on the card in fp32 (TF32 off) against the CPU's fp32
# run of the same weights and inputs: relative L2, the products summed in
# another order only (the CPU tests' fp32 bound is 2e-4 absolute)
CARD_FP32_REL_L2 = 1e-4
# the bf16 GAN decode against the CPU fp32 decode of the same latents and
# noise (reported beside the check above): bf16 activations and products
# through ~45 convolutions, each rounding at 2^-9 relative
CARD_BF16_REL_L2 = 5e-2
# W8A8 decoder against the bf16 decoder of the same latents, relative L2.
# JAX's test bound (tests/test_tokenizer.py:142-170) is 0.08 at ch 32, one
# res block, 16 px; the per-image activation scale coarsens as an image's
# max |x| grows with its pixel count and the error adds up over the release
# decoder's ~45 convs. On the CPU with random lecun weights at the release
# geometry: the JAX package's own conv_int8 decode 0.0955 at 64 px, the
# port's 0.117 / 0.142 / 0.145 at 64 / 128 / 256 px. An H100 reads 0.1283
# / 0.1437 at 256 / 1024 px here; planted quantizer faults at 256 px
# (scripts/torch_bound_faults.py) read 0.2409 (7-bit activations) and
# 0.2548 (truncation), one scale for the batch or the weight 0.1422 /
# 0.1340, so the bound sits between the sound readings and the first two
CONV_INT8_REL_L2 = 0.18
# "dots" vs "full" on the 14B step (same ops, the products' outputs kept
# instead of recomputed by the same kernels): max |d| / max |ref| of every
# gradient; expected 0 (bit-equal), bounded by an eighth of a bf16 ulp of
# the largest gradient should one product's bits differ
REMAT_GRAD_REL = 5e-4
# the plain-MLP T2I head (use_swiglu=False) on the per-call route against
# the plain route. One net call: #15's block bound (HEAD_BLOCK_MAX_REL_ERR).
# A guided 4-step sample at cfg 7.5: where #15's fp32 sums round to another
# bf16 value than the plain version's, 6 blocks x 5 net calls and the
# guidance carry it; on the CPU one bf16 ulp on 2% of #15's outputs moves
# the sample by 3.9e-2 of max |x| for the plain-MLP and the SwiGLU head
# alike (an H100 read 4.38e-2 for the plain-MLP head), so the bound is twice
# that; the SwiGLU head at the same width is held to it beside. Signs after
# 50 steps: the tp phase's floor. Planted faults (scripts/torch_bound_faults.py,
# an H100): gelu for silu reads 0.144 and signs 0.930, unscaled scores 0.736;
# #15's plain version in bf16 reads 4.66e-2, a rounding like the sound route's
PLAIN_HEAD_MAX_REL_ERR = 8e-2
PLAIN_HEAD_SIGN_FLOOR = 0.95
# the alt heads and SwiGLUConnector in bf16 on the card against the CPU's
# fp32 of the same (bf16) weights: one bf16 rounding of the inputs and of
# each product's output
ALT_HEAD_MAX_REL_ERR = 3e-2
# H100 SXM dense bf16 and int8 tensor-core peaks and HBM3 rate (NVIDIA data
# sheet, at 700 W), for MFU and for each kernel's bound: the larger of the
# bytes the function must move (each input read once, each output written
# once) over the memory rate and its operations over the peak of their type
H100_BF16_PEAK = 989e12
H100_INT8_PEAK = 1979e12
H100_HBM_BYTES_PER_S = 3.35e12
# kernel-name substrings -> the groups a profile's time is summed into (the
# first group that matches)
PROFILE_GROUPS = (
    ("row quantization #16", ("quantize_image",)),
    ("W4A8 GEMM #16", ("w4a8",)),
    ("row quantization (#2's quant mode)", ("quantize_rows",)),
    ("int8 LLM products (torch._int_mm)", ("i16832gemm",)),
    ("head GEMM (#2 bf16 / int8 / int4, #3/#4, #5, #14)", ("head_gemm",)),
    ("products", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("flash attention", ("flash_",)),
    ("decode attention", ("decode_attention", "split_decode", "split_combine")),
    ("head stages", ("window_attention", "ln_modulate", "final_em", "proj_in")),
    ("optimizer foreach", ("multi_tensor_apply",)),
    ("elementwise, casts, reductions", ("elementwise", "copy", "reduce", "Cat", "index",
                                       "embedding", "norm")),
)


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def roofline(n_bytes: float, flops: float, int_ops: float = 0.0) -> dict:
    """The least time the card could take: bytes over the HBM rate or
    operations over the tensor-core peaks (flops at bf16's, int_ops at
    int8's), whichever is larger."""
    t_bytes = n_bytes / H100_HBM_BYTES_PER_S * 1e3
    t_ops = (flops / H100_BF16_PEAK + int_ops / H100_INT8_PEAK) * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 200, trials: int = 1) -> float:
    """Host time of one call in microseconds: ``calls`` calls timed on the
    host clock with nothing waiting on the card (200 two-launch calls stay
    inside the launch queue), so it reads what a call costs the host; the
    least of ``trials`` such runs (the card's host is shared, so a run can
    be slowed by its neighbours)."""
    import torch

    best = float("inf")
    for _ in range(trials):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / calls * 1e6


def phase_device() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from bitdance_tpu_torch.ops import _cuda
    from bitdance_tpu_torch.utils.precision import full_fp32

    full_fp32()          # as every entry point of the port sets it

    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = "absent"
    log("device", f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} triton {triton_v}")
    log("device", f"nvcc: {nvcc[-1]}")
    log("device", f"card: {card_line()}; devices {torch.cuda.device_count()}; "
        f"capability {torch.cuda.get_device_capability(0)}")


def phase_build() -> None:
    from bitdance_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.load()
    log("build", f"{_cuda.build_info['path']} in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {_cuda.build_info['seconds']:.1f} s)")
    for line in _cuda.build_info.get("log", "").splitlines():
        if any(w in line for w in ("entry function", "registers", "spill", "C751")):
            log("build", "ptxas: " + line.strip())


def _poison_window_edges(v, kv_start, kv_len):
    """v with the first and last key of each row's window set to
    +DECODE_EDGE_V and the keys just outside it to -DECODE_EDGE_V."""
    v = v.clone()
    L = v.shape[2]
    for r, (a, n) in enumerate(zip(kv_start.tolist(), kv_len.tolist())):
        v[r, :, [a, n - 1]] = DECODE_EDGE_V
        outside = [i for i in (a - 1, n) if 0 <= i < L]
        if outside:
            v[r, :, outside] = -DECODE_EDGE_V
    return v


def cuda_graph_time_ms(fn, calls: int = 20, reps: int = 5) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph and
    replayed ``reps`` times, so no host launch cost is counted."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * reps)


# the 1024 px geometry of the 14B-64x decode: 2 CFG rows (the second left-
# padded by 50), 64 tokens, 40 / 8 heads, a cache of 4226 positions
DECODE_SHAPE = dict(b=2, s=64, hq=40, hkv=8, d=128)
DECODE_L = 64 + 2 + 64 + 64 * 64
DECODE_WINDOWS = {"prefill_pass2": 64 + 2 + 64, "mid_decode": 64 + 2 + 64 + 32 * 64,
                  "last_step": DECODE_L}


def _decode_buffers(fmt, k, v):
    """The cache arguments of a format: bf16 head-major k, v; a fused bf16
    buffer; or the int8 fused buffer and its scales, from the same k, v."""
    import torch

    from bitdance_tpu_torch.ops.decode_attention import quantize_kv_rows

    if fmt == "bf16":
        return (k, v)
    if fmt == "fused_bf16":
        return (torch.cat([k, v], dim=-1), None)
    kv, sc = quantize_kv_rows(k.transpose(1, 2), v.transpose(1, 2))
    return (kv.contiguous(), sc.contiguous())


def _decode_fns(fmt, q, bufs, kv_len, kv_start, **kw):
    """(kernel, plain version, the same attention as one SDPA call) on the
    same inputs; SDPA takes the window as a boolean mask, GQA by enable_gqa,
    and an int8 buffer dequantized to bf16. ``kw`` goes to the kernel's
    wrapper (n_splits)."""
    import torch

    from bitdance_tpu_torch.ops import decode_attention as da

    if fmt == "bf16":
        kernel = lambda: da.decode_attention(q, *bufs, kv_len, kv_start, **kw)  # noqa: E731
        plain = lambda: da.decode_attention_reference(q, *bufs, kv_len, kv_start)  # noqa: E731
        kd, vd = bufs
    else:
        kernel = lambda: da.decode_attention_fusedkv(q, bufs[0], kv_len, kv_start,  # noqa: E731
                                                     bufs[1], **kw)
        plain = lambda: da.decode_attention_fusedkv_reference(  # noqa: E731
            q, bufs[0], kv_len, kv_start, bufs[1])
        kd, vd = (t.bfloat16().contiguous() for t in da.dequantize_fused_kv(*bufs))
    L = kd.shape[2]
    pos = torch.arange(L, device=q.device)
    mask = ((pos >= kv_start[:, None]) & (pos < kv_len[:, None]))[:, None, None]
    mask = mask.expand(q.shape[0], 1, q.shape[1], L)
    qt = q.transpose(1, 2)
    library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        qt, kd, vd, attn_mask=mask, enable_gqa=True)
    return kernel, plain, library


def _check_decode(fmt: str, seed: int, phase: str) -> dict:
    """One decode kernel format against its plain version at the decode
    windows, edges poisoned, with the window-off-by-one check on the plain
    version, two launches bit for bit, the split count, and at each of the
    three windows the kernel's time (eager, the record's ms; device-only
    from a CUDA graph; the wrapper's host time a call), the plain version's
    and one SDPA call's (eager, the record's library_ms, and device-only).
    A fourth case puts every window edge on a 64-key tile edge where the
    full cache's splits meet (bound: mid_decode's); then the split sweeps
    of `_split_sweeps`. Returns the last step's record."""
    import torch

    from bitdance_tpu_torch.ops.decode_attention import kernel_splits

    dev = torch.device("cuda")
    sh = DECODE_SHAPE
    b, s, hq, hkv, d, L = sh["b"], sh["s"], sh["hq"], sh["hkv"], sh["d"], DECODE_L
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, hkv, L, d), generator=g, device=dev).bfloat16()
    v0 = torch.randn((b, hkv, L, d), generator=g, device=dev).bfloat16()
    quant = fmt == "int8"
    n_splits = kernel_splits(q.shape, hkv, L, dev, quant)
    tiles = -(-L // 64)
    edge = 64 * (tiles // n_splits)        # where the full cache's second split starts
    cases = {name: ([0, 50], [n, n]) for name, n in DECODE_WINDOWS.items()}
    cases["split_edges"] = ([0, edge], [2 * edge, L])
    bounds = dict(DECODE_MAX_ABS_ERR, split_edges=DECODE_MAX_ABS_ERR["mid_decode"])
    worst, rec = 0.0, {}
    with torch.no_grad():
        for name, (starts, lens) in cases.items():
            kv_start = torch.tensor(starts, dtype=torch.int32, device=dev)
            kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
            bufs = _decode_buffers(fmt, k, _poison_window_edges(v0, kv_start, kv_len))
            kernel, plain, library = _decode_fns(fmt, q, bufs, kv_len, kv_start)
            got, again = kernel(), kernel()
            want = plain()
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            same = torch.equal(got, again)
            # how far the plain version moves when the window is off by one
            shifted = [(kv_len - 1, kv_start), (kv_len, kv_start + 1)]
            if max(lens) < L:
                shifted.append((kv_len + 1, kv_start))
            shift = min((_decode_fns(fmt, q, bufs, nl, ns)[1]().float()
                         - want.float()).abs().max().item() for nl, ns in shifted)
            bound = bounds[name]
            if not torch.isfinite(got).all() or err > bound or shift < 4 * bound \
                    or not same:
                raise SystemExit(f"{phase} {fmt} {name}: max abs err {err} (bound "
                                 f"{bound}), off-by-one shift {shift}, two launches "
                                 f"bit-equal {same}")
            worst = max(worst, err)
            msg = (f"{fmt} {name} kv_start={starts} kv_len={lens} n_splits={n_splits}: "
                   f"max abs err {err:.3e} (bound {bound}; a window off by one key "
                   f"moves the plain version by >= {shift:.3e}); two launches "
                   "bit-equal")
            if name != "split_edges":
                # the record's ms and library_ms eager (CUDA events over 50
                # calls, host launch cost included, as for every kernel);
                # device-only from a captured graph beside them, and the
                # wrapper's host time a call
                t = {"ms": cuda_time_ms(kernel, 50), "plain_ms": cuda_time_ms(plain, 10),
                     "library_ms": cuda_time_ms(library, 50),
                     "device_ms": cuda_graph_time_ms(kernel),
                     "library_device_ms": cuda_graph_time_ms(library),
                     "host_us": host_us(kernel)}
                msg += (f"; kernel {t['ms']:.4f} ms eager ({t['device_ms']:.4f} "
                        f"device-only, {t['host_us']:.1f} us host a call), plain "
                        f"{t['plain_ms']:.4f} ms, scaled_dot_product_attention "
                        f"{t['library_ms']:.4f} ms eager ({t['library_device_ms']:.4f} "
                        "device-only)")
                rec = t
            log(phase, msg)
        # the last step: bound over the live keys (bf16 k and v, or int8 k
        # and v with their two f32 scales per key)
        kv_start = torch.tensor([0, 50], dtype=torch.int32, device=dev)
        live = (L - kv_start).sum().item()
        per_key = hkv * (2 * d + 8) if quant else 2 * hkv * d * 2
        rec.update(roofline(nbytes(q, q) + per_key * live, 4.0 * hq * s * d * live))
        log(phase, f"{fmt} kv_len={L}: bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
        _split_sweeps(fmt, g, phase)
    for key in ("library_device_ms", "host_us"):
        rec.pop(key)
    return {"max_abs_err": worst, **rec}


# the split rule's shapes (B, cache length): the 1024 px and 512 px (16 AR
# steps) caches at B 2, and a 2-image request (B 4: 2 images x 2 CFG rows)
DECODE_SWEEPS = {"1024px_b2": (2, DECODE_L), "512px_b2": (2, 64 + 2 + 64 + 16 * 64),
                 "1024px_b4": (4, DECODE_L), "512px_b4": (4, 64 + 2 + 64 + 16 * 64)}


def _split_sweeps(fmt: str, g, phase: str) -> None:
    """Device ms of one format's kernel at the split count
    `decode_splits` picks and one and two splits either side, with every
    row's window the whole cache (kv_start 0 or 50), at DECODE_SWEEPS."""
    import torch

    from bitdance_tpu_torch.ops.decode_attention import kernel_splits

    sh = DECODE_SHAPE
    s, hq, hkv, d = sh["s"], sh["hq"], sh["hkv"], sh["d"]
    dev = torch.device("cuda")
    for name, (b, L) in DECODE_SWEEPS.items():
        q = torch.randn((b, s, hq, d), generator=g, device=dev).bfloat16()
        k, v = (torch.randn((b, hkv, L, d), generator=g, device=dev).bfloat16()
                for _ in range(2))
        bufs = _decode_buffers(fmt, k, v)
        kv_start = torch.tensor([0, 50] * (b // 2), dtype=torch.int32, device=dev)
        kv_len = torch.full((b,), L, dtype=torch.int32, device=dev)
        n_splits = kernel_splits(q.shape, hkv, L, dev, fmt == "int8")
        tiles = -(-L // 64)
        alt = {n: cuda_graph_time_ms(_decode_fns(fmt, q, bufs, kv_len, kv_start,
                                                 n_splits=n)[0])
               for n in range(n_splits - 2, n_splits + 3) if 1 <= n <= tiles}
        log(phase, f"{fmt} split sweep {name} B={b} kv_len={L}: picks n_splits="
            f"{n_splits}; device ms at n_splits " + ", ".join(
                f"{n}: {ms:.4f}" for n, ms in sorted(alt.items())))


def phase_decode_attention() -> dict:
    return _check_decode("bf16", 0, "decode_attention")


def _head_inputs(stacked, head, steps, seed, dev, images=1):
    import torch

    from bitdance_tpu_torch.models.sampling import time_shift
    from bitdance_tpu_torch.ops.fused_head import em_precompute

    g = torch.Generator(device=dev).manual_seed(seed)
    p, C, ch = head.parallel_num, head.ch_latent, head.ch_target
    cond = torch.randn((2 * images, p, C), generator=g, device=dev).bfloat16()
    c_emb = cond.reshape(2 * images * p, C).float() \
        @ stacked["cond_w"].float().t() + stacked["cond_b"]
    t_all = time_shift(torch.linspace(0.0, 0.95, steps + 1), head.time_shift)
    dt_all = torch.cat([t_all[1:] - t_all[:-1], torch.zeros(1)])
    x0 = torch.randn((images * p, ch), generator=g, device=dev)
    noise = torch.randn((steps, images * p, ch), generator=g, device=dev)
    allmods = em_precompute(stacked, c_emb, t_all, out_dtype=torch.bfloat16)
    return x0, noise, allmods, t_all, dt_all


def phase_sampler(bundle) -> dict:
    import torch

    from bitdance_tpu_torch.ops.fused_head import (
        em_precompute,
        fused_em_sample,
        fused_em_sample_reference,
    )

    dev = torch.device("cuda")
    head = bundle.head
    stacked = bundle.stacked_head()
    kw = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
              n_head=head.ch_latent // head.attn_head_dim, groups=2,
              last_step_size=0.05)
    cfg = 7.5
    with torch.no_grad():
        for images in (1, 2):                  # R = 128 and 256 rows
            x0, noise, mods, t_all, dt_all = _head_inputs(
                stacked, head, 3, images, dev, images)
            kwi = dict(kw, groups=2 * images)
            got = fused_em_sample(stacked, x0, noise, mods, t_all, dt_all, cfg,
                                  **kwi)
            want = fused_em_sample_reference(stacked, x0, noise, mods, t_all,
                                             dt_all, cfg, **kwi)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            rel = e / want.abs().max().item()
            if not torch.isfinite(got).all() or rel > SAMPLER_MAX_REL_ERR:
                raise SystemExit(f"sampler 3 steps, {images} image(s): rel err "
                                 f"{rel} > {SAMPLER_MAX_REL_ERR}")
            log("sampler", f"3 steps, R={128 * images}, C=5120, H=7680, "
                f"6 blocks: max abs err {e:.3e}, rel {rel:.3e} "
                f"(bound {SAMPLER_MAX_REL_ERR})")
            if images == 1:
                err = e

        products = _check_head_gemm("t2i", stacked, ("wqkv", "wo", "w1", "w2"), 128, dev, 18,
                                    T2I_GEMM_PRODUCTS, "sampler")
        c_emb = torch.randn((128, head.ch_latent), device=dev)
        t_all = torch.linspace(0.0, 0.95, 51)
        pre_ms = cuda_time_ms(lambda: em_precompute(stacked, c_emb, t_all), 5)
        log("sampler", f"em_precompute, one AR step (51 timesteps x 128 rows, the modulation "
            f"[6528, 5120] x [{stacked['modcat_w'].shape[0]}, 5120] summed in fp32 before its "
            f"bias, bf16 out): {pre_ms:.3f} ms")

        x0, noise, mods, t_all, dt_all = _head_inputs(stacked, head, 50, 2, dev)
        run_k = lambda: fused_em_sample(stacked, x0, noise, mods, t_all,  # noqa: E731
                                        dt_all, cfg, **kw)
        run_p = lambda: fused_em_sample_reference(stacked, x0, noise, mods,  # noqa: E731
                                                  t_all, dt_all, cfg, **kw)
        xk, xp = run_k(), run_p()
        agree = (torch.sign(xk) == torch.sign(xp)).float().mean().item()
        err50 = (xk - xp).abs().max().item()
        ms = cuda_time_ms(run_k, 3, warmup=1)
        pms = cuda_time_ms(run_p, 3, warmup=1)
        times = sampler_times(lambda pdl: fused_em_sample(stacked, x0, noise, mods, t_all,
                                                          dt_all, cfg, _pdl=pdl, **kw))
        per_net = _sampler_launches(lambda s: fused_em_sample(
            stacked, x0, noise[:s], mods[:s + 1], t_all, dt_all, cfg, **kw))
        want_net = sampler_net_launches(kw["num_blocks"], True)
        stages = net_call_profile(lambda s: fused_em_sample(
            stacked, x0, noise[:s], mods[:s + 1], t_all, dt_all, cfg, _pdl=False, **kw))
        bd = sampler_bound(stacked, x0, noise, mods, attention=True,
                           groups=kw["groups"], window=head.parallel_num)
        calls = mods.shape[0]
        log("sampler", f"50 steps: kernel {ms:.2f} ms, plain {pms:.2f} ms, "
            f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}); "
            f"+-1 agreement {agree:.4f} (floor {SAMPLER_SIGN_AGREEMENT_FLOOR}); "
            f"max abs diff {err50:.3e}; per net call kernel {ms / calls:.4f} ms, "
            + ", ".join(f"{q} {v / calls:.4f}" for q, v in times.items())
            + f" ms, bound {bd['bound_ms'] / calls:.4f} ms; {per_net:g} launches per net "
            f"call (captured; formula {want_net}); one net call by kernel (profiled, us): "
            + ", ".join(f"{q} {v:.1f}" for q, v in stages.items()))
        if not torch.isfinite(xk).all() or agree < SAMPLER_SIGN_AGREEMENT_FLOOR:
            raise SystemExit(f"sampler 50 steps: agreement {agree}")
        if per_net != want_net:
            raise SystemExit(f"sampler: {per_net} launches per net call, want {want_net}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bd,
            "library_ms": None, "sign_agreement_50": agree, **times,
            "launches_per_net_call": per_net, "products": products,
            "em_precompute_ms": pre_ms}


def sampler_net_launches(num_blocks: int, attention: bool, quant: str | None = None) -> int:
    """Kernel launches of one net call of the whole sampler
    (csrc/fused_head.cu): the input projection, 7 per TransEncoder block
    (LN, qkv, window attention, wo, LN, w1, w2) or 3 per MlpEncoder block,
    the final layer; a quant mode's block takes 9 (TransEncoder) or 4
    (MlpEncoder): its LN writes the int8 rows itself, the attention and
    SwiGLU outputs take one row quantization each."""
    per_block = (9 if attention else 4) if quant else (7 if attention else 3)
    return 2 + per_block * num_blocks


# kernel-name substrings -> the stages of one whole-sampler net call
NET_CALL_STAGES = (("products", ("head_gemm",)), ("row_quantization", ("quantize_rows",)),
                   ("ln_modulate", ("ln_modulate",)),
                   ("window_attention", ("window_attention",)),
                   ("final_layer", ("final_em",)), ("proj_in", ("proj_in",)))


def net_call_profile(run_steps, steps: int = 3) -> dict:
    """Device us of one net call of the whole sampler by stage: torch.profiler
    over one eager call of run_steps(steps) (steps + 1 net calls), each
    kernel's time summed into its stage (NET_CALL_STAGES), over the net
    calls; "kernels" is the profiled kernel count per net call (a profiler
    that misses launches shows here against the captured count). Profile
    the chain without PDL: a programmatic kernel's span starts when it may
    launch and so holds its wait for the kernel ahead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run_steps(steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run_steps(steps)
        torch.cuda.synchronize()
    out = {name: 0.0 for name, _ in NET_CALL_STAGES}
    out["other"], n = 0.0, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        stage = next((q for q, keys in NET_CALL_STAGES if any(k in e.name for k in keys)),
                     "other")
        out[stage] += e.time_range.elapsed_us()
        n += 1
    out = {q: v / (steps + 1) for q, v in out.items()}
    out["kernels"] = n / (steps + 1)
    return out


def sampler_bound(stacked, x0, noise, allmods, *, attention, groups=1,
                  window=1, quant=None, l2_bytes=None) -> dict:
    """Bound of one whole-sampler call: its inputs read once (the block
    weights and their scales, the input and output projections, all mods,
    x0, noise) and its output written once; then, since each net call needs
    the one before it, every net call after the first streams the block
    stack again, less what the L2 can hold (l2_bytes, default the card's):
    max(0, stack - L2) bytes for each of those net calls. Operations of every net call's products (integer ones
    at the int8 peak when quantized; a packed int4 byte holds two weights)
    and window attention."""
    mats = ["w1", "w2"] + (["wqkv", "wo"] if attention else [])
    stack = mats + ["b1", "b2", "n2"] + (["bqkv", "bo", "n1"] if attention else []) \
        + ([k + "_s" for k in mats] if quant else [])
    read = stack + ["in_w", "in_b", "f_out_w", "f_out_b"]
    rows, calls = 2 * x0.shape[0], allmods.shape[0]
    block_w = sum(stacked[k].numel() for k in mats) * (2 if quant == "int4" else 1)
    proj_w = stacked["in_w"].numel() + stacked["f_out_w"].numel()
    block_ops = 2.0 * rows * block_w * calls
    flops = 2.0 * rows * proj_w * calls + (0.0 if quant else block_ops)
    if attention:
        c, blocks = stacked["n2"].shape[-1], stacked["w1"].shape[0]
        flops += 4.0 * groups * window * window * c * blocks * calls
    if l2_bytes is None:
        import torch

        l2_bytes = torch.cuda.get_device_properties(x0.device).L2_cache_size
    streamed = max(0, calls - 1) * max(0, nbytes(*[stacked[k] for k in stack]) - l2_bytes)
    return roofline(nbytes(*[stacked[k] for k in read], allmods, x0, noise, x0) + streamed,
                    flops, block_ops if quant else 0.0)


class StubTokenizer:
    """Deterministic stand-in for the Qwen tokenizer, so the script needs no
    tokenizer files: characters -> ids < 2000, special tokens from 2000 (the
    chat markers of interleaved generation last, so the others keep their
    ids); decode writes the ids."""

    def __init__(self, parallel_num: int):
        toks = (["<|vision_start|>"] + [f"<|res_{j}|>" for j in range(1, 257)]
                + [f"<|query_{j}|>" for j in range(1, parallel_num)]
                + ["<|im_start|>", "<|im_end|>", "<|vision_end|>"])
        self.special = {t: 2000 + i for i, t in enumerate(toks)}

    def encode(self, text):
        return [min(ord(c), 1999) for c in text][:48]

    def convert_tokens_to_ids(self, tok):
        return self.special[tok]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


E2E_REQUESTS = [("a red fox in the snow, 512", 512, 0),
                ("a lighthouse at dusk, 512", 512, 1),
                ("a bowl of ramen on a wooden table, 1024", 1024, 2)]


def phase_e2e(bundle, card: str) -> dict:
    import numpy as np
    import torch

    from bitdance_tpu_torch.ops.decode_attention import decode_attention
    from bitdance_tpu_torch.ops.fused_head import fused_em_sample
    from bitdance_tpu_torch.pipelines.t2i import T2IPipeline

    pipe = T2IPipeline(bundle, StubTokenizer(bundle.parallel_num))
    layers = bundle.llm_cfg.num_hidden_layers
    requests = E2E_REQUESTS
    decode_attention.launches = 0
    fused_em_sample.launches = 0
    per_request = []
    for prompt, px, seed in requests:
        da0, fs0 = decode_attention.launches, fused_em_sample.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        img, tok = pipe.generate(prompt, px, px, num_sampling_steps=50,
                                 guidance_scale=7.5, num_images=1, seed=seed,
                                 return_tokens=True)
        dt = time.perf_counter() - t0
        steps = (px // 16) ** 2 // bundle.parallel_num
        want_da, want_fs = layers * (1 + steps), steps
        got_da = decode_attention.launches - da0
        got_fs = fused_em_sample.launches - fs0
        ok = (img.dtype == np.uint8 and img.shape == (1, px, px, 3)
              and tok.shape == (1, (px // 16) ** 2, 32)
              and set(np.unique(tok).tolist()) <= {-1.0, 1.0}
              and got_da == want_da and got_fs == want_fs)
        timing = {k: (round(v, 4) if isinstance(v, float) else v)
                  for k, v in pipe.last_timing.items()}
        log("e2e", f"{px}x{px}, 50 steps, cfg 7.5: {dt:.3f} s/image; "
            f"last_timing {json.dumps(timing)}; decode_attention +{got_da} "
            f"(want {want_da}), fused_em_sample +{got_fs} (want {want_fs}); "
            f"image {img.shape} {img.dtype} mean {img.mean():.2f}; "
            f"tokens +1 share {(tok > 0).mean():.3f}; card {card}")
        if not ok:
            raise SystemExit(f"e2e {px}px request failed its checks")
        per_request.append({"px": px, "s_per_image": dt, "timing": timing,
                            "tokens": torch.from_numpy(tok), "image": img[0]})
    # the decoder's float output is finite (the uint8 cast would hide NaN)
    from bitdance_tpu_torch.pipelines.t2i import decode_image

    with torch.no_grad():
        lat = torch.from_numpy(tok).to("cuda")
        raw = decode_image(bundle, lat, 64, 64)
        if not torch.isfinite(raw.float()).all():
            raise SystemExit("e2e: decoder output not finite")
    return {"decode_attention": decode_attention.launches,
            "fused_em_sample": fused_em_sample.launches,
            "requests": per_request}


# the side of the profiled T2I requests (bf16 and int4): 512 until PR 23,
# cut for the script's time (reading the profiler's events of a 512 px
# request took ~30 s on a slow host)
PROFILE_PX = 256


def phase_profile(bundle) -> None:
    from bitdance_tpu_torch.pipelines.t2i import T2IPipeline

    pipe = T2IPipeline(bundle, StubTokenizer(bundle.parallel_num))
    pipe.generate("profile warmup", PROFILE_PX, PROFILE_PX, seed=7)
    profile_run("profile", f"{PROFILE_PX} px request",
                lambda: pipe.generate("profile request", PROFILE_PX, PROFILE_PX, seed=8),
                lambda: f"last_timing {json.dumps(pipe.last_timing)}")


# interleaved generation (example_interleaved.py's plan): the chat text, the
# max length of a generated text span, and the plans' generated image sides
INTERLEAVED_CHAT = ("<|im_start|>user\nDescribe this image, then draw it at night."
                    "<|im_end|>\n<|im_start|>assistant\n")
# (16 text tokens a span: 32 until PR 23, cut for the script's time)
INTERLEAVED_TEXT = dict(max_length_text=16, temperature=1.0, top_k=1200, top_p=0.95)
INTERLEAVED_PLANS = {            # name: (cfg, user image?, generated text?, side, LLM)
    "A": (7.5, True, True, 512, "bf16"),
    "B": (1.0, False, False, 256, "bf16"),
    "C": (7.5, True, True, 256, "int8"),
}
# the int8 lm_logits against the same product in float64 on the dequantized
# operands (its int8 rows and weight times their scales), rounded to bf16 as
# the path's output is (JAX's int8_matmul returns x's dtype too): the int32
# sums are exact, so an entry can differ only where the fp32 scaling puts it
# across a bf16 rounding boundary, by one bf16 ulp of that entry. Reading
# (NVIDIA H100 80GB HBM3, 700 W): 0.99998 of the logits bit-equal, the rest
# one ulp; 2.3e-3 of max |logit| against the unrounded float64 product (the
# bf16 rounding itself).
LM_LOGITS_INT8_MAX_ULPS = 1


def _interleaved_plan(name: str, user_image):
    from bitdance_tpu_torch.pipelines.interleaved import PlanItem

    _, with_image, with_text, side, _ = INTERLEAVED_PLANS[name]
    plan = [PlanItem(type="text", source="user", text=INTERLEAVED_CHAT)]
    if with_image:
        plan.append(PlanItem(type="image", source="user", image=user_image))
    if with_text:
        plan.append(PlanItem(type="text", source="model"))
    plan.append(PlanItem(type="image", source="model", image_size=(side, side)))
    return plan


def _check_interleaved_run(gen, plan, out, tok, bundle, cfg_scale, counts,
                           sample_steps) -> list:
    """The failed checks of one plan's run: text ids in [0, V) and at most
    max_length_text a span; finite images of the plan's size and ±1 grids;
    the two streams apart by the first user block and then in lockstep, each
    span's slot count by its formula; the launches by theirs."""
    import numpy as np

    from bitdance_tpu_torch.pipelines.interleaved import remove_first_user_block

    bad = []
    vp, p, z = bundle.vae_patch_size, bundle.parallel_num, bundle.head.ch_target
    vocab = bundle.llm_cfg.vocab_size
    texts = [[int(i) for i in t.split()] for t in out["generated_text"]]
    if any(not 0 <= i < vocab for t in texts for i in t) or any(
            len(t) > INTERLEAVED_TEXT["max_length_text"] for t in texts):
        bad.append("text ids")
    sides = [i.image_size[0] for i in plan if i.source == "model" and i.type == "image"]
    if [im.shape for im in out["generated_image"]] != [(s, s, 3) for s in sides] or not all(
            np.isfinite(im).all() for im in out["generated_image"]):
        bad.append("images")
    if [tuple(g.shape) for g in gen.last_image_tokens] != [((s // vp) ** 2, z)
                                                          for s in sides] or not all(
            bool(((g == 1) | (g == -1)).all()) for g in gen.last_image_tokens):
        bad.append("token grids")
    streams = 2 if cfg_scale > 1.0 else 1
    by = {"cond": [], "uncond": []}
    for stream, idx, kind, a, b in gen.last_spans:
        by[stream].append((idx, kind, a, b))
    n_text = iter([len(t) for t in texts])
    for stream, spans in by.items():
        if stream == "uncond" and streams == 1:
            if spans:
                bad.append("an uncond stream at cfg 1")
            continue
        end = 0
        for (idx, kind, a, b), item in zip(spans, plan):
            if kind == "user_text":
                text = item.text if stream == "cond" else remove_first_user_block(item.text)
                want = len(tok.encode(text))
            elif kind == "user_image":
                want = 3 + (item.image.shape[0] // vp) * (item.image.shape[1] // vp) + 1
            elif kind == "model_image":
                want = 2 + p + (item.image_size[0] // vp) ** 2
            else:
                want = next(n_text) if stream == "cond" else b - a
            if a != end or b - a != want:
                bad.append(f"{stream} span {idx} {kind}: [{a}, {b}) want length {want}")
            end = b
    if streams == 2:
        delta = {c[3] - u[3] for c, u in zip(by["cond"], by["uncond"])}
        text = plan[0].text
        if delta != {len(tok.encode(text)) - len(tok.encode(remove_first_user_block(text)))}:
            bad.append(f"streams not in lockstep: {delta}")
    steps = [(s // vp) ** 2 // p for s in sides]
    layers, blocks = bundle.llm_cfg.num_hidden_layers, bundle.head.depth_latent
    want = {"decode_attention": sum(layers * streams * (1 + n) for n in steps),
            "fused_em_sample": sum(steps) if streams == 2 else 0,
            "fused_encode_tail": sum(i.source == "user" and i.type == "image" for i in plan),
            "fused_mlp_block": 0 if streams == 2 else blocks * (sample_steps + 1) * sum(steps),
            "fused_attn_block": 0 if streams == 2 else blocks * (sample_steps + 1) * sum(steps)}
    if {k: counts[k] for k in want} != want:
        bad.append(f"launches {dict((k, counts[k]) for k in want)} want {want}")
    return bad


def _check_decode_window(kv_len: int, seed: int, phase: str = "interleaved", b: int = 1,
                        hq: int = DECODE_SHAPE["hq"], hkv: int = DECODE_SHAPE["hkv"],
                        bound: float = DECODE_MAX_ABS_ERR["mid_decode"]) -> dict:
    """#1 at batch ``b``, ``hq`` / ``hkv`` heads and ``kv_len`` (the
    interleaved plans' longest at batch 1; the tp phase's local heads), one
    window of 64 queries over the whole cache: against its plain version
    with the window edges poisoned, a window off by one key moving the plain
    output by >= 4x the bound, two launches bit-equal; eager, device-only,
    plain and SDPA times, and the bound over the live keys."""
    import torch

    dev = torch.device("cuda")
    s, d = DECODE_SHAPE["s"], DECODE_SHAPE["d"]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, s, hq, d), generator=g, device=dev).bfloat16()
    k, v = (torch.randn((b, hkv, kv_len, d), generator=g, device=dev).bfloat16()
            for _ in range(2))
    kv_start = torch.zeros((b,), dtype=torch.int32, device=dev)
    n = torch.full((b,), kv_len, dtype=torch.int32, device=dev)
    bufs = _decode_buffers("bf16", k, _poison_window_edges(v, kv_start, n))
    with torch.no_grad():
        kernel, plain, library = _decode_fns("bf16", q, bufs, n, kv_start)
        got, again = kernel(), kernel()
        want = plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        same = torch.equal(got, again)
        shift = min((_decode_fns("bf16", q, bufs, nl, ns)[1]().float() - want.float())
                    .abs().max().item() for nl, ns in ((n - 1, kv_start),
                                                       (n, kv_start + 1)))
        t = {"ms": cuda_time_ms(kernel, 50), "device_ms": cuda_graph_time_ms(kernel),
             "plain_ms": cuda_time_ms(plain, 10), "library_ms": cuda_time_ms(library, 50)}
    t.update(roofline(nbytes(q, q) + 2 * b * hkv * d * 2 * kv_len,
                      4.0 * b * hq * s * d * kv_len))
    log(phase, f"decode_attention B={b} {hq}/{hkv} heads kv_len={kv_len}: max abs err {err:.3e} "
        f"(bound {bound}; a window off by one key moves the plain version by "
        f"{shift:.3e}); two launches bit-equal {same}; kernel {t['ms']:.4f} ms eager "
        f"({t['device_ms']:.4f} device-only), plain {t['plain_ms']:.4f} ms, "
        f"scaled_dot_product_attention {t['library_ms']:.4f} ms, bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    if not torch.isfinite(got).all() or err > bound or shift < 4 * bound or not same:
        raise SystemExit(f"{phase}: decode_attention at B={b} kv_len={kv_len}: err "
                         f"{err}, shift {shift}, bit-equal {same}")
    return {"max_abs_err": err, **t}


def _check_lm_logits_int8(llm_q, llm, dev) -> dict:
    """The int8 lm_logits (QLinear, one row: the padded torch._int_mm)
    against the same product in float64 on its dequantized operands, rounded
    to bf16 (LM_LOGITS_INT8_MAX_ULP_REL); its distance from the bf16
    lm_head's logits is reported."""
    import torch

    from bitdance_tpu_torch.models.qwen3 import lm_logits
    from bitdance_tpu_torch.ops.int8 import quantize_rows

    g = torch.Generator(device=dev).manual_seed(31)
    h = torch.randn((1, llm.cfg.hidden_size), generator=g, device=dev).bfloat16()
    with torch.no_grad():
        got = lm_logits(llm_q, h)
        xq, sx = quantize_rows(h)
        head = llm_q.lm_head
        exact = ((xq.double() * sx.double()[:, None])
                 @ (head.q.double() * head.s.double()[:, None]).t())
        want = exact.float().bfloat16().float()
        bf16 = lm_logits(llm, h)
        torch.cuda.synchronize()
        ms = cuda_time_ms(lambda: lm_logits(llm_q, h), 20)
        bf16_ms = cuda_time_ms(lambda: lm_logits(llm, h), 20)
    err = (got - want).abs()
    # a bf16 ulp of each entry: want = m 2^e, m in [0.5, 1) -> 2^(e - 8)
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - 8)
    worst = (err / ulp).max().item()
    equal = (err == 0).float().mean().item()
    vs_exact, vs_bf16 = _errors(got, exact)[1], _errors(got, bf16)[1]
    log("interleaved", f"lm_logits int8 [1, {h.shape[1]}] x [{head.q.shape[0]}, "
        f"{head.q.shape[1]}]: against float64 on the dequantized operands rounded to "
        f"bf16, {equal:.6f} of the logits bit-equal, the largest error {worst:g} bf16 "
        f"ulps of its logit (bound {LM_LOGITS_INT8_MAX_ULPS}); max error "
        f"{vs_exact:.3e} of max |logit| against the unrounded product; rel distance "
        f"from the bf16 lm_head's logits {vs_bf16:.3e} (reported); {ms:.4f} ms, bf16 "
        f"{bf16_ms:.4f} ms")
    if not torch.isfinite(got).all() or worst > LM_LOGITS_INT8_MAX_ULPS:
        raise SystemExit(f"interleaved: int8 lm_logits off by {worst} bf16 ulps")
    return {"max_ulps": worst, "bit_equal_share": equal, "ms": ms, "bf16_ms": bf16_ms}


def _run_interleaved_plans(bundle, tok, user_image, steps: int, card: str) -> dict:
    """Each plan of INTERLEAVED_PLANS through InterleavedGenerator, checked by
    _check_interleaved_run and logged (seconds per plan and per span, ms per
    text token, peak memory), then the int8 lm_logits check. The int8 copy of
    the LLM lives only in this function's frame, so it is freed when the
    function returns."""
    import dataclasses

    import torch

    from bitdance_tpu_torch.io.random_init import _module_tree_copy
    from bitdance_tpu_torch.models.qwen3 import quantize_qwen3_
    from bitdance_tpu_torch.pipelines.interleaved import InterleavedGenerator, plan_slots

    wrappers = _kernel_wrappers()
    names = ("decode_attention", "fused_em_sample", "fused_encode_tail",
             "fused_mlp_block", "fused_attn_block")
    launches = dict.fromkeys(names, 0)
    bundles = {"bf16": bundle}
    longest, runs = 0, {}
    for name, (cfg_scale, _, _, side, llm_mode) in INTERLEAVED_PLANS.items():
        if llm_mode not in bundles:
            llm_q = quantize_qwen3_(_module_tree_copy(bundle.llm), llm_mode)
            bundles[llm_mode] = dataclasses.replace(bundle, llm=llm_q)
        b = bundles[llm_mode]
        plan = _interleaved_plan(name, user_image)
        slots = plan_slots(plan, tok, b, INTERLEAVED_TEXT["max_length_text"])
        gen = InterleavedGenerator(b, tok, max_seq_len=slots)
        torch.cuda.reset_peak_memory_stats()
        for fn in wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(plan, cfg_scale=cfg_scale, sample_steps=steps, seed=0,
                           **INTERLEAVED_TEXT)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = {k: wrappers[k].launches for k in names}
        bad = _check_interleaved_run(gen, plan, out, tok, b, cfg_scale, counts, steps)
        for k in names:
            launches[k] += counts[k]
        longest = max([longest] + [e for *_, e in gen.last_spans])
        spans = {k: round(v, 4) for k, v in gen.last_timing.items() if k != "clock"}
        n_tok = [len(t.split()) for t in out["generated_text"]]
        text_s = sum(v for k, v in gen.last_timing.items() if k.endswith("model_text"))
        ms_tok = 1e3 * text_s / max(1, sum(n_tok))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log("interleaved", f"plan {name} ({llm_mode} LLM, cfg {cfg_scale}, {side} px "
            f"image, {steps} steps; cache {slots} slots): {dt:.3f} s; spans (s, CUDA "
            f"events) {json.dumps(spans)}; text tokens {n_tok} at {ms_tok:.2f} ms a "
            f"token; launches {json.dumps(counts)}; peak {peak:.2f} GiB; streams' ends "
            f"{[e for *_, e in gen.last_spans[-2:]]}; card {card}")
        if bad:
            raise SystemExit(f"interleaved plan {name} failed its checks: {bad}")
        runs[name] = {"s": dt, "spans": spans, "ms_per_text_token": ms_tok,
                      "text_tokens": n_tok, "peak_gib": peak}
    lm = _check_lm_logits_int8(bundles["int8"].llm, bundle.llm, torch.device("cuda"))
    return {"launches": launches, "runs": runs, "longest": longest, "lm_logits_int8": lm}


def phase_interleaved(bundle, card: str, user_image_u8) -> dict:
    """InterleavedGenerator on the full-depth bf16 bundle (with lm_head and
    VQ encoder): plan A (example_interleaved.py's order: chat text, the
    e2e phase's first 512 px image, 32 text tokens at temperature 1, top-k
    1200, top-p 0.95, a 512 px image, cfg 7.5, 50 steps), plan B (chat text
    and a 256 px image at cfg 1: one stream, the per-call head, #14 / #15 at
    64 x 5120), plan C (plan A with the int8 LLM and int8 lm_head, bf16
    head, a 256 px image), run by _run_interleaved_plans; then a profile of
    the text path, #14 and #15 at 64 x 5120 and #1 at batch 1 and the plans'
    longest kv_len against their plain versions."""
    import torch

    from bitdance_tpu_torch.pipelines.interleaved import InterleavedGenerator, plan_slots

    dev = torch.device("cuda")
    tok = StubTokenizer(bundle.parallel_num)
    user_image = user_image_u8.astype("float32") / 127.5 - 1.0
    plans = _run_interleaved_plans(bundle, tok, user_image, 50, card)
    gc.collect()
    torch.cuda.empty_cache()
    log("interleaved", f"int8 LLM copy freed: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")
    # where a text token's time goes: 8 tokens on both streams, profiled
    text_plan = _interleaved_plan("A", user_image)[::2]      # chat text, generated text
    gen = InterleavedGenerator(bundle, tok, max_seq_len=plan_slots(text_plan, tok, bundle, 8))
    text_kw = dict(INTERLEAVED_TEXT, max_length_text=8)
    prof = profile_run("interleaved", "chat text and 8 text tokens on two streams (bf16)",
                       lambda: gen.generate(text_plan, cfg_scale=7.5, seed=1, **text_kw),
                       lambda: f"spans {json.dumps(gen.last_timing)}")
    del gen
    gc.collect()
    torch.cuda.empty_cache()
    blk = bundle.head.net.res_blocks[0]
    rows = bundle.parallel_num
    # #15 at the path's one window of 64, then at two windows of 64 for the
    # window-off-by-one check
    checks = {"mlp": _check_mlp_block("14b", blk, blk.norm2, rows, dev, 41,
                                      phase="interleaved"),
              "attn": _attn_block_case(bundle, 1, rows, dev, 42, phase="interleaved"),
              "decode": _check_decode_window(plans["longest"], 43)}
    checks["attn"]["shapes"] = {"2x64": _attn_block_case(
        bundle, 2, rows, dev, 44, phase="interleaved")}
    return {"launches": plans["launches"], "runs": plans["runs"],
            "lm_logits_int8": plans["lm_logits_int8"], "text_profile": prof, **checks}


def _w4a8_case(w, m, dev, g, timed: bool = True) -> dict:
    """One W4A8 product at [m, K] x packed [N, K/2]: kernel vs plain (the
    same int8 rows, exact integer sums), and whether a second launch and
    every tile split 1 and w4a8_stages(K) ways give the same bits; timed: the kernel's
    time, the GEMM launch alone on the quantized rows (gemm_ms), the
    plain version's, bound, and torch._int_mm on the unpacked int8 weight
    (the same integer product, twice the bytes)."""
    import torch

    from bitdance_tpu_torch.ops.int4 import (
        int4_matmul,
        int4_matmul_reference,
        kernel_splits,
        unpack_int4,
        w4a8_quantize,
        w4a8_stages,
    )
    from bitdance_tpu_torch.ops.int8 import quantize_rows

    n, kh = w.q.shape
    x = torch.randn((m, 2 * kh), generator=g, device=dev).bfloat16()
    got = int4_matmul(x, w)
    others = [int4_matmul(x, w), int4_matmul(x, w, n_splits=1),
              int4_matmul(x, w, n_splits=w4a8_stages(2 * kh))]
    xq, sx = quantize_rows(x)
    want = int4_matmul_reference(xq, sx, w.q, w.s, torch.bfloat16)
    torch.cuda.synchronize()
    err, rel = _errors(got, want)
    out = {"err": err, "rel": rel, "equal": all(torch.equal(o, got) for o in others),
           "splits": kernel_splits(m, n, 2 * kh, dev)}
    if timed:
        w8 = torch.cat(unpack_int4(w.q), dim=1)                 # [N, K] int8
        rows = w4a8_quantize(x)                             # the GEMM alone
        out.update({
            "ms": cuda_time_ms(lambda: int4_matmul(x, w), 20),
            "gemm_ms": cuda_time_ms(lambda: int4_matmul(x, w, rows=rows), 20),
            "plain_ms": cuda_time_ms(lambda: int4_matmul_reference(
                *quantize_rows(x), w.q, w.s, torch.bfloat16), 5),
            "library_ms": cuda_time_ms(lambda: torch._int_mm(xq, w8.t()), 20),
            "bytes": nbytes(x, w.q, w.s, got), "ops": 2.0 * m * n * 2 * kh})
    return out


def w4a8_layers(q4, n_layers: int, dev, g) -> list:
    """Random packed weights of n_layers Qwen3-14B layers (QWEN3_14B_PROJS;
    uniform bytes, scales in [1e-4, 1.1e-3]) as ``q4.Q4Tensor``s, for timing
    walks: the products' time does not depend on the values."""
    import torch

    return [{name: q4.Q4Tensor(
        q=torch.randint(-128, 128, (n, k // 2), generator=g, device=dev, dtype=torch.int8),
        s=torch.rand((n,), generator=g, device=dev) * 1e-3 + 1e-4)
        for name, (n, k) in QWEN3_14B_PROJS.items()} for _ in range(n_layers)]


def w4a8_walk_ms(run, layers) -> float:
    """Device ms per layer of ``run(name, weight)`` over the seven
    projections of each layer in layer order, captured as one CUDA graph
    and replayed 5 times (device time: the eager walk would time the host
    between short products): with W4A8_COLD_LAYERS layers every weight
    arrives cold from HBM."""
    def walk():
        for lw in layers:
            for name, w in lw.items():
                run(name, w)

    return cuda_graph_time_ms(walk, calls=1, reps=5) / len(layers)


def w4a8_cold(q4, dev, g, m: int = 128) -> dict:
    """cold_ms and library_cold_ms: ``q4.int4_matmul`` and torch._int_mm on
    the unpacked int8 weights, seven products a layer in layer order over
    W4A8_COLD_LAYERS layers, per layer."""
    import torch

    layers = w4a8_layers(q4, W4A8_COLD_LAYERS, dev, g)
    xs = {k: torch.randn((m, k), generator=g, device=dev).bfloat16() for k in (5120, 17408)}
    cold = w4a8_walk_ms(lambda name, w: q4.int4_matmul(xs[QWEN3_14B_PROJS[name][1]], w), layers)
    xqs = {k: torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
           for k in xs}
    unpacked = [{name: torch.cat(q4.unpack_int4(w.q), dim=1) for name, w in lw.items()}
                for lw in layers]
    del layers
    lib = w4a8_walk_ms(lambda name, w8: torch._int_mm(xqs[w8.shape[1]], w8.t()), unpacked)
    return {"cold_ms": cold, "library_cold_ms": lib}


def _w4a8_sweep(dev, g) -> None:
    """Device ms (captured CUDA graphs) of each projection at M 128 at the
    schedule w4a8_splits picks and with every tile split 1 to all stages
    ways (down_proj: 1-24, 34, 68)."""
    import torch

    from bitdance_tpu_torch.ops import int4

    layer = w4a8_layers(int4, 1, dev, g)[0]
    for name, (n, k) in QWEN3_14B_PROJS.items():
        if name in ("v_proj", "up_proj"):          # the same shapes as k_proj, gate_proj
            continue
        x = torch.randn((128, k), generator=g, device=dev).bfloat16()
        w = layer[name]
        top = int4.w4a8_stages(k)
        counts = range(1, top + 1) if top <= 40 else [*range(1, 25), 34, 68]
        picked = cuda_graph_time_ms(lambda: int4.int4_matmul(x, w), calls=10)
        ms = {c: cuda_graph_time_ms(lambda c=c: int4.int4_matmul(x, w, n_splits=c), calls=10)
              for c in counts}
        log("quant_kernels", f"w4a8_matmul split sweep {name} M=128 N={n} K={k}: picks "
            f"(tail_from, n_splits) {int4.kernel_splits(128, n, k, dev)}, {picked:.4f} ms; "
            "every tile split, device ms at n_splits "
            + ", ".join(f"{c}: {t:.4f}" for c, t in ms.items()))


def _check_w4a8(bundle, dev) -> dict:
    """K1 at the seven projections of layer 0 (quantized to int4 here) for
    the AR step's 128 rows and the first prefill pass's 132, a ragged 5 and
    300 (three token chunks): 0 error against plain, two launches and every
    tile split 1 and all stages ways bit-equal; times at 128 and 132; the
    cold walk, the split sweep and the host time of one call."""
    import torch

    from bitdance_tpu_torch.ops import int4

    g = torch.Generator(device=dev).manual_seed(11)
    layer = bundle.llm.model.layers[0]
    projs = {name: getattr(getattr(layer, part), name) for part, names in (
        ("self_attn", ("q_proj", "k_proj", "v_proj", "o_proj")),
        ("mlp", ("gate_proj", "up_proj", "down_proj"))) for name in names}
    tot = {"ms": 0.0, "gemm_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0,
           "ops": 0.0}
    worst, splits = 0.0, {}
    for name, lin in projs.items():
        w = int4.quantize_linear_int4(lin.weight)
        for m in (128, 132, 5, 300):
            c = _w4a8_case(w, m, dev, g, timed=m in (128, 132))
            msg = (f"w4a8_matmul {name} M={m} N={w.q.shape[0]} K={2 * w.q.shape[1]}: "
                   f"max abs err {c['err']:.3e} (must be 0), second launch and every "
                   f"tile split 1 / all stages ways bit-equal {c['equal']}, (tail_from, "
                   f"n_splits) {c['splits']}")
            if "ms" in c:
                bd = roofline(c["bytes"], 0.0, c["ops"])
                msg += (f"; kernel {c['ms']:.4f} ms (GEMM alone {c['gemm_ms']:.4f}), plain "
                        f"{c['plain_ms']:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                        f"({bd['bound_by']}), torch._int_mm on int8 weights "
                        f"{c['library_ms']:.4f} ms")
            log("quant_kernels", msg)
            if c["err"] != 0 or not c["equal"]:
                raise SystemExit(f"w4a8_matmul {name} M={m}: err {c['err']}, "
                                 f"bit-equal {c['equal']}")
            worst = max(worst, c["err"])
            if m == 128:
                splits[name] = c["splits"]
                for k in tot:
                    tot[k] += c[k]
    bd = roofline(tot.pop("bytes"), 0.0, tot.pop("ops"))
    cold = w4a8_cold(int4, dev, g)
    x = torch.randn((128, 5120), generator=g, device=dev).bfloat16()
    wk = int4.quantize_linear_int4(projs["k_proj"].weight)
    host = host_us(lambda: int4.int4_matmul(x, wk))
    log("quant_kernels", f"w4a8_matmul, one layer's seven products at M=128: "
        f"kernel {tot['ms']:.4f} ms warm, {cold['cold_ms']:.4f} cold "
        f"({W4A8_COLD_LAYERS} layers in turn); GEMM alone {tot['gemm_ms']:.4f}; plain "
        f"{tot['plain_ms']:.4f} ms; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); "
        f"torch._int_mm {tot['library_ms']:.4f} warm, {cold['library_cold_ms']:.4f} cold; "
        f"n_splits {json.dumps(splits)}; host {host:.1f} us a k_proj call")
    _w4a8_sweep(dev, g)
    return {"max_abs_err": worst, **tot, **bd, **cold, "splits": splits}


def w4a8_shapes_seen() -> list:
    """The distinct (M, N, K) int4_matmul has been called with since its
    per-shape cache (int4._CALLS) was last cleared."""
    from bitdance_tpu_torch.ops import int4

    return sorted({(call[0], key[3], key[0][-1]) for key, call in int4._CALLS.items()})


def _check_w4a8_seen(bundle, shapes, dev) -> None:
    """K1 at each (M, N, K) the int4 requests gave it, on the int4 bundle's
    layer-0 weight of that shape: 0 error, two launches bit-equal."""
    import torch

    from bitdance_tpu_torch.models.qwen3 import Q4Linear
    from bitdance_tpu_torch.ops.int4 import int4_matmul, int4_matmul_reference
    from bitdance_tpu_torch.ops.int8 import quantize_rows

    g = torch.Generator(device=dev).manual_seed(13)
    weights = {}
    for mod in bundle.llm.model.layers[0].modules():
        if isinstance(mod, Q4Linear):
            n, kh = mod.weight_q.q.shape
            weights.setdefault((n, 2 * kh), mod.weight_q)
    for m, n, k in shapes:
        w = weights[(n, k)]
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        got, again = int4_matmul(x, w), int4_matmul(x, w)
        want = int4_matmul_reference(*quantize_rows(x), w.q, w.s, torch.bfloat16)
        torch.cuda.synchronize()
        err = _errors(got, want)[0]
        log("e2e_quant", f"w4a8_matmul at the requests' M={m} N={n} K={k}: max abs err "
            f"{err:.3e}, two launches bit-equal {torch.equal(got, again)}")
        if err != 0 or not torch.equal(got, again):
            raise SystemExit(f"w4a8_matmul M={m} N={n} K={k}: err {err}")


def _check_decode_fusedkv(dev) -> dict:
    """K2 on a fused bf16 buffer and an int8 one (quantized from the same
    k, v) at the decode windows of phase_decode_attention; the int8
    buffer's record."""
    _check_decode("fused_bf16", 12, "quant_kernels")
    return _check_decode("int8", 12, "quant_kernels")


def _quant_gemm_operands(stacked, key, rows, quant, g, dev, products=QUANT_GEMM_PRODUCTS):
    """One integer block product at ``rows``: its logical K, int8 rows of x ~
    N(0, 1) with their scales (quantize_rows), and for the gated modes a
    residual ~ N(0, 1) ("gated": bf16 values) and a gate ~ N(0, 0.25) whose
    rows lie apart as the sampler's mods do."""
    import torch

    from bitdance_tpu_torch.ops.int8 import quantize_rows

    n, kw_ = stacked[key].shape[1:]
    k = kw_ * (2 if quant == "int4" else 1)
    aq, sa = quantize_rows(torch.randn((rows, k), generator=g, device=dev))
    kw = {}
    mode = products[key][0]
    if mode.startswith("gated"):
        kw["resid"] = torch.randn((rows, n), generator=g, device=dev)
        if mode == "gated":
            kw["resid"] = kw["resid"].bfloat16().float()
        kw["gate"] = (0.5 * torch.randn((rows, 3 * n), generator=g, device=dev)
                      ).bfloat16()[:, n:2 * n]
    return k, aq, sa, kw


def quant_gemm_walk(stacked, key, aq, sa, kw, plan, quant, products=QUANT_GEMM_PRODUCTS):
    """The integer product over every block's weights in turn (cold L2: the
    quantized stack is larger than the L2): a callable."""
    from bitdance_tpu_torch.ops.fused_head import head_gemm_s8

    mode, bkey = products[key]
    w, ws, b = stacked[key], stacked[key + "_s"], stacked[bkey]
    return lambda: [head_gemm_s8(aq, sa, w[l], ws[l], mode, b[l], plan=plan, quant=quant, **kw)
                    for l in range(w.shape[0])]


def int_mm_walk(stacked, key, aq, quant):
    """torch._int_mm at the same shape over the same walk, on int8 weights
    (int4: the unpacked planes, twice the bytes, as #16 is timed)."""
    import torch

    from bitdance_tpu_torch.ops.int4 import unpack_int4

    w = stacked[key]
    w8 = [torch.cat(unpack_int4(w[l]), dim=1) if quant == "int4" else w[l]
          for l in range(w.shape[0])]
    return lambda: [torch._int_mm(aq, m.t()) for m in w8]


def quant_gemm_bound(aq, sa, w, ws, mode, kw) -> dict:
    """One integer product: rows, scales, weights and bias read, the output
    written (the gated modes read the gate and read and write the residual;
    "swiglu_q" writes fp32, "swiglu_round" bf16), 2 R N K integer
    operations at the int8 peak (a packed int4 byte holds two weights)."""
    rows, k = aq.shape
    n = w.shape[0]
    out = {"bias": rows * n * 2, "swiglu_q": rows * (n // 2) * 4,
           "swiglu_round": rows * (n // 2) * 2}.get(mode, 0)
    extra = (nbytes(kw["gate"]) + 2 * nbytes(kw["resid"])) if mode.startswith("gated") else out
    return roofline(nbytes(aq, sa, w, ws) + 2 * n + extra, 0.0, 2.0 * rows * n * k)


def _check_quant_gemm(mode, stacked, rows, dev, seed, products=QUANT_GEMM_PRODUCTS,
                      phase="quant_kernels", name="") -> dict:
    """Each integer head GEMM product of block 0 at ``rows`` (the keys of
    ``products`` the stack holds: four, or the MlpEncoder's w1 and w2)
    against its plain twin: bit-equal at the planned, 1 and the most splits
    (up to 8, a power of two), two launches bit-equal, and an activation row
    (with its scale), an output column (with its scale) and a K stage of
    128 columns off by one each moving the twin by >= QUANT_GEMM_MOVE. Then
    eager and device-only ms a product over every block's weights in turn
    (cold L2), torch._int_mm on the same walk, the bound; for int4's wo also
    #16's swap-AB register-A GEMM (csrc/w4a8.cu, launched alone on the same
    rows) on the same walk."""
    import torch

    from bitdance_tpu_torch.ops import int4 as q4
    from bitdance_tpu_torch.ops.fused_head import (
        HEAD_GEMM_MAX_SPLITS,
        head_gemm_plan,
        head_gemm_s8,
        head_gemm_s8_split_plain,
        head_gemm_stages,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for key, (gmode, bkey) in products.items():
        if key not in stacked:
            continue
        w, ws, bias = stacked[key][0], stacked[key + "_s"][0], stacked[bkey][0]
        n = w.shape[0]
        k, aq, sa, kw = _quant_gemm_operands(stacked, key, rows, mode, g, dev, products)
        plan = head_gemm_plan(rows, n, k, sms, mode)
        top = min(HEAD_GEMM_MAX_SPLITS, head_gemm_stages(k, mode))
        counts = sorted({plan.splits, 1, 1 << (top.bit_length() - 1)})

        def run(splits):   # the gated residual is updated in place: a fresh copy
            fresh = {q: v.clone() if q == "resid" else v for q, v in kw.items()}
            return head_gemm_s8(aq, sa, w, ws, gmode, bias, plan=plan._replace(splits=splits),
                                quant=mode, **fresh)

        def twin(aq=aq, sa=sa, w=w, ws=ws, splits=plan.splits):
            return head_gemm_s8_split_plain(aq, sa, w, ws, gmode, bias, splits=splits,
                                            quant=mode, **kw)

        want = twin()
        equal = {c: torch.equal(run(c), want) for c in counts}
        same = torch.equal(run(plan.splits), run(plan.splits))
        moved = {"row": _errors(twin(aq=aq.roll(1, 0), sa=sa.roll(1, 0)), want)[1],
                 "column": _errors(twin(w=w.roll(1, 0), ws=ws.roll(1, 0)), want)[1],
                 "k_stage": _errors(twin(aq=aq.roll(128, 1)), want)[1]}
        blocks = stacked[key].shape[0]
        walk = quant_gemm_walk(stacked, key, aq, sa, kw, plan, mode, products)
        lib = int_mm_walk(stacked, key, aq, mode)
        rec = {"mode": gmode, "splits": plan.splits, "bit_equal": equal,
               "ms": cuda_time_ms(walk, 10) / blocks,
               "device_ms": cuda_graph_time_ms(walk, calls=4, reps=3) / blocks,
               "library_ms": cuda_time_ms(lib, 10) / blocks,
               "library_device_ms": cuda_graph_time_ms(lib, calls=4, reps=3) / blocks,
               **quant_gemm_bound(aq, sa, w, ws, gmode, kw)}
        del lib
        if mode == "int4" and key == "wo" and products is QUANT_GEMM_PRODUCTS:
            x = torch.randn((rows, k), generator=g, device=dev).bfloat16()
            xr = q4.w4a8_quantize(x)
            wts = [q4.Q4Tensor(stacked[key][l], stacked[key + "_s"][l]) for l in range(blocks)]
            rec["swap_ab_device_ms"] = cuda_graph_time_ms(
                lambda: [q4.int4_matmul(x, q, rows=xr) for q in wts], calls=4, reps=3) / blocks
        log(phase, f"head_gemm_s8 {name}{mode} {key} ({gmode}) R={rows} [{n}, {k}], plan "
            f"bm {plan.bm} bn {plan.bn} x {plan.splits} split(s): bit-equal to the twin at "
            + ", ".join(f"{c} split(s) {v}" for c, v in equal.items())
            + "; off by one: " + ", ".join(f"{q} {v:.3e}" for q, v in moved.items())
            + f" (>= {QUANT_GEMM_MOVE:g}); 2 launches bit-equal {same}; cold L2 over {blocks} "
            f"blocks: {rec['ms']:.4f} ms eager, {rec['device_ms']:.4f} device-only; "
            f"torch._int_mm {rec['library_ms']:.4f} / {rec['library_device_ms']:.4f}; bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})"
            + (f"; #16's swap-AB GEMM on the same walk {rec['swap_ab_device_ms']:.4f} "
               "device-only" if "swap_ab_device_ms" in rec else ""))
        if not all(equal.values()) or not same or min(moved.values()) < QUANT_GEMM_MOVE:
            raise SystemExit(f"head_gemm_s8 {mode} {key}: bit-equal {equal}, again {same}, "
                             f"off by one {moved}")
        out[key] = rec
    return out


def _check_quant_sampler(bundle, mode, dev) -> dict:
    """K3: the sampler's W8A8 / W4A8 mode at the 14B head, stacks quantized
    from the bundle's bf16 head: 4 steps at R = 128 against the plain quant
    sampler, then 50 steps (sign agreement, eager and device-only times with
    and without PDL, the bound, launches a net call, one net call by stage),
    then its four integer products (_check_quant_gemm)."""
    import torch

    from bitdance_tpu_torch.ops.fused_head import (
        fused_em_sample,
        fused_em_sample_reference,
        stack_diffnet_params,
    )

    head = bundle.head
    stacked = stack_diffnet_params(head.net, head.depth_latent, torch.bfloat16,
                                   quant="int4" if mode == "int4" else True)
    kw = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
              n_head=head.ch_latent // head.attn_head_dim, groups=2,
              last_step_size=0.05, quant=mode)
    cfg = 7.5
    x0, noise, mods, t_all, dt_all = _head_inputs(stacked, head, 4, 21, dev)
    got = fused_em_sample(stacked, x0, noise, mods, t_all, dt_all, cfg, **kw)
    want = fused_em_sample_reference(stacked, x0, noise, mods, t_all, dt_all, cfg, **kw)
    torch.cuda.synchronize()
    err, rel = _errors(got, want)
    x0, noise, mods, t_all, dt_all = _head_inputs(stacked, head, 50, 22, dev)
    run_k = lambda: fused_em_sample(stacked, x0, noise, mods, t_all,  # noqa: E731
                                    dt_all, cfg, **kw)
    run_p = lambda: fused_em_sample_reference(stacked, x0, noise, mods,  # noqa: E731
                                              t_all, dt_all, cfg, **kw)
    xk, xp = run_k(), run_p()
    agree = (torch.sign(xk) == torch.sign(xp)).float().mean().item()
    ms = cuda_time_ms(run_k, 3, warmup=1)
    pms = cuda_time_ms(run_p, 1, warmup=1)
    times = sampler_times(lambda pdl: fused_em_sample(stacked, x0, noise, mods, t_all,
                                                      dt_all, cfg, _pdl=pdl, **kw))
    per_net = _sampler_launches(lambda s: fused_em_sample(
        stacked, x0, noise[:s], mods[:s + 1], t_all, dt_all, cfg, **kw))
    want_net = sampler_net_launches(kw["num_blocks"], True, mode)
    stages = net_call_profile(lambda s: fused_em_sample(
        stacked, x0, noise[:s], mods[:s + 1], t_all, dt_all, cfg, _pdl=False, **kw))
    bd = sampler_bound(stacked, x0, noise, mods, attention=True, groups=2,
                       window=head.parallel_num, quant=mode)
    wbytes = nbytes(*[stacked[k] for k in ("wqkv", "wo", "w1", "w2")])
    calls = mods.shape[0]
    log("quant_kernels", f"fused_em_sample {mode} (block weights {wbytes / 1e9:.3f} "
        f"GB): 4 steps max abs err {err:.3e}, rel {rel:.3e} (bound "
        f"{QUANT_SAMPLER_MAX_REL_ERR}); 50 steps: kernel {ms:.2f} ms "
        f"({ms / calls:.4f} per net call; "
        + ", ".join(f"{q} {v / calls:.4f}" for q, v in times.items())
        + f"), plain {pms:.2f} ms, bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}; "
        f"{bd['bound_ms'] / calls:.4f} per net call); +-1 agreement {agree:.4f} (floor "
        f"{SAMPLER_SIGN_AGREEMENT_FLOOR}); {per_net:g} launches per net call (captured; "
        f"formula {want_net}); one net call by kernel (profiled, us): "
        + ", ".join(f"{q} {v:.1f}" for q, v in stages.items()))
    if (not torch.isfinite(xk).all() or rel > QUANT_SAMPLER_MAX_REL_ERR
            or agree < SAMPLER_SIGN_AGREEMENT_FLOOR):
        raise SystemExit(f"fused_em_sample {mode}: rel {rel}, agreement {agree}")
    if per_net != want_net:
        raise SystemExit(f"fused_em_sample {mode}: {per_net} launches per net call, want "
                         f"{want_net}")
    products = _check_quant_gemm(mode, stacked, 128, dev, 23)
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bd, "library_ms": None,
            **times, "launches_per_net_call": per_net, "products": products}


def phase_quant_kernels(bundle) -> dict:
    import torch

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    with torch.no_grad():
        out = {"w4a8_matmul": _check_w4a8(bundle, dev),
               "decode_attention_fusedkv": _check_decode_fusedkv(dev),
               "fused_em_sample_int8": _check_quant_sampler(bundle, "int8", dev),
               "fused_em_sample_int4": _check_quant_sampler(bundle, "int4", dev)}
    gc.collect()
    torch.cuda.empty_cache()
    log("quant_kernels", f"done in {time.perf_counter() - t0:.1f} s")
    return out


def _quant_gib(bundle) -> float:
    """GiB of the quantized weights: the LLM's int8 / packed buffers with
    their scales and the head's quantized stack (block matrices, modcat)."""
    from bitdance_tpu_torch.models.qwen3 import QEmbedding, QLinear

    st = bundle.head_stacked
    n = sum(nbytes(m.q, m.s) for m in bundle.llm.modules()
            if isinstance(m, (QLinear, QEmbedding)))
    n += nbytes(*[st[k] for k in st if k.endswith("_s") or st[k].dtype.itemsize == 1])
    return n / 2**30


def _quant_request(pipe, prompt, px, seed, bf16_tok, card, tag) -> dict:
    import numpy as np
    import torch

    layers = pipe.bundle.llm_cfg.num_hidden_layers
    steps = (px // 16) ** 2 // pipe.bundle.parallel_num
    int4 = tag == "int4"
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, tok = pipe.generate(prompt, px, px, num_sampling_steps=50, guidance_scale=7.5,
                             num_images=1, seed=seed, return_tokens=True)
    dt = time.perf_counter() - t0
    got = _counts()
    want = {"w4a8_matmul": 7 * layers * (2 + steps) if int4 else 0,
            "decode_attention_fusedkv": layers * (1 + steps),
            "fused_em_sample": steps, "decode_attention": 0}
    tok = torch.from_numpy(tok)
    agree = (tok == bf16_tok).float().mean().item()
    p = pipe.bundle.parallel_num        # the first AR step's tokens: no feedback yet
    agree1 = (tok[:, :p] == bf16_tok[:, :p]).float().mean().item()
    timing = {k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in pipe.last_timing.items()}
    log("e2e_quant", f"{tag} {px}x{px}, 50 steps, cfg 7.5: {dt:.3f} s/image; "
        f"last_timing {json.dumps(timing)}; launches "
        + ", ".join(f"{k} +{got[k]} (want {v})" for k, v in want.items())
        + f"; +-1 agreement with the bf16 tokens of the same prompt and seed "
        f"{agree:.4f} (first AR step {agree1:.4f}); image {img.shape} mean "
        f"{img.mean():.2f}; card {card}")
    ok = (img.dtype == np.uint8 and img.shape == (1, px, px, 3)
          and tuple(tok.shape) == (1, (px // 16) ** 2, 32)
          and set(tok.unique().tolist()) <= {-1.0, 1.0}
          and all(got[k] == v for k, v in want.items()))
    if not ok:
        raise SystemExit(f"e2e_quant {tag} {px}px request failed its checks")
    return {"tokens": tok, "launches": {k: got[k] for k in want}, "s": dt, "px": px,
            "timing": timing}


def phase_e2e_quant(bundle, card: str, bf16_tokens: list) -> dict:
    """The int8 configuration from a module-tree copy of the bf16 bundle
    (the bf16 weights stay), one request, freed; then the int4 flagship
    converted in place, three requests. Returns the kernels' launches
    ("launches") and each request's s/image and phases ("requests")."""
    import torch

    from bitdance_tpu_torch.io.random_init import quantize_bundle_
    from bitdance_tpu_torch.ops import int4
    from bitdance_tpu_torch.pipelines.t2i import T2IPipeline

    tok = StubTokenizer(bundle.parallel_num)
    runs = {}
    for tag in ("int8", "int4"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qb = quantize_bundle_(bundle, tag, keep_source=tag == "int8")
        torch.cuda.synchronize()
        log("e2e_quant", f"{tag} bundle quantized layer by layer in "
            f"{time.perf_counter() - t0:.1f} s: quantized weights "
            f"{_quant_gib(qb):.2f} GiB; {torch.cuda.memory_allocated() / 2**30:.2f} "
            "GiB allocated")
        pipe = T2IPipeline(qb, tok, kv_int8=True)
        torch.cuda.reset_peak_memory_stats()
        reqs = E2E_REQUESTS[:1] if tag == "int8" else E2E_REQUESTS
        int4._CALLS.clear()                 # so the calls planned are the requests'
        runs[tag] = [_quant_request(pipe, prompt, px, seed, bf16_tokens[i], card, tag)
                     for i, (prompt, px, seed) in enumerate(reqs)]
        log("e2e_quant", f"{tag}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if tag == "int4":
            shapes = w4a8_shapes_seen()
            log("e2e_quant", f"int4_matmul's (M, N, K) on the int4 requests: {shapes}")
            if not {128, 132} <= {m for m, _, _ in shapes}:
                raise SystemExit(f"e2e_quant: int4 requests gave M {shapes}")
            _check_w4a8_seen(qb, shapes, torch.device("cuda"))
            profile_run("e2e_quant", f"int4 {PROFILE_PX} px request",
                        lambda: pipe.generate("profile request", PROFILE_PX, PROFILE_PX,
                                              seed=8),
                        lambda: f"last_timing {json.dumps(pipe.last_timing)}")
        del qb, pipe
        gc.collect()
        torch.cuda.empty_cache()
    same = (runs["int4"][0]["tokens"] == runs["int8"][0]["tokens"]).float().mean().item()
    log("e2e_quant", f"int4 vs int8 tokens of the same 512 px request: +-1 "
        f"agreement {same:.4f} (the grids must differ)")
    if same == 1.0:
        raise SystemExit("e2e_quant: the int4 and int8 token grids are identical")
    total = lambda tag, k: sum(r["launches"][k] for r in runs[tag])  # noqa: E731
    return {"launches": {"w4a8_matmul": total("int4", "w4a8_matmul"),
                         "decode_attention_fusedkv": total("int4", "decode_attention_fusedkv")
                         + total("int8", "decode_attention_fusedkv"),
                         "fused_em_sample_int8": total("int8", "fused_em_sample"),
                         "fused_em_sample_int4": total("int4", "fused_em_sample")},
            "requests": [{"tag": tag, "px": r["px"], "s_per_image": r["s"],
                          "timing": r["timing"]} for tag in runs for r in runs[tag]]}


def profile_run(phase: str, what: str, run, extra=lambda: "") -> dict:
    """torch.profiler over one call of ``run``: device busy and idle share
    from the union of kernel intervals, and the top kernels by time (logged
    and returned)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    by_name: dict = {}
    for e in kern:
        ms_n = by_name.setdefault(e.name, [0.0, 0])
        ms_n[0] += e.time_range.elapsed_us() / 1e3
        ms_n[1] += 1
    rows = sorted(((k, v[0], v[1]) for k, v in by_name.items()),
                  key=lambda r: -r[1])
    spans = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy_us, cur_s, cur_e = 0.0, None, None
    for a, b in spans:                     # union of kernel intervals
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    first, last = spans[0][0], max(b for _, b in spans)
    log(phase, f"{what}: wall {wall:.3f} s; device busy "
        f"{busy_us / 1e6:.3f} s of the {(last - first) / 1e6:.3f} s from first "
        f"to last kernel (idle share {1 - busy_us / (last - first):.4f}); "
        f"kernel time sum {sum(r[1] for r in rows) / 1e3:.3f} s in {len(kern)} "
        f"kernels; {extra()}")
    groups: dict = {}
    for name, ms, n in rows:
        group = next((g for g, keys in PROFILE_GROUPS if any(k in name for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + ms
    log(phase, "kernel time by group: " + ", ".join(
        f"{g} {ms:.2f} ms" for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
    for name, ms, n in rows[:20]:
        log(phase, f"{ms:10.2f} ms  {n:7d}x  {name[:110]}")
    return {"wall_s": wall, "busy_s": busy_us / 1e6, "span_s": (last - first) / 1e6,
            "idle_share": 1 - busy_us / (last - first), "kernels": len(kern),
            "group_ms": groups}


def _flash_case(name: str, dev):
    """(q, k, v, do, ids, wrong) of one comparison case, bf16, from a seed.
    ``wrong`` are id sets that put a mask off by one: the query's own block
    hidden (kb < qb) or a neighbour document seen."""
    import torch

    from bitdance_tpu_torch.models.imagenet_ar import config_b, config_h, train_ids

    g = torch.Generator(device=dev).manual_seed(sum(map(ord, name)))
    if name in ("path", "b16x"):
        cfg = config_h() if name == "path" else config_b(parallel_num=16)
        b, hq, hkv, d = 16, cfg.n_head, cfg.n_head, cfg.head_dim
        block, doc = train_ids(cfg, dev)
    elif name == "packed":
        b, hq, hkv, d = 4, 16, 16, 64
        lens = (300, 340)
        block = torch.cat([torch.arange(n, device=dev) for n in lens])
        doc = torch.cat([torch.full((n,), i, device=dev) for i, n in enumerate(lens)])
    else:                                   # Qwen3-style GQA training shape
        b, hq, hkv, d = 2, 40, 8, 128
        block = torch.arange(1000, device=dev)
        doc = torch.zeros_like(block)
    block, doc = block.int(), doc.int()
    L = block.shape[0]
    q = torch.randn((b, L, hq, d), generator=g, device=dev).bfloat16()
    k = torch.randn((b, L, hkv, d), generator=g, device=dev).bfloat16()
    v = torch.randn((b, L, hkv, d), generator=g, device=dev)
    do = torch.randn((b, L, hq, d), generator=g, device=dev).bfloat16()
    # the first and last key of every document, and of every window where
    # blocks are windows, get a large v (not where every key is its own block:
    # a constant v would make o independent of the mask)
    first = torch.ones(L, dtype=torch.bool, device=dev)
    first[1:] = doc[1:] != doc[:-1]
    if (block[1:] == block[:-1]).any():
        first[1:] |= block[1:] != block[:-1]
    v[:, first | torch.roll(first, -1)] = FLASH_EDGE_V
    ids = tuple(t.expand(b, L) for t in (block, doc, block, doc))
    wrong = [tuple(t.expand(b, L) for t in (block - 1, doc, block, doc))]
    if int(doc.max()) > 0:                  # doc 1 also sees doc 0
        wrong.append(tuple(t.expand(b, L) for t in (block, doc, block, doc.clamp(min=1))))
    return q, k, v.bfloat16(), do, ids, wrong


def phase_flash_attention() -> dict:
    import torch

    from bitdance_tpu_torch.ops.attention import (
        flash_attention_reference,
        flash_bwd_dkv,
        flash_bwd_dkv_reference,
        flash_bwd_dq,
        flash_bwd_dq_reference,
        flash_fwd,
    )

    dev = torch.device("cuda")
    records = {}
    for name, bounds in FLASH_MAX_REL_ERR.items():
        q, k, v, do, ids, wrong = _flash_case(name, dev)
        d = q.shape[-1]
        scale = d ** -0.5
        o, lse = flash_fwd(q, k, v, *ids, scale)
        qr, kr, vr = (t.float().requires_grad_() for t in (q, k, v))
        o_ref, lse_ref = flash_attention_reference(qr, kr, vr, *ids, return_lse=True)
        o_ref.backward(do.float())
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq(q, k, v, do, lse, delta, *ids, scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, *ids, scale)
        torch.cuda.synchronize()
        errs, rel = {}, {}
        for key, got, want in (("o", o, o_ref), ("lse", lse, lse_ref),
                               ("dq", dq, qr.grad), ("dk", dk, kr.grad),
                               ("dv", dv, vr.grad)):
            if not torch.isfinite(got).all():
                raise SystemExit(f"flash_attention {name}: {key} not finite")
            errs[key] = (got.float() - want.float()).abs().max().item()
            rel[key] = errs[key] / want.float().abs().max().item()
        with torch.no_grad():   # how far a mask off by one moves o, relative
            shift = min((flash_attention_reference(qr, kr, vr, *w) - o_ref)
                        .abs().max().item() for w in wrong)
            shift /= o_ref.abs().max().item()
        bad = [key for key, e in rel.items() if e > bounds[key]]
        if bad or shift < 4 * bounds["o"]:
            raise SystemExit(f"flash_attention {name}: rel errors {rel} (bounds "
                             f"{bounds}); a mask off by one moves o by {shift}")
        # two launches of each kernel give the same bits
        with torch.no_grad():
            same = {"fwd": all(map(torch.equal, (o, lse), flash_fwd(q, k, v, *ids, scale))),
                    "dq": torch.equal(dq, flash_bwd_dq(q, k, v, do, lse, delta, *ids,
                                                       scale)),
                    "dkv": all(map(torch.equal, (dk, dv), flash_bwd_dkv(
                        q, k, v, do, lse, delta, *ids, scale)))}
        if not all(same.values()):
            raise SystemExit(f"flash_attention {name}: two launches differ {same}")
        rec = {"errs": errs}
        # the wrappers timed on the ids as the autograd Function hands them
        # (int32 [B, L] contiguous, made once by the forward): eager over 20
        # calls (the record's ms), device-only from a captured graph, and
        # the host time a call
        pids = tuple(t.contiguous() for t in ids)
        fns = {"fwd": (lambda: flash_fwd(q, k, v, *pids, scale),
                       lambda: flash_attention_reference(q, k, v, *ids, scale,
                                                         return_lse=True)),
               "dq": (lambda: flash_bwd_dq(q, k, v, do, lse, delta, *pids, scale),
                      lambda: flash_bwd_dq_reference(q, k, v, do, lse, delta, *ids,
                                                     scale)),
               "dkv": (lambda: flash_bwd_dkv(q, k, v, do, lse, delta, *pids, scale),
                       lambda: flash_bwd_dkv_reference(q, k, v, do, lse, delta, *ids,
                                                       scale))}
        with torch.no_grad():
            for key, (kernel, plain) in fns.items():
                rec[key] = {"ms": cuda_time_ms(kernel, 20), "plain_ms": cuda_time_ms(plain, 5),
                            "device_ms": cuda_graph_time_ms(kernel),
                            "host_us": host_us(kernel)}
        log("flash_attention", f"{name} q {tuple(q.shape)} k {tuple(k.shape)}: "
            "max abs err (relative to max |value|, bound): "
            + ", ".join(f"{key} {errs[key]:.3e} ({rel[key]:.2e}, {bounds[key]})"
                        for key in errs)
            + f"; a mask off by one moves o by >= {shift:.3e} of max |o|; two launches "
            "of the forward, dq and dk/dv bit-equal; ms kernel eager (device-only, host "
            "us a call)/plain: "
            + ", ".join(f"{key} {r['ms']:.4f} ({r['device_ms']:.4f}, {r['host_us']:.1f})"
                        f"/{r['plain_ms']:.4f}"
                        for key, r in ((key, rec[key]) for key in fns)))
        if name == "path":
            rec["bounds"] = _flash_bounds_and_library(q, k, v, do, ids)
        records[name] = rec
        del q, k, v, do, qr, kr, vr, o_ref, lse_ref
    path = records["path"]
    worst = lambda keys: max(r["errs"][key] for r in records.values()  # noqa: E731
                             for key in keys)
    bd = path["bounds"]
    return {"flash_fwd": {"max_abs_err": worst(("o", "lse")), **path["fwd"], **bd["fwd"]},
            "flash_bwd_dq": {"max_abs_err": worst(("dq",)), **path["dq"], **bd["dq"]},
            "flash_bwd_dkv": {"max_abs_err": worst(("dk", "dv")), **path["dkv"],
                              **bd["dkv"]}}


def sdpa_times(q, k, v, do, mask, iters: int):
    """scaled_dot_product_attention on q, k, v ([B, L, H, D]) with a boolean
    attn_mask: (forward eager ms, forward device-only ms, autograd backward
    eager ms, backward device-only ms). Eager: CUDA events over ``iters``
    calls. Device-only from captured graphs; autograd runs a backward on its
    forward's stream, so the backward is captured with its forward (on
    leaves no earlier graph holds) and the forward's graph time taken off."""
    import torch

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gqa = q.shape[2] != k.shape[2]
    dot = do.transpose(1, 2)

    def leaves():
        return [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]

    def fwd_of(qkv):
        return sdpa(*qkv, attn_mask=mask, enable_gqa=gqa)

    qkv = leaves()
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: fwd_of(qkv), iters)
        fwd_dev = cuda_graph_time_ms(lambda: fwd_of(qkv))
    captured = leaves()

    def fwd_bwd():
        with torch.enable_grad():
            return torch.autograd.grad(fwd_of(captured), captured, dot)

    both_dev = cuda_graph_time_ms(fwd_bwd)
    with torch.enable_grad():
        o = fwd_of(qkv)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(o, qkv, dot, retain_graph=True), iters)
    return fwd, fwd_dev, bwd, both_dev - fwd_dev


def _flash_bounds_and_library(q, k, v, do, ids) -> dict:
    """Bounds of the three flash kernels at one case, over the (query, key)
    pairs its mask lets through, and the library's time for the same
    function: scaled_dot_product_attention with the mask as a boolean
    attn_mask, and its autograd backward (one call gives dq, dk and dv, so
    both backward kernels are set beside that one time); eager (the
    record's library_ms) and device-only from a captured graph."""
    import torch

    from bitdance_tpu_torch.ops.attention import mask_from_ids

    mask = mask_from_ids(*ids)                          # [B, Lq, Lk]
    pairs = mask.sum().item()
    b, L, hq, d = q.shape
    lse_b = b * hq * L * 4
    idb = nbytes(*ids)
    out = {"fwd": roofline(nbytes(q, k, v, q) + idb + lse_b, 4.0 * d * hq * pairs),
           "dq": roofline(nbytes(q, k, v, do, q) + idb + 2 * lse_b, 6.0 * d * hq * pairs),
           "dkv": roofline(nbytes(q, k, v, do, k, v) + idb + 2 * lse_b,
                        8.0 * d * hq * pairs)}
    fwd, fwd_dev, bwd, bwd_dev = sdpa_times(q, k, v, do, mask[:, None], 20)
    out["fwd"].update(library_ms=fwd, library_device_ms=fwd_dev)
    for key in ("dq", "dkv"):
        out[key].update(library_ms=bwd, library_device_ms=bwd_dev)
    log("flash_attention", "bounds (ms): " + ", ".join(
        f"{key} {r['bound_ms']:.4f} ({r['bound_by']})" for key, r in out.items())
        + f"; scaled_dot_product_attention forward {fwd:.4f} ms eager ({fwd_dev:.4f} "
        f"device-only), its autograd backward (dq, dk, dv) {bwd:.4f} ms eager "
        f"({bwd_dev:.4f} device-only)")
    return out


def _forward_matmul_flops(state, cfg, batch: int) -> float:
    """Forward matmul FLOPs of one step: 2 x weights x rows for every linear
    layer (backbone over batch x total_tokens rows, proj_in over the input
    tokens, the head over batch x num_tokens x diff_batch_mul rows), plus
    4 B H L^2 D per layer for QK^T and PV over the full (unmasked) square."""
    rows_ar = batch * cfg.total_tokens
    rows_in = batch * (cfg.num_tokens - cfg.parallel_num)
    rows_head = batch * cfg.num_tokens * cfg.diff_batch_mul
    flops = 0.0
    for n, p in state.model.named_parameters():
        if p.ndim != 2 or "cls_embedding" in n or "pos_for_diff" in n:
            continue
        rows = (rows_ar if n.startswith("ar.layers.") else
                rows_in if n.startswith("ar.proj_in.") else rows_head)
        flops += 2.0 * p.numel() * rows
    flops += (4.0 * batch * cfg.n_head * cfg.total_tokens ** 2 * cfg.head_dim
              * cfg.n_layer)
    return flops


def phase_train(card: str) -> dict:
    import torch

    from bitdance_tpu_torch.io.random_init import (
        build_random_tokenizer_encoder,
        build_random_train_state,
    )
    from bitdance_tpu_torch.models.imagenet_ar import config_h
    from bitdance_tpu_torch.ops.attention import flash_bwd_dkv, flash_bwd_dq, flash_fwd
    from bitdance_tpu_torch.train.imagenet_train import (
        ImageNetTrainConfig,
        encode_batch,
        train_step,
    )

    dev = torch.device("cuda")
    cfg = config_h()                        # BitDance-H-1x, 256 px
    tcfg = ImageNetTrainConfig()            # lr 6e-4, warmup 2000, wd 0.05,
    batch = 16                              # betas (0.9, 0.95), clip 1, EMA 0.9999
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = build_random_train_state(cfg, tcfg, dev, seed=0)
    ae = build_random_tokenizer_encoder(dev, torch.float32, seed=1)
    torch.cuda.synchronize()
    n_ar = sum(p.numel() for n, p in state.model.named_parameters() if n.startswith("ar."))
    n_head = sum(p.numel() for n, p in state.model.named_parameters()
                 if n.startswith("head."))
    log("train", f"BitDance-H-1x random fp32 train state + f32 tokenizer encoder "
        f"on the card in {time.perf_counter() - t0:.1f} s: backbone {n_ar / 1e6:.1f} M, "
        f"head {n_head / 1e6:.1f} M parameters; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    flops = _forward_matmul_flops(state, cfg, batch)

    def batch_of(seed):
        g = torch.Generator(device=dev).manual_seed(1000 + seed)
        img = torch.randint(0, 256, (batch, 256, 256, 3), generator=g, device=dev,
                            dtype=torch.uint8)
        cls = torch.randint(0, cfg.num_classes, (batch,), generator=g, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tokens = encode_batch(ae, cfg, img.float() / 127.5 - 1.0)
        torch.cuda.synchronize()
        return tokens, cls, time.perf_counter() - t

    watch = {n: p for n, p in state.model.named_parameters()
             if n in ("ar.layers.0.attention.wqkv.weight",
                      "head.net.final_layer.linear.weight", "ar.cls_embedding.weight")}
    init = {n: p.detach().clone() for n, p in watch.items()}
    norms_of = {"attn": ".attention.", "ar": "ar.", "head": "head."}
    n_kernel_steps = 7                      # the last one is also run plain
    flash_fwd.launches = flash_bwd_dq.launches = flash_bwd_dkv.launches = 0
    steps, snapshot = [], None
    for i in range(n_kernel_steps):
        tokens, cls, enc_s = batch_of(i)
        if i == 0:
            ok = (tokens.shape == (batch, cfg.num_tokens, cfg.token_dim)
                  and set(tokens.unique().tolist()) <= {-1.0, 1.0})
            if not ok:
                raise SystemExit(f"train: encode_batch gave {tuple(tokens.shape)}")
        if i == n_kernel_steps - 1:        # the plain step starts from here
            snapshot = [p.detach().clone() for p in state.tx.params]
        counts = (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)
        gen = torch.Generator(device=dev).manual_seed(i)
        t = time.perf_counter()
        m = train_step(state, tokens, cls, gen, ema_decay=tcfg.ema_decay,
                       norms_of=norms_of)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        m = {k: v.item() for k, v in m.items()}
        got = tuple(c1 - c0 for c0, c1 in zip(
            counts, (flash_fwd.launches, flash_bwd_dq.launches, flash_bwd_dkv.launches)))
        moved = {n: (p.detach() != init[n]).any().item() for n, p in watch.items()}
        ema_moved = any((state.ema[n] != init[n]).any().item() for n in watch)
        steps.append({"s": dt, **m})
        log("train", f"step {i + 1}: {dt:.3f} s (encode {enc_s:.3f} s), lr "
            f"{state.tx.lr_schedule(i):.3e}; loss {m['loss']:.5f}, grad_norm "
            f"{m['grad_norm']:.5f} (attention weights {m['grad_norm_attn']:.4e}, "
            f"backbone {m['grad_norm_ar']:.4e}, head {m['grad_norm_head']:.4e}); "
            f"flash launches fwd/dq/dkv {got}; params moved {moved}; EMA moved {ema_moved}")
        want_moved = i >= 1                # lr is 0 at count 0 (optax semantics)
        if (not all(x == want_moved for x in moved.values())
                or (want_moved and not ema_moved) or got != (cfg.n_layer,) * 3
                or not all(map(lambda x: x == x and abs(x) < float("inf"), m.values()))
                or m["grad_norm_attn"] <= 0):
            raise SystemExit(f"train step {i + 1} failed its checks")
    launches = {"flash_fwd": flash_fwd.launches, "flash_bwd_dq": flash_bwd_dq.launches,
                "flash_bwd_dkv": flash_bwd_dkv.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = sorted(s["s"] for s in steps[2:-1])   # not the snapshot's step
    s_step = steady[len(steady) // 2]
    mfu = 3 * flops / s_step / H100_BF16_PEAK
    log("train", f"steady s/step {s_step:.4f} (median of steps 3-{n_kernel_steps - 1}: "
        f"{', '.join(f'{s:.4f}' for s in steady)}); {batch / s_step:.2f} images/s; "
        f"3 x forward matmul FLOPs {3 * flops / 1e12:.2f} TFLOP -> "
        f"{3 * flops / s_step / 1e12:.1f} TFLOP/s, MFU {mfu:.4f} of the "
        f"{H100_BF16_PEAK / 1e12:.0f} TFLOP/s dense bf16 peak; peak memory "
        f"{peak:.2f} GiB; card {card}")

    profile_run("train", "one train step (kernel attention)",
                lambda: train_step(state, tokens, cls,
                                   torch.Generator(device=dev).manual_seed(99),
                                   ema_decay=tcfg.ema_decay))
    # one step on the plain attention path from the state and draws of the
    # last kernel step
    with torch.no_grad():
        for p, s in zip(state.tx.params, snapshot):
            p.copy_(s)
    del snapshot
    gen = torch.Generator(device=dev).manual_seed(n_kernel_steps - 1)
    t = time.perf_counter()
    mp = train_step(state, tokens, cls, gen, ema_decay=tcfg.ema_decay,
                    implementation="plain")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    mp = {k: v.item() for k, v in mp.items()}
    mk = steps[-1]
    rl = abs(mp["loss"] - mk["loss"]) / abs(mk["loss"])
    rg = abs(mp["grad_norm"] - mk["grad_norm"]) / mk["grad_norm"]
    log("train", f"plain-attention step from the same state: {dt:.3f} s; loss "
        f"{mp['loss']:.5f} vs kernel {mk['loss']:.5f} (rel {rl:.2e}, bound "
        f"{TRAIN_LOSS_REL}); grad_norm {mp['grad_norm']:.5f} vs {mk['grad_norm']:.5f} "
        f"(rel {rg:.2e}, bound {TRAIN_GRAD_NORM_REL})")
    if rl > TRAIN_LOSS_REL or rg > TRAIN_GRAD_NORM_REL:
        raise SystemExit("train: kernel and plain steps disagree")
    return {"launches": launches, "s_per_step": s_step, "mfu": mfu,
            "peak_gib": peak}


def _reset_counts() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def _kernel_wrappers() -> dict:
    from bitdance_tpu_torch.ops.attention import (
        flash_bwd_dkv,
        flash_bwd_dkv_sparse,
        flash_bwd_dq,
        flash_bwd_dq_sparse,
        flash_fwd,
        flash_fwd_sparse,
    )
    from bitdance_tpu_torch.ops.decode_attention import (
        decode_attention,
        decode_attention_fusedkv,
    )
    from bitdance_tpu_torch.ops.fused_block import fused_attn_block, fused_mlp_block
    from bitdance_tpu_torch.ops.fused_encode import fused_encode_tail
    from bitdance_tpu_torch.ops.fused_head import fused_diffnet_forward, fused_em_sample
    from bitdance_tpu_torch.ops.int4 import int4_matmul

    return {"decode_attention": decode_attention, "fused_em_sample": fused_em_sample,
            "flash_fwd": flash_fwd, "flash_bwd_dq": flash_bwd_dq,
            "flash_bwd_dkv": flash_bwd_dkv, "fused_mlp_block": fused_mlp_block,
            "fused_attn_block": fused_attn_block, "w4a8_matmul": int4_matmul,
            "decode_attention_fusedkv": decode_attention_fusedkv,
            "flash_fwd_sparse": flash_fwd_sparse,
            "flash_bwd_dq_sparse": flash_bwd_dq_sparse,
            "flash_bwd_dkv_sparse": flash_bwd_dkv_sparse,
            "fused_encode_tail": fused_encode_tail,
            "fused_diffnet_forward": fused_diffnet_forward}


def _block_inputs(g, lead, c, dev):
    """x ~ N(0, 1) and adaLN mods ~ N(0, 0.25) as bf16 chunks of one
    [.., 3C] tensor (the layout the head hands the kernels)."""
    import torch

    x = torch.randn((*lead, c), generator=g, device=dev).bfloat16()
    ada = 0.5 * torch.randn((*lead, 3 * c), generator=g, device=dev)
    return x, ada


def _errors(got, want) -> tuple[float, float]:
    """(max abs error, that error relative to max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    return err, err / want.float().abs().max().item()


def _check_mlp_block(name, blk, norm, rows, dev, seed, phase="imagenet_kernels") -> dict:
    """#14 against its plain version at the card's K splits (the head GEMM's
    split twin); the mods one row off and the gate one column off must move
    the plain version by >= 4x the bound; two launches bit-equal; launches a
    call (captured) against MLP_BLOCK_LAUNCHES; eager, device-only (a
    captured graph) and host us a call (the least of 5 runs), and with the
    launches plain (no PDL) or only the products programmatic."""
    import torch

    from bitdance_tpu_torch.ops.fused_block import (
        MLP_BLOCK_LAUNCHES,
        fused_mlp_block,
        fused_mlp_block_reference,
        mlp_block_plans,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    c = blk.w2.weight.shape[0]
    h = blk.w2.weight.shape[1]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = dict(zip(("w1", "w2"), (p.splits for p in mlp_block_plans(rows, c, h, sms))))
    x, ada = _block_inputs(g, (rows,), c, dev)
    mods = list(ada.bfloat16().chunk(3, dim=-1))
    weights = (norm.weight, norm.bias, blk.w1.weight, blk.w1.bias, blk.w2.weight, blk.w2.bias)
    args = (x, *mods, *weights)
    with torch.no_grad():
        got, again = fused_mlp_block(*args), fused_mlp_block(*args)
        want = fused_mlp_block_reference(*args, splits=splits)
        torch.cuda.synchronize()
        err, rel = _errors(got, want)
        same = torch.equal(got, again)
        moved = {"mods one row off": _errors(fused_mlp_block_reference(
                     x, *(m.roll(1, 0) for m in mods), *weights, splits=splits), want)[1],
                 "gate one column off": _errors(fused_mlp_block_reference(
                     x, *mods[:2], mods[2].roll(1, 1), *weights, splits=splits), want)[1]}
        ms = cuda_time_ms(lambda: fused_mlp_block(*args), 200, warmup=5)
        times = {"device_ms": cuda_graph_time_ms(lambda: fused_mlp_block(*args)),
                 "host_us": host_us(lambda: fused_mlp_block(*args), trials=5)}
        for pdl, tag in ((0, "no_pdl"), (1, "pdl_gemms")):
            times[f"{tag}_ms"] = cuda_time_ms(lambda: fused_mlp_block(*args, _pdl=pdl), 200,
                                              warmup=5)
            times[f"{tag}_device_ms"] = cuda_graph_time_ms(
                lambda: fused_mlp_block(*args, _pdl=pdl))
        n_kernels = _captured_kernels(lambda: fused_mlp_block(*args))
        pms = cuda_time_ms(lambda: fused_mlp_block_reference(*args), 50)
    bd = roofline(nbytes(x, x, *mods, *weights), 6.0 * rows * c * h)
    b = HEAD_BLOCK_MAX_REL_ERR
    log(phase, f"fused_mlp_block {name} rows={rows} C={c} H={h} (head GEMM "
        f"splits {splits}): max abs err {err:.3e}, rel {rel:.3e} (bound {b}); the plain "
        f"version moves by " + ", ".join(f"{k} {v:.3e}" for k, v in moved.items())
        + f" (>= {4 * b:g}); 2 launches bit-equal {same}; {n_kernels} kernels a call "
        f"(captured; want {MLP_BLOCK_LAUNCHES}); kernel {ms:.4f} ms eager, "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; plain {pms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    if (not torch.isfinite(got).all() or rel > b or not same or min(moved.values()) < 4 * b
            or n_kernels != MLP_BLOCK_LAUNCHES):
        raise SystemExit(f"fused_mlp_block {name}: rel err {rel} > {b}, off by one {moved}, "
                         f"bit-equal {same}, {n_kernels} kernels a call")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bd, "library_ms": None,
            **times, "launches_per_call": n_kernels}


def _attn_block_case(bundle, groups, window, dev, seed,
                     phase="imagenet_kernels") -> dict:
    """#15 at one row count against its plain version at the card's K
    splits (the head GEMM's split twin): the window-edge rows' shift makes a
    window off by one row move the plain output by >= 4x the bound; two
    launches bit-equal; launches a call (captured) against
    ATTN_BLOCK_LAUNCHES; eager, device-only (a captured graph) and host us a
    call (the least of 5 runs), block 0 again and again (warm L2) and a walk
    over every block's weights (cold L2), and with ``_pdl`` 0 (none) and 1
    (all but the LN)."""
    import torch

    from bitdance_tpu_torch.ops.fused_block import (
        ATTN_BLOCK_LAUNCHES,
        attn_block_plans,
        fused_attn_block,
        fused_attn_block_reference,
    )

    g = torch.Generator(device=dev).manual_seed(seed)
    blocks = bundle.head.net.res_blocks
    a = blocks[0].attn
    c = a.wo.weight.shape[0]
    rows = groups * window
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = dict(zip(("qkv", "wo"), (p.splits for p in attn_block_plans(rows, c, sms))))
    x, ada = _block_inputs(g, (groups, window), c, dev)
    ada[:, [0, window - 1], c:2 * c] += IMAGENET_EDGE_SHIFT   # the shift mod
    scale, shift, gate = ada.bfloat16().chunk(3, dim=-1)

    def weights(b):
        return (b.norm1.weight, b.norm1.bias, b.attn.wqkv.weight, b.attn.wqkv.bias,
                b.attn.wo.weight, b.attn.wo.bias, b.attn.n_head)

    w = weights(blocks[0])
    args = (x, scale, shift, gate, *w)

    def off_by_one(t):        # windows start one row later
        return t.reshape(rows, -1).roll(1, 0).reshape(groups, window, -1)

    # one window holds every row, so no window can be one row off
    one_window = groups == 1

    with torch.no_grad():
        got, again = fused_attn_block(*args), fused_attn_block(*args)
        want = fused_attn_block_reference(*args, splits=splits)
        torch.cuda.synchronize()
        err, rel = _errors(got, want)
        same = torch.equal(got, again)
        moved = float("inf")
        if not one_window:
            alt = fused_attn_block_reference(*map(off_by_one, (x, scale, shift, gate)), *w,
                                             splits=splits)
            alt = alt.reshape(rows, c).roll(-1, 0).reshape(groups, window, c)
            moved = _errors(alt, want)[1]
        walk = lambda: [fused_attn_block(x, scale, shift, gate, *weights(b))  # noqa: E731
                        for b in blocks]
        ms = cuda_time_ms(lambda: fused_attn_block(*args), 200, warmup=5)
        times = {"device_ms": cuda_graph_time_ms(lambda: fused_attn_block(*args)),
                 "host_us": host_us(lambda: fused_attn_block(*args), trials=5),
                 "cold_ms": cuda_time_ms(walk, 20) / len(blocks),
                 "cold_device_ms": cuda_graph_time_ms(walk, calls=2, reps=3) / len(blocks)}
        for pdl, tag in ((0, "no_pdl"), (1, "pdl_gemms")):
            times[f"{tag}_ms"] = cuda_time_ms(lambda: fused_attn_block(*args, _pdl=pdl), 200,
                                              warmup=5)
            times[f"{tag}_device_ms"] = cuda_graph_time_ms(
                lambda: fused_attn_block(*args, _pdl=pdl))
        n_kernels = _captured_kernels(lambda: fused_attn_block(*args))
        pms = cuda_time_ms(lambda: fused_attn_block_reference(*args), 50)
    b = HEAD_BLOCK_MAX_REL_ERR
    bd = roofline(nbytes(x, x, scale, shift, gate, *w[:6]),
                  8.0 * rows * c * c + 4.0 * rows * window * c)
    log(phase, f"fused_attn_block G={groups} W={window} C={c} "
        f"heads={a.n_head} (head GEMM splits {splits}): max abs err {err:.3e}, rel "
        f"{rel:.3e} (bound {b}; " + ("one window: no off-by-one case" if one_window else
                                     f"a window off by one row moves the plain output by "
                                     f"{moved:.3e} of its max, >= {4 * b:g}")
        + f"); 2 launches bit-equal {same}; "
        f"{n_kernels} kernels a call (captured; want {ATTN_BLOCK_LAUNCHES}); kernel "
        f"{ms:.4f} ms eager, " + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f"; plain {pms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    if (not torch.isfinite(got).all() or rel > b or moved < 4 * b or not same
            or n_kernels != ATTN_BLOCK_LAUNCHES):
        raise SystemExit(f"fused_attn_block G={groups}: rel err {rel} (bound {b}), "
                         f"off-by-one shift {moved}, bit-equal {same}, {n_kernels} kernels "
                         "a call")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bd, "library_ms": None,
            **times, "launches_per_call": n_kernels}


def _check_attn_block(bundle, dev, seed) -> dict:
    """#15 at B-16x's unguided 512 rows (32 windows of 16; the record) and
    its guided 1024 (cfg_mult 2; under "shapes"), and its qkv ("bias_f32")
    and wo ("gated_bf16") products against their split twins at both row
    counts (the planned, 1 and the most splits, with the row, column and K
    stage off-by-one checks; under "products")."""
    out = _attn_block_case(bundle, IMAGENET_BATCH, 16, dev, seed)
    out["shapes"] = {"1024_rows": _attn_block_case(bundle, 2 * IMAGENET_BATCH, 16, dev,
                                                   seed + 1)}
    out["products"] = {
        f"{rows}_rows": _check_head_gemm("attn_block", bundle.head_stacked, ("wqkv", "wo"),
                                         rows, dev, seed + 2, products=ATTN_BLOCK_PRODUCTS,
                                         all_splits=True)
        for rows in (16 * IMAGENET_BATCH, 32 * IMAGENET_BATCH)}
    return out


def imagenet_sampler_inputs(bundle, dev, seed):
    """The whole sampler's keywords at one ImageNet head and its guided
    path's rows (IMAGENET_BATCH images, [cond; null class]), and inputs(steps)
    -> (x0, noise, allmods, t_all, dt_all), drawn from one generator."""
    import torch

    from bitdance_tpu_torch.models.sampling import time_shift
    from bitdance_tpu_torch.ops.fused_head import em_precompute

    head, stacked = bundle.head, bundle.head_stacked
    p, C, ch = head.parallel_num, head.ch_latent, head.ch_target
    half = IMAGENET_BATCH * p
    kw = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
              n_head=C // head.attn_head_dim, groups=2 * IMAGENET_BATCH if p > 1 else 1,
              attention=head.attention, bounded=head.bounded)
    g = torch.Generator(device=dev).manual_seed(seed)
    cond = torch.randn((2 * half, bundle.cfg.dim), generator=g, device=dev).bfloat16()
    c_emb = cond.float() @ stacked["cond_w"].float().t() + stacked["cond_b"]

    def inputs(steps):
        t_all = time_shift(torch.linspace(0.0, 0.95, steps + 1), head.time_shift)
        dt_all = torch.cat([t_all[1:] - t_all[:-1], torch.zeros(1)])
        x0 = torch.randn((half, ch), generator=g, device=dev)
        noise = torch.randn((steps, half, ch), generator=g, device=dev)
        return x0, noise, em_precompute(stacked, c_emb, t_all), t_all, dt_all

    return kw, inputs


def _check_imagenet_sampler(name, bundle, dev, seed) -> dict:
    """The whole sampler at one ImageNet head and its guided path's rows
    (IMAGENET_BATCH images, [cond; null class]): 4 steps against the plain
    version (relative bound), then IMAGENET_STEPS steps (sign agreement and
    times)."""
    import torch

    from bitdance_tpu_torch.ops.fused_head import fused_em_sample, fused_em_sample_reference

    head, stacked = bundle.head, bundle.head_stacked
    p, C = head.parallel_num, head.ch_latent
    half = IMAGENET_BATCH * p
    kw, inputs = imagenet_sampler_inputs(bundle, dev, seed)
    cfg = 4.0
    with torch.no_grad():
        args = inputs(1)
        got = fused_em_sample(stacked, *args[:3], *args[3:], cfg, **kw)
        want = fused_em_sample_reference(stacked, *args[:3], *args[3:], cfg, **kw)
        gap = ((got - want).abs().mean() / want.abs().max()).item()
        args = inputs(4)
        got = fused_em_sample(stacked, *args[:3], *args[3:], cfg, **kw)
        want = fused_em_sample_reference(stacked, *args[:3], *args[3:], cfg, **kw)
        torch.cuda.synchronize()
        err, rel = _errors(got, want)
        args = inputs(IMAGENET_STEPS)
        run_k = lambda: fused_em_sample(stacked, *args[:3], *args[3:], cfg, **kw)  # noqa: E731
        run_p = lambda: fused_em_sample_reference(stacked, *args[:3], *args[3:],  # noqa: E731
                                                  cfg, **kw)
        xk, xp = run_k(), run_p()
        agree = (torch.sign(xk) == torch.sign(xp)).float().mean().item()
        ms = cuda_time_ms(run_k, 3, warmup=1)
        pms = cuda_time_ms(run_p, 2, warmup=1)
        times = sampler_times(lambda pdl: fused_em_sample(stacked, *args[:3], *args[3:], cfg,
                                                          _pdl=pdl, **kw))
        per_net = _sampler_launches(lambda s: fused_em_sample(
            stacked, args[0], args[1][:s], args[2][:s + 1], args[3], args[4], cfg, **kw))
    bd = sampler_bound(stacked, args[0], args[1], args[2], attention=head.attention,
                       groups=kw["groups"], window=p)
    fam = "TransEncoder" if head.attention else "MlpEncoder"
    calls = IMAGENET_STEPS + 1
    log("imagenet_kernels", f"fused_em_sample {name} ({fam}, unbounded, C={C}, "
        f"{head.depth_latent} blocks, R={2 * half}): 4 steps max abs err {err:.3e}, "
        f"rel {rel:.3e} (bound {IMAGENET_SAMPLER_MAX_REL_ERR}); {IMAGENET_STEPS} "
        f"steps: +-1 agreement {agree:.4f} (floor {SAMPLER_SIGN_AGREEMENT_FLOOR}), "
        f"kernel {ms:.2f} ms ({ms / calls:.4f} per net call), plain "
        f"{pms:.2f} ms, bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
        f"{bd['bound_ms'] / calls:.4f} per net call); per net call "
        + ", ".join(f"{q} {v / calls:.4f}" for q, v in times.items())
        + f" ms; {per_net:g} launches per net call (captured)")
    if (not torch.isfinite(xk).all() or rel > IMAGENET_SAMPLER_MAX_REL_ERR
            or agree < SAMPLER_SIGN_AGREEMENT_FLOOR):
        raise SystemExit(f"fused_em_sample {name}: rel {rel}, agreement {agree}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bd, "library_ms": None,
            **times, "launches_per_net_call": per_net}


def sampler_times(run) -> dict:
    """One whole-sampler call on the head GEMM (the bf16 routes), ms:
    device-only (a captured graph), and eager and device-only with its
    launches plain (run(pdl) calls fused_em_sample with _pdl=pdl)."""
    plain = lambda: run(False)  # noqa: E731
    return {"device_ms": cuda_graph_time_ms(lambda: run(True), calls=1, reps=3),
            "no_pdl_ms": cuda_time_ms(plain, 3, warmup=1),
            "no_pdl_device_ms": cuda_graph_time_ms(plain, calls=1, reps=3)}


def _head_gemm_operands(stacked, key, rows, g, dev, products=HEAD_GEMM_PRODUCTS):
    """One block product of the sampler at ``rows``: a ~ N(0, 1) bf16, and
    for the gated modes a residual ~ N(0, 1) (bf16 values; "gated_bf16":
    the block input x, bf16) and a gate ~ N(0, 0.25) whose rows lie apart
    as the sampler's mods do."""
    import torch

    mode = products[key][0]
    n, k = stacked[key].shape[1:]
    a = torch.randn((rows, k), generator=g, device=dev).bfloat16()
    kw = {}
    if mode.startswith("gated"):
        res = torch.randn((rows, n), generator=g, device=dev).bfloat16()
        kw.update({"x": res} if mode == "gated_bf16" else {"resid": res.float()})
        kw["gate"] = (0.5 * torch.randn((rows, 3 * n), generator=g, device=dev)
                      ).bfloat16()[:, n:2 * n]
    return a, kw


def head_gemm_walk(stacked, key, a, kw, plan, products=HEAD_GEMM_PRODUCTS):
    """The product over every block's weights in turn (the stack is larger
    than the L2, so each launch finds its weights cold): a callable."""
    from bitdance_tpu_torch.ops.fused_head import head_gemm

    mode, bkey = products[key]
    w = stacked[key]
    b = stacked[bkey] if bkey else [None] * w.shape[0]
    return lambda: [head_gemm(a, w[l], mode, b[l], plan=plan, **kw) for l in range(w.shape[0])]


def matmul_walk(stacked, key, a):
    """torch.matmul at the same shape over the same walk."""
    w = stacked[key]
    return lambda: [a @ w[l].t() for l in range(w.shape[0])]


def head_gemm_bound(a, w, mode, kw) -> dict:
    """One product: a, w and the bias read, the output written (the gated
    modes read the gate and read and write the residual; "gated_bf16" reads
    x and writes its bf16 output; "out_f32" writes fp32, no bias; "bias_f32"
    writes fp32), 2 R N K flops."""
    rows, n = a.shape[0], w.shape[0]
    out = rows * (n // 2 if mode.startswith("swiglu") else n) * (
        4 if mode in ("out_f32", "bias_f32") else 2)
    if mode == "gated_bf16":
        extra = nbytes(kw["gate"], kw["x"]) + rows * n * 2        # gate, x, out
    elif mode.startswith("gated"):
        extra = nbytes(kw["gate"]) + 2 * nbytes(kw["resid"])
    else:
        extra = out
    bias = 0 if mode == "out_f32" else 2 * n
    return roofline(nbytes(a, w) + bias + extra, 2.0 * rows * n * a.shape[1])


def _check_head_gemm(name, stacked, keys, rows, dev, seed, products=HEAD_GEMM_PRODUCTS,
                     phase="imagenet_kernels", all_splits=False) -> dict:
    """The head GEMM at a head's rows, every product of block 0 against its
    split twin (the plan's splits; all_splits: also 1 split and the most a
    cluster and the product's stages allow): a relative bound per mode; an A
    row, a weight row (an output column) and a K stage off by one must each
    move the twin by >= 4x that bound; two launches bit-equal. Then
    device-only ms a product over every block's weights in turn (cold L2),
    torch.matmul on the same walk, the bound."""
    import torch

    from bitdance_tpu_torch.ops.fused_head import (
        HEAD_GEMM_BK,
        HEAD_GEMM_MAX_SPLITS,
        head_gemm,
        head_gemm_plan,
        head_gemm_split_plain,
        head_gemm_stages,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for key in keys:
        mode, bkey = products[key]
        w = stacked[key][0]
        bias = stacked[bkey][0] if bkey else None
        n, k = w.shape
        plan = head_gemm_plan(rows, n, k, sms)
        a, kw = _head_gemm_operands(stacked, key, rows, g, dev, products)
        most = min(HEAD_GEMM_MAX_SPLITS, 1 << (head_gemm_stages(k).bit_length() - 1))
        plans = [plan] + ([plan._replace(splits=sp) for sp in sorted({1, most} - {plan.splits})]
                          if all_splits else [])
        bound = HEAD_GEMM_MAX_REL_ERR[mode]
        checks = []
        for pl in plans:
            def run(pl=pl):   # the gated residual is updated in place: a fresh copy
                fresh = {q: v.clone() if q == "resid" else v for q, v in kw.items()}
                return head_gemm(a, w, mode, bias, plan=pl, **fresh)

            def twin(a=a, w=w, pl=pl):
                return head_gemm_split_plain(a, w, mode, bias, splits=pl.splits, **kw)

            with torch.no_grad():
                got, again, want = run(), run(), twin()
                torch.cuda.synchronize()
                err, rel = _errors(got, want)
                moved = {"row": _errors(twin(a=a.roll(1, 0)), want)[1],
                         "column": _errors(twin(w=w.roll(1, 0)), want)[1],
                         "k_stage": _errors(twin(a=a.roll(HEAD_GEMM_BK, 1)), want)[1]}
                same = torch.equal(got, again)
            checks.append((pl.splits, err, rel, moved, same))
            if (not torch.isfinite(got.float()).all() or rel > bound or not same
                    or min(moved.values()) < 4 * bound):
                raise SystemExit(f"head_gemm {name} {key} at {pl.splits} split(s): rel "
                                 f"{rel} (bound {bound}), off by one {moved}, bit-equal "
                                 f"{same}")
        with torch.no_grad():
            walk = head_gemm_walk(stacked, key, a, kw, plan, products)
            lib = matmul_walk(stacked, key, a)
            blocks = stacked[key].shape[0]
            dms = cuda_graph_time_ms(walk, calls=4, reps=3) / blocks
            ms = cuda_time_ms(walk, 10) / blocks
            lib_dms = cuda_graph_time_ms(lib, calls=4, reps=3) / blocks
            lib_ms = cuda_time_ms(lib, 10) / blocks
        bd = head_gemm_bound(a, w, mode, kw)
        log(phase, f"head_gemm {name} {key} ({mode}) R={rows} [{n}, {k}], plan "
            f"bm {plan.bm} bn {plan.bn} x {plan.splits} split(s); against the split twin "
            + "; ".join(f"{sp} split(s): max abs err {e:.3e}, rel {r:.3e} (bound {bound}), "
                        "off by one " + ", ".join(f"{q} {v:.3e}" for q, v in mv.items())
                        + f" (>= {4 * bound:g}), 2 launches bit-equal {sm}"
                        for sp, e, r, mv, sm in checks)
            + f"; cold L2 over {blocks} blocks: {ms:.4f} ms eager, {dms:.4f} device-only; "
            f"torch.matmul {lib_ms:.4f} / {lib_dms:.4f}; bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})")
        out[key] = {"mode": mode, "splits": plan.splits, "max_abs_err": checks[0][1],
                    "rel_err": checks[0][2],
                    "rel_err_by_splits": {sp: r for sp, _, r, _, _ in checks}, "ms": ms,
                    "device_ms": dms, "library_ms": lib_ms, "library_device_ms": lib_dms, **bd}
    return out


def _sampler_launches(run_steps) -> float:
    """Kernel launches of one net call of the whole sampler: the kernel
    nodes of a captured 4-step call less those of a 2-step one, halved."""
    return (_captured_kernels(lambda: run_steps(4)) - _captured_kernels(lambda: run_steps(2))) / 2


def phase_imagenet_kernels(h1x, b16x) -> dict:
    dev = h1x.head.net.input_proj.weight.device
    hb, bb = h1x.head.net.res_blocks[0], b16x.head.net.res_blocks[0]
    out = {
        "fused_mlp_block": _check_mlp_block("mlp_h1x", hb, hb.norm,
                                            UNGUIDED_H1X_IMAGES, dev, 11),
        "fused_mlp_block_b16x": _check_mlp_block("mlp_b16x", bb, bb.norm2,
                                                 IMAGENET_BATCH * 16, dev, 12),
        "fused_attn_block": _check_attn_block(b16x, dev, 13),
        "fused_em_sample_mlp": _check_imagenet_sampler("h1x", h1x, dev, 14),
        "fused_em_sample_b16x": _check_imagenet_sampler("b16x", b16x, dev, 15),
    }
    for key, bundle, rows, seed in (("fused_mlp_block", h1x, UNGUIDED_H1X_IMAGES, 18),
                                    ("fused_mlp_block_b16x", b16x, IMAGENET_BATCH * 16, 19)):
        out[key]["products"] = _check_head_gemm(
            key.replace("fused_mlp_block", "mlp_block"), bundle.head_stacked, ("w1", "w2"),
            rows, dev, seed, products=MLP_BLOCK_PRODUCTS, all_splits=True)
    out["fused_em_sample_mlp"]["products"] = _check_head_gemm(
        "h1x", h1x.head_stacked, ("w1", "w2"), 2 * IMAGENET_BATCH, dev, 16)
    out["fused_em_sample_b16x"]["products"] = _check_head_gemm(
        "b16x", b16x.head_stacked, ("wqkv", "wo", "w1", "w2"), 2 * IMAGENET_BATCH * 16, dev,
        17)
    return out


def _imagenet_run(bundle, n: int, cfg_scale: float, seed: int, steps: int,
                  head_sampler=None, kv_int8: bool = False) -> dict:
    """One class-conditional batch through ``sample`` (kv_int8: the int8 KV
    cache) and the VQ decoder, with every kernel count set to 0 just before
    and read just after."""
    import numpy as np
    import torch

    from bitdance_tpu_torch.models.diff_head import make_fused_sampler
    from bitdance_tpu_torch.models.imagenet_ar import decode_uint8, sample, tokens_to_grid

    cfg = bundle.cfg
    dev = bundle.head.net.input_proj.weight.device
    cls = torch.arange(n, device=dev) % cfg.num_classes
    gen = torch.Generator(device=dev).manual_seed(seed)
    timing: dict = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    tokens = sample(bundle.model, bundle.head, cfg, cls, gen,
                    num_sampling_steps=steps, cfg_scale=cfg_scale,
                    head_sampler=head_sampler or make_fused_sampler(
                        bundle.head, bundle.head_stacked),
                    timing=timing, kv_int8=kv_int8)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    images = decode_uint8(bundle.ae, cfg, tokens)
    end.record()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = _counts()
    timing["vae"] = start.elapsed_time(end) / 1e3
    with torch.no_grad():                    # the uint8 cast would hide NaN
        raw = bundle.ae.decode(tokens_to_grid(cfg, tokens[:2]))
    ok = (tuple(tokens.shape) == (n, cfg.num_tokens, cfg.token_dim)
          and set(tokens.unique().tolist()) <= {-1.0, 1.0}
          and images.dtype == torch.uint8
          and tuple(images.shape) == (n, cfg.resolution, cfg.resolution, 3)
          and bool(torch.isfinite(raw.float()).all()))
    return {"tokens": tokens, "ok": ok, "s": dt, "timing": timing,
            "counts": counts, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "image_mean": float(np.asarray(images.float().mean().item()))}


def _log_run(phase, what, r, want: dict, card) -> None:
    got = {k: r["counts"][k] for k in want}
    timing = {k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in r["timing"].items()}
    n = r["tokens"].shape[0]
    log(phase, f"{what}: {r['s']:.3f} s/batch, {n / r['s']:.2f} images/s; "
        f"phases {json.dumps(timing)}; peak memory {r['peak_gib']:.2f} GiB; "
        f"launches {got} (want {want}); images uint8 mean {r['image_mean']:.2f}; "
        f"tokens +1 share {(r['tokens'] > 0).float().mean().item():.3f}; card {card}")
    if not r["ok"] or got != want:
        raise SystemExit(f"{phase} {what} failed its checks")


def phase_imagenet_h1x(bundle, card) -> dict:
    """BitDance-H-1x: IMAGENET_BATCH classes guided at cfg 4.55 (the whole
    sampler, 256 launches), then UNGUIDED_H1X_IMAGES unguided (per call:
    12 fused_mlp_block launches per net call)."""
    cfg, head = bundle.cfg, bundle.head
    steps = cfg.num_tokens // cfg.parallel_num
    guided = _imagenet_run(bundle, IMAGENET_BATCH, 4.55, 0, IMAGENET_STEPS)
    _log_run("imagenet_h1x", f"{IMAGENET_BATCH} images, cfg 4.55 linear, "
             f"{IMAGENET_STEPS} sampling steps, {steps} AR steps", guided,
             {"fused_em_sample": steps, "fused_mlp_block": 0}, card)
    unguided = _imagenet_run(bundle, UNGUIDED_H1X_IMAGES, 1.0, 1, UNGUIDED_H1X_STEPS)
    _log_run("imagenet_h1x", f"{UNGUIDED_H1X_IMAGES} images unguided (cfg 1.0), "
             f"{UNGUIDED_H1X_STEPS} sampling steps (cut from {IMAGENET_STEPS} for "
             "the script's time)", unguided,
             {"fused_em_sample": 0,
              "fused_mlp_block": head.depth_latent * (UNGUIDED_H1X_STEPS + 1) * steps},
             card)
    return {"guided": guided["counts"], "unguided": unguided["counts"],
            "unguided_run": unguided, "guided_tokens": guided["tokens"]}


def phase_imagenet_b16x(bundle, card) -> dict:
    """BitDance-B-16x: IMAGENET_BATCH classes guided at cfg 6.1 (16 whole-
    sampler launches) and unguided (per call: one fused_attn_block and one
    fused_mlp_block per block and net call); then the guided batch again,
    its head run at every AR step through both the whole sampler (whose
    tokens drive the batch) and the per-call path, from the same draws."""
    cfg, head = bundle.cfg, bundle.head
    steps = cfg.num_tokens // cfg.parallel_num
    per_call = head.depth_latent * (IMAGENET_STEPS + 1) * steps
    guided = _imagenet_run(bundle, IMAGENET_BATCH, 6.1, 0, IMAGENET_STEPS)
    _log_run("imagenet_b16x", f"{IMAGENET_BATCH} images, cfg 6.1 linear, "
             f"{IMAGENET_STEPS} sampling steps, {steps} AR steps", guided,
             {"fused_em_sample": steps, "fused_attn_block": 0, "fused_mlp_block": 0},
             card)
    unguided = _imagenet_run(bundle, IMAGENET_BATCH, 1.0, 1, IMAGENET_STEPS)
    _log_run("imagenet_b16x", f"{IMAGENET_BATCH} images unguided (cfg 1.0), "
             f"{IMAGENET_STEPS} sampling steps", unguided,
             {"fused_em_sample": 0, "fused_attn_block": per_call,
              "fused_mlp_block": per_call}, card)
    import torch

    agree = []

    def both_paths(cond, generator, cfg_iter, n_steps, cfg_mult):
        state = generator.get_state()
        whole = head.sample(cond, generator, cfg_iter, n_steps, cfg_mult,
                            stacked=bundle.head_stacked)
        generator.set_state(state)
        per = head.sample_per_call(cond, generator, cfg_iter, n_steps, cfg_mult)
        agree.append((torch.sign(whole) == torch.sign(per)).float().mean())
        return whole

    cross = _imagenet_run(bundle, IMAGENET_BATCH, 6.1, 0, IMAGENET_STEPS,
                          head_sampler=both_paths)
    share = torch.stack(agree).mean().item()
    same = torch.equal(cross["tokens"], guided["tokens"])
    _log_run("imagenet_b16x", "the guided batch, its head at every AR step "
             "through the whole sampler and through the per-call path "
             "(fused_attn_block + fused_mlp_block under cfg_mult 2) from the same "
             f"draws: +-1 agreement {share:.4f} (floor {CROSS_CHECK_AGREEMENT_FLOOR}, "
             f"per AR step {min(agree).item():.4f}-{max(agree).item():.4f}); "
             f"tokens equal to the first guided run's: {same}", cross,
             {"fused_em_sample": steps, "fused_attn_block": per_call,
              "fused_mlp_block": per_call}, card)
    if share < CROSS_CHECK_AGREEMENT_FLOOR or not same:
        raise SystemExit(f"imagenet_b16x: per-call vs whole-sampler agreement "
                         f"{share}, same tokens as the guided run: {same}")
    _free_running(bundle)
    # the unguided batch is profiled at the H-1x cut's sampling steps: at 100
    # it was 181k kernels, and the script took 344 s with these two profiles
    # against 200 s without them (H100)
    for what, cfg_scale, n_steps in (("guided", 6.1, IMAGENET_STEPS),
                                     ("unguided", 1.0, UNGUIDED_H1X_STEPS)):
        profile_run("imagenet_b16x", f"one {what} batch of {IMAGENET_BATCH}, "
                    f"{n_steps} sampling steps",
                    lambda: _imagenet_run(bundle, IMAGENET_BATCH, cfg_scale, 2,
                                          n_steps))
    return {"guided": guided["counts"], "unguided": unguided["counts"],
            "unguided_run": unguided, "guided_tokens": guided["tokens"]}


# ---------------------------------------------------------------------------
# Quantized ImageNet sampling: #3/#4's quant modes (the imagenet_int8 phase)
# ---------------------------------------------------------------------------

def _check_imagenet_quant_sampler(name, bundle, mode, dev, seed) -> dict:
    """The whole sampler's round route in a quant mode at one ImageNet head
    (``bundle.head_stacked`` quantized) and its guided path's rows: 1 step
    (mean gap) and 4 steps (max gap) against the plain version,
    IMAGENET_STEPS steps (sign
    agreement, eager / device-only / no-PDL times, the plain version's time,
    the bound by bytes of the quantized stack), launches a net call against
    the formula, then each integer head GEMM product against its twin
    (_check_quant_gemm with the round route's modes)."""
    import torch

    from bitdance_tpu_torch.ops.fused_head import (
        fused_em_sample,
        fused_em_sample_reference,
        rounds_residual,
    )

    head, stacked = bundle.head, bundle.head_stacked
    kw, inputs = imagenet_sampler_inputs(bundle, dev, seed)
    kw["quant"] = mode
    if not rounds_residual(stacked, kw["num_blocks"], head.attention):
        raise SystemExit(f"imagenet_int8 {name} {mode}: the stack does not take the round "
                         "route")
    cfg = 4.0
    with torch.no_grad():
        args = inputs(1)
        got = fused_em_sample(stacked, *args[:3], *args[3:], cfg, **kw)
        want = fused_em_sample_reference(stacked, *args[:3], *args[3:], cfg, **kw)
        gap = ((got - want).abs().mean() / want.abs().max()).item()
        args = inputs(4)
        got = fused_em_sample(stacked, *args[:3], *args[3:], cfg, **kw)
        want = fused_em_sample_reference(stacked, *args[:3], *args[3:], cfg, **kw)
        torch.cuda.synchronize()
        err, rel = _errors(got, want)
        args = inputs(IMAGENET_STEPS)
        run_k = lambda: fused_em_sample(stacked, *args[:3], *args[3:], cfg, **kw)  # noqa: E731
        run_p = lambda: fused_em_sample_reference(stacked, *args[:3], *args[3:],  # noqa: E731
                                                  cfg, **kw)
        xk, xp = run_k(), []
        pms = cuda_time_ms(lambda: xp.append(run_p()), 1, warmup=0)
        agree = (torch.sign(xk) == torch.sign(xp[0])).float().mean().item()
        ms = cuda_time_ms(run_k, 3, warmup=1)
        times = sampler_times(lambda pdl: fused_em_sample(stacked, *args[:3], *args[3:], cfg,
                                                          _pdl=pdl, **kw))
        per_net = _sampler_launches(lambda s: fused_em_sample(
            stacked, args[0], args[1][:s], args[2][:s + 1], args[3], args[4], cfg, **kw))
    want_net = sampler_net_launches(kw["num_blocks"], head.attention, mode)
    bd = sampler_bound(stacked, args[0], args[1], args[2], attention=head.attention,
                       groups=kw["groups"], window=head.parallel_num, quant=mode)
    mats = ("w1", "w2") + (("wqkv", "wo") if head.attention else ())
    wbytes = nbytes(*[stacked[k] for k in mats + tuple(m + "_s" for m in mats)])
    fam = "TransEncoder" if head.attention else "MlpEncoder"
    calls = IMAGENET_STEPS + 1
    log("imagenet_int8", f"fused_em_sample {name} {mode} ({fam}, round route, C="
        f"{head.ch_latent}, {head.depth_latent} blocks, R={2 * args[0].shape[0]}, block "
        f"weights {wbytes / 1e6:.1f} MB): 1 step mean gap {gap:.3e} (bound "
        f"{IMAGENET_QUANT_STEP_MEAN_GAP}); 4 steps max abs err {err:.3e}, rel {rel:.3e} "
        f"(bound {IMAGENET_QUANT_SAMPLER_MAX_REL_ERR}); {IMAGENET_STEPS} steps: +-1 "
        f"agreement {agree:.4f} (floor {SAMPLER_SIGN_AGREEMENT_FLOOR}), kernel {ms:.2f} ms "
        f"({ms / calls:.4f} per net call; "
        + ", ".join(f"{q} {v / calls:.4f}" for q, v in times.items())
        + f"), plain {pms:.2f} ms, bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}, "
        f"{bd['bound_ms'] / calls:.4f} per net call); {per_net:g} launches per net call "
        f"(captured; formula {want_net})")
    if (not torch.isfinite(xk).all() or gap > IMAGENET_QUANT_STEP_MEAN_GAP
            or rel > IMAGENET_QUANT_SAMPLER_MAX_REL_ERR or agree < SAMPLER_SIGN_AGREEMENT_FLOOR):
        raise SystemExit(f"fused_em_sample {name} {mode}: 1-step gap {gap}, rel {rel}, "
                         f"agreement {agree}")
    if per_net != want_net:
        raise SystemExit(f"fused_em_sample {name} {mode}: {per_net} launches per net call, "
                         f"want {want_net}")
    products = _check_quant_gemm(mode, stacked, 2 * args[0].shape[0], dev, seed + 100,
                                 ROUND_QUANT_GEMM_PRODUCTS, "imagenet_int8", f"{name} ")
    return {"max_abs_err": err, "ms": ms, "plain_ms": pms, **bd, "library_ms": None,
            **times, "launches_per_net_call": per_net, "products": products,
            "sign_agreement": agree, "step_mean_gap": gap}


def phase_imagenet_int8(h1x, b16x, bf16_tokens: dict, card: str) -> dict:
    """Quantized ImageNet sampling (ROADMAP A8) from the bf16 samplers' own
    seeded weights (io/random_init.py::quantize_imagenet_sampler, the bf16
    samplers kept): kernels #3/#4's quant modes against their plain version
    (H-1x MlpEncoder at 64 rows and B-16x TransEncoder at 1024 rows, int8
    and int4), then guided batches of IMAGENET_BATCH classes at full width
    and depth with every count set to 0 before and read after: H-1x at cfg
    4.55 with the W8A8 backbone, the int8 KV cache and the int8 head;
    B-16x at cfg 6.1 with the int8 head and with the int4 head. Each batch
    decodes to uint8 images; its tokens are compared with the bf16 batch of
    the same seed (imagenet_h1x / imagenet_b16x)."""
    import torch

    from bitdance_tpu_torch.io.random_init import quantize_imagenet_sampler

    dev = h1x.head.net.input_proj.weight.device
    t0 = time.perf_counter()
    out, launches = {}, {}
    runs = (("h1x", h1x, "int8", True, 4.55), ("b16x", b16x, "int8", False, 6.1),
            ("b16x", b16x, "int4", False, 6.1), ("h1x", h1x, "int4", False, None))
    for i, (name, bundle, mode, backbone, cfg_scale) in enumerate(runs):
        torch.cuda.synchronize()
        tq = time.perf_counter()
        q = quantize_imagenet_sampler(bundle, backbone=backbone,
                                      head_quant=True if mode == "int8" else "int4")
        torch.cuda.synchronize()
        log("imagenet_int8", f"{name}: {mode} head stack"
            + (" and W8A8 backbone" if backbone else "") + " from the bf16 sampler's "
            f"weights in {time.perf_counter() - tq:.2f} s; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        out[f"{name}_{mode}"] = _check_imagenet_quant_sampler(name, q, mode, dev, 40 + i)
        if cfg_scale is None:                   # H-1x int4: the kernel checks only
            continue
        steps = q.cfg.num_tokens // q.cfg.parallel_num
        r = _imagenet_run(q, IMAGENET_BATCH, cfg_scale, 0, IMAGENET_STEPS, kv_int8=backbone)
        agree = (r["tokens"] == bf16_tokens[name]).float().mean().item()
        what = (f"{IMAGENET_BATCH} images, cfg {cfg_scale} linear, {IMAGENET_STEPS} sampling "
                f"steps, {steps} AR steps; {mode} head"
                + (", W8A8 backbone, int8 KV cache" if backbone else ", bf16 backbone")
                + f"; +-1 agreement with the bf16 batch of the same seed {agree:.4f}")
        _log_run("imagenet_int8", what, r, {"fused_em_sample": steps, "fused_mlp_block": 0,
                                            "fused_attn_block": 0}, card)
        out[f"{name}_{mode}"].update(batch_s=r["s"], batch_timing=r["timing"],
                                     peak_gib=r["peak_gib"], bf16_agreement=agree)
        launches[f"{name}_{mode}"] = r["counts"]["fused_em_sample"]
        del q, r
        gc.collect()
        torch.cuda.empty_cache()
    log("imagenet_int8", f"done in {time.perf_counter() - t0:.1f} s")
    out["b16x_int4"]["shapes"] = {"h1x": {k: out["h1x_int4"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "device_ms",
        "launches_per_net_call", "products")}}
    return {"results": out, "launches": launches}


# ---------------------------------------------------------------------------
# Kernel #5: one whole DiffNet forward (csrc/fused_net.cu)
# ---------------------------------------------------------------------------

def _net_inputs(head, stacked, lead, dev, seed, edge_rows=False):
    """x [*lead, ch], t [*lead] (one t per group for the TransEncoder, as
    the sampler gives), cond [*lead, z] and c_emb = cond @ cond_w + cond_b.
    edge_rows: the first and last row of every window get a large cond, so
    their adaLN mods, and with them their q, k and v, are large: a window
    off by one row then moves the net's output far past its bound."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    ch = head.ch_target
    x = torch.randn((*lead, ch), generator=g, device=dev)
    t_rows = torch.rand((lead[0],), generator=g, device=dev) * 0.9 + 0.05
    t = t_rows[:, None].expand(lead).contiguous() if len(lead) == 2 else t_rows
    cond = torch.randn((*lead, head.ch_cond), generator=g, device=dev)
    if edge_rows:
        cond[:, [0, lead[1] - 1]] *= IMAGENET_EDGE_SHIFT
    cond = cond.bfloat16()
    c_emb = cond.float() @ stacked["cond_w"].float().t() + stacked["cond_b"]
    return x, t, t_rows, cond, c_emb


def _poisoned_groups(stacked, num_ada: int, attention: bool) -> dict:
    """The stack with adaLN groups 1.. scaled by -3 (a copy of modcat_w), so
    a group read one block late moves the net far past its bound."""
    mc = (6 if attention else 3) * stacked["n2"].shape[-1]
    w = stacked["modcat_w"].clone()
    w[mc:num_ada * mc] *= -3.0
    return dict(stacked, modcat_w=w)


def net_bound(stacked, x, t, c_emb, *, attention, groups=1, window=1) -> dict:
    """Bound of one net call: every weight it reads (the block stacks, the
    t-MLP, the input and output projections, all of modcat) and x, t, c_emb
    once, the output once; operations of its products and window
    attention."""
    mats = ["w1", "w2", "t_w0", "t_w2", "in_w", "f_out_w", "modcat_w"] \
        + (["wqkv", "wo"] if attention else [])
    vecs = ["b1", "b2", "n2", "t_b0", "t_b2", "in_b", "f_out_b", "modcat_b"] \
        + (["bqkv", "bo", "n1"] if attention else [])
    rows = x.numel() // x.shape[-1]
    flops = 2.0 * rows * sum(stacked[k].numel() for k in mats)
    if attention:
        c, blocks = stacked["n2"].shape[-1], stacked["w1"].shape[0]
        flops += 4.0 * groups * window * window * c * blocks
    return roofline(nbytes(*[stacked[k] for k in mats + vecs], x, t, c_emb, x), flops)


def _captured_kernels(run) -> int:
    """Kernel launches of one call of ``run``: the kernel nodes of a CUDA
    graph captured from it on a side stream (driver API, relaxed mode, after
    one warm-up call there so the allocator holds the call's blocks). The
    graph is destroyed unlaunched. A host sync inside ``run`` ends the
    capture with an error, which fails the run."""
    import ctypes

    import torch

    cu = ctypes.CDLL("libcuda.so.1")
    vp, sz = ctypes.c_void_p, ctypes.c_size_t
    cu.cuStreamBeginCapture_v2.argtypes = [vp, ctypes.c_int]
    cu.cuStreamEndCapture.argtypes = [vp, ctypes.POINTER(vp)]
    cu.cuGraphGetNodes.argtypes = [vp, vp, ctypes.POINTER(sz)]
    cu.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphDestroy.argtypes = [vp]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.synchronize()
    graph, handle = vp(), vp(side.cuda_stream)
    with torch.cuda.stream(side):
        if cu.cuStreamBeginCapture_v2(handle, 2):        # CU_STREAM_CAPTURE_MODE_RELAXED
            raise SystemExit("fused_net: cuStreamBeginCapture failed")
        try:
            run()
        finally:
            code = cu.cuStreamEndCapture(handle, ctypes.byref(graph))
    if code:
        raise SystemExit(f"fused_net: the captured call failed (CUresult {code})")
    n = sz(0)
    cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
    nodes = (vp * n.value)()
    cu.cuGraphGetNodes(graph, ctypes.cast(nodes, vp), ctypes.byref(n))
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        cu.cuGraphNodeGetType(node, ctypes.byref(kind))
        kernels += kind.value == 0                        # CU_GRAPH_NODE_TYPE_KERNEL
    cu.cuGraphDestroy(graph)
    return kernels


def _one_block_gaps(stacked, x, t, c_emb, kw, splits=None) -> tuple[float, float]:
    """Each block run alone through #5 (a view of the stack holding block l
    only) against the plain version (at the card's K splits), and the plain
    twin with fp32 qkv and h12 against it: mean |difference| / mean |plain|,
    averaged over the blocks. Returns (kernel, twin)."""
    import torch

    from bitdance_tpu_torch.ops.fused_head import (
        _ATTN_KEYS,
        _MLP_KEYS,
        fused_diffnet_forward,
        fused_diffnet_forward_reference,
    )

    keys = list(_MLP_KEYS) + (list(_ATTN_KEYS) if kw["attention"] else [])
    gap = lambda a, b: ((a - b).abs().mean() / b.abs().mean()).item()  # noqa: E731
    one = dict(kw, num_blocks=1)
    kern, twin = [], []
    for l in range(kw["num_blocks"]):
        st = dict(stacked, **{k: stacked[k][l:l + 1] for k in keys})
        want = fused_diffnet_forward_reference(st, x, t, c_emb, splits=splits, **one)
        kern.append(gap(fused_diffnet_forward(st, x, t, c_emb, **one), want))
        twin.append(gap(fused_diffnet_forward_reference(st, x, t, c_emb, fp32_qkv_h12=True,
                                                        splits=splits, **one), want))
    return sum(kern) / len(kern), sum(twin) / len(twin)


def _check_fused_net(name, bundle, lead, dev, seed) -> dict:
    """#5 against its plain version at one of the sampling paths' shapes, on
    the poisoned stack (adaLN groups 1.. scaled by -3) and on the sampler's
    own, each within its bound; one block at a time, within its bound while
    the twin that keeps qkv and h12 in fp32 (the per-call blocks' rounding)
    reads outside it (_one_block_gaps); the poisoned twins
    (adaLN group switched one block late; for the TransEncoder also windows
    one row off) at >= 4x the poisoned bound; launches per call counted from
    a captured graph against net_launches; eager, device-only (a captured
    graph) and host us a call, and the chain's launches plain (no PDL); and
    the per-call route (DiffNet.forward: #14 / #15 and torch glue) on the
    same inputs. The plain version sums every product over the card's K
    splits (net_plans), as the head GEMM does."""
    import torch

    from bitdance_tpu_torch.ops.fused_head import (
        fused_diffnet_forward,
        fused_diffnet_forward_reference,
        net_launches,
        net_plans,
    )

    head, attention = bundle.head, bundle.head.attention
    kw = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
              n_head=head.ch_latent // head.attn_head_dim if attention else 0,
              attention=attention, bounded=head.bounded)
    switch = max(1, kw["num_blocks"] // kw["num_ada"])
    rows = math.prod(lead)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = {k: p.splits for k, p in net_plans(rows, head.ch_latent, head.ch_latent * 3 // 2,
                                                attention, sm_count=sms).items()}
    stacks = {"poisoned": _poisoned_groups(bundle.head_stacked, kw["num_ada"], attention),
              "sampler": bundle.head_stacked}
    stacked = stacks["poisoned"]
    x, t, t_rows, cond, c_emb = _net_inputs(head, stacked, lead, dev, seed,
                                            edge_rows=attention)
    bounds = FUSED_NET_MAX_REL_ERR[name]
    want, err, rel, twin = {}, {}, {}, {}
    with torch.no_grad():
        for k, st in stacks.items():
            got = fused_diffnet_forward(st, x, t, c_emb, **kw)
            want[k] = fused_diffnet_forward_reference(st, x, t, c_emb, splits=splits, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise SystemExit(f"fused_diffnet_forward {name}: non-finite output")
            err[k], rel[k] = _errors(got, want[k])
            twin[k] = _errors(fused_diffnet_forward_reference(
                st, x, t, c_emb, fp32_qkv_h12=True, splits=splits, **kw), want[k])[1]
        want_p = want["poisoned"]
        xs, ts, _, _, cs = _net_inputs(head, stacked, lead, dev, seed + 100)
        blk = dict(zip(("kernel", "fp32 qkv and h12 twin"),
                       _one_block_gaps(bundle.head_stacked, xs, ts, cs, kw, splits)))
        late = lambda l: max(l - 1, 0) // switch  # noqa: E731
        moved = {"adaLN one block late": _errors(fused_diffnet_forward_reference(
            stacked, x, t, c_emb, group_of=late, splits=splits, **kw), want_p)[1]}
        if attention:
            roll = lambda v: v.reshape(rows, -1).roll(1, 0).reshape(*lead, -1)  # noqa: E731
            alt = fused_diffnet_forward_reference(
                stacked, roll(x), roll(t[..., None])[..., 0], roll(c_emb), splits=splits, **kw)
            alt = alt.reshape(rows, -1).roll(-1, 0).reshape(x.shape)
            moved["windows one row off"] = _errors(alt, want_p)[1]
        # the per-call route holds the sampler's weights
        pc_rel = _errors(head.net(x, t_rows, cond), want["sampler"])[1]
        run = lambda **o: fused_diffnet_forward(stacked, x, t, c_emb, **kw, **o)  # noqa: E731
        ms = cuda_time_ms(run, 100, warmup=5)
        times = {"device_ms": cuda_graph_time_ms(run, calls=10, reps=3),
                 "host_us": host_us(run, calls=50, trials=5),
                 "no_pdl_ms": cuda_time_ms(lambda: run(_pdl=False), 100, warmup=5),
                 "no_pdl_device_ms": cuda_graph_time_ms(lambda: run(_pdl=False), calls=10,
                                                        reps=3)}
        pms = cuda_time_ms(lambda: fused_diffnet_forward_reference(
            stacked, x, t, c_emb, splits=splits, **kw), 20)
        rms = cuda_time_ms(lambda: head.net(x, t_rows, cond), 100, warmup=5)
        n_fused = _captured_kernels(lambda: fused_diffnet_forward(stacked, x, t, c_emb,
                                                                  **kw))
        n_route = _captured_kernels(lambda: head.net(x, t_rows, cond))
    bd = net_bound(stacked, x, t, c_emb, attention=attention,
                   groups=lead[0] if attention else 1,
                   window=lead[1] if attention else 1)
    want_n = net_launches(kw["num_blocks"], kw["num_ada"], attention)
    fam = "TransEncoder" if attention else "MlpEncoder"
    fmt = lambda d: json.dumps({k: float(f"{v:.4g}") for k, v in d.items()})  # noqa: E731
    log("fused_net", f"fused_diffnet_forward {name} ({fam}, C={head.ch_latent}, "
        f"{kw['num_blocks']} blocks, {kw['num_ada']} groups, x {tuple(x.shape)}): "
        f"max abs err {fmt(err)}, rel {fmt(rel)} (bounds "
        f"{fmt(bounds)}; the fp32-qkv-and-h12 twin reads {fmt(twin)}); one block "
        f"at a time, mean rel {fmt(blk)} (bound {FUSED_NET_BLOCK_MEAN_REL_ERR[name]}"
        f", the twin above it); poisoned plain twins move it by {fmt(moved)} of max "
        f"(floor {4 * bounds['poisoned']}); kernel {ms:.4f} ms eager, "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items())
        + f" ({n_fused} kernels per call in a captured graph, net_launches {want_n}; "
        f"head GEMM splits {json.dumps(splits)}), plain {pms:.4f} ms, "
        f"per-call route (DiffNet.forward) {rms:.4f} ms ({n_route} kernels per "
        f"call in a captured graph; rel {pc_rel:.3e} from #5's plain version), "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    bb = FUSED_NET_BLOCK_MEAN_REL_ERR[name]
    if (any(rel[k] > bounds[k] for k in stacks) or blk["kernel"] > bb
            or blk["fp32 qkv and h12 twin"] <= bb
            or min(moved.values()) < 4 * bounds["poisoned"] or n_fused != want_n):
        raise SystemExit(f"fused_diffnet_forward {name}: rel {rel} (bounds {bounds}), "
                         f"one block at a time {blk} (bound {bb}), poisoned {moved}, "
                         f"{n_fused} kernels per call (net_launches {want_n})")
    return {"max_abs_err": err["poisoned"], "ms": ms, "plain_ms": pms, **bd,
            "library_ms": None, "route_ms": rms, **times, "launches_per_call": n_fused}


def fused_net_sampler(head, stacked):
    """The unguided per-call sampler with every net call through #5: the
    draws and the loop of DiffHead.sample_per_call, its net_fn a closure
    over fused_diffnet_forward (c_emb computed once per AR step). A
    measurement of the smoke script, not a route of DiffHead."""
    import math

    import torch

    from bitdance_tpu_torch.models.diff_head import draw_sampler_noise
    from bitdance_tpu_torch.models.sampling import euler_maruyama
    from bitdance_tpu_torch.ops.fused_head import fused_diffnet_forward

    kw = dict(num_blocks=head.depth_latent, num_ada=head.depth_adanln,
              n_head=head.ch_latent // head.attn_head_dim if head.attention else 0,
              attention=head.attention, bounded=head.bounded)

    def sample_fn(cond, generator, cfg, num_sampling_steps, cfg_mult):
        c_emb = cond.float() @ stacked["cond_w"].float().t() + stacked["cond_b"]

        def net_fn(x, t, _cond):
            tt = t[:, None].expand(x.shape[:-1]) if x.ndim == 3 else t
            return fused_diffnet_forward(stacked, x, tt, c_emb, **kw)

        x_shape = [cond.shape[0] // cfg_mult, *cond.shape[1:-1], head.ch_target]
        half = math.prod(x_shape[:-1])
        x0, noise = draw_sampler_noise(generator, half, head.ch_target,
                                       num_sampling_steps, cond.device)
        with torch.no_grad():
            return euler_maruyama(
                net_fn, cond, None, head.ch_target, cfg=cfg, cfg_mult=cfg_mult,
                num_sampling_steps=num_sampling_steps, flow_shift=head.time_shift,
                x_init=x0.reshape(x_shape),
                noise=noise.reshape(num_sampling_steps, *x_shape))

    return sample_fn


def _check_net_gemms(h1x, b16x) -> dict:
    """#5's fp32 product of the adaLN groups (out_f32) against its split twin
    at H-1x's 8 rows and B-16x's 512, over the groups' rows of modcat_w in
    turn (_check_head_gemm, every split count)."""
    dev = h1x.head.net.input_proj.weight.device
    out = {}
    for key, bundle, rows, seed in (("h1x_8", h1x, UNGUIDED_H1X_IMAGES, 24),
                                    ("b16x", b16x, IMAGENET_BATCH * 16, 25)):
        head, st = bundle.head, bundle.head_stacked
        m = (6 if head.attention else 3) * head.ch_latent
        groups = {"mods": st["modcat_w"][:head.depth_adanln * m].view(
            head.depth_adanln, m, head.ch_latent)}
        out[key] = _check_head_gemm(f"net_{key}", groups, ("mods",), rows, dev, seed,
                                    products=NET_GEMM_PRODUCTS, phase="fused_net",
                                    all_splits=True)
    return out


def phase_fused_net(h1x, b16x, unguided_tokens: dict, card: str) -> dict:
    """#5 at the ImageNet heads' shapes (H-1x MlpEncoder: the unguided 8 and
    guided 64 rows; B-16x TransEncoder: 32 windows of 16), then the
    unguided batches of imagenet_h1x and imagenet_b16x again from the same
    draws with every net call through #5 (the kernel's main path here; the
    counts set to 0 before and read after), against today's per-call route
    (their tokens and s/batch from the earlier phases)."""
    dev = h1x.head.net.input_proj.weight.device
    out = {
        "h1x_8": _check_fused_net("h1x", h1x, (UNGUIDED_H1X_IMAGES,), dev, 21),
        "h1x_64": _check_fused_net("h1x", h1x, (2 * IMAGENET_BATCH,), dev, 22),
        "b16x": _check_fused_net("b16x", b16x, (IMAGENET_BATCH, 16), dev, 23),
    }
    for key, products in _check_net_gemms(h1x, b16x).items():
        out[key]["products"] = products
    out["h1x_8"]["shapes"] = {k: {q: out[k][q] for q in ("ms", "device_ms", "host_us",
                                                          "no_pdl_ms", "no_pdl_device_ms")}
                              for k in ("h1x_64", "b16x")}
    launches = 0
    for name, bundle, n, steps in (("h1x", h1x, UNGUIDED_H1X_IMAGES, UNGUIDED_H1X_STEPS),
                                   ("b16x", b16x, IMAGENET_BATCH, IMAGENET_STEPS)):
        ar_steps = bundle.cfg.num_tokens // bundle.cfg.parallel_num
        r = _imagenet_run(bundle, n, 1.0, 1, steps,
                          head_sampler=fused_net_sampler(bundle.head,
                                                         bundle.head_stacked))
        route = unguided_tokens[name]
        agree = (r["tokens"] == route["tokens"]).float().mean().item()
        _log_run("fused_net", f"{name}: {n} images unguided, {steps} sampling steps "
                 f"through #5 (per-call route: {route['s']:.3f} s/batch); +-1 "
                 f"agreement with the per-call route's tokens {agree:.4f}", r,
                 {"fused_diffnet_forward": ar_steps * (steps + 1),
                  "fused_mlp_block": 0, "fused_attn_block": 0}, card)
        launches += r["counts"]["fused_diffnet_forward"]
    out["launches"] = launches
    return out


@contextlib.contextmanager
def _plain_head():
    """The head's kernels replaced by their plain versions inside
    models/diff_head.py (the *_reference blocks and
    fused_em_sample_reference), which launch and count nothing."""
    from bitdance_tpu_torch.models import diff_head as dh
    from bitdance_tpu_torch.ops import fused_block as fb
    from bitdance_tpu_torch.ops import fused_head as fh

    names = ("fused_mlp_block", "fused_attn_block", "fused_em_sample")
    saved = [getattr(dh, k) for k in names]
    for k, mod in zip(names, (fb, fb, fh)):
        setattr(dh, k, getattr(mod, k + "_reference"))
    try:
        yield
    finally:
        for k, f in zip(names, saved):
            setattr(dh, k, f)


# the free-running witness's sampling steps (100, IMAGENET_STEPS, until PR
# 23: cut for the script's time)
FREE_RUNNING_STEPS = 50


def _free_running(bundle) -> None:
    """The guided B-16x batch at FREE_RUNNING_STEPS sampling steps with each
    head path's tokens fed back through the backbone, all from the same
    draws: the per-call kernels (#15 + #14) against the whole-sampler
    kernel, and the same two paths through their plain versions, a witness
    of whether the drift comes from rounding (the per-call residual is
    bf16, the whole sampler's fp32) or from a kernel. Reported, not
    checked: free-running tokens diverge once one token flips."""
    head = bundle.head

    def per_call(cond, generator, cfg_iter, n_steps, cfg_mult):
        return head.sample_per_call(cond, generator, cfg_iter, n_steps, cfg_mult)

    run = lambda **kw: _imagenet_run(bundle, IMAGENET_BATCH, 6.1, 0,  # noqa: E731
                                     FREE_RUNNING_STEPS, **kw)
    t0 = time.perf_counter()
    tokens = {"kernel_per_call": run(head_sampler=per_call), "kernel_whole": run()}
    with _plain_head():
        tokens["plain_per_call"] = run(head_sampler=per_call)
        tokens["plain_whole"] = run()
    if not all(r["ok"] for r in tokens.values()):
        raise SystemExit("imagenet_b16x: a free-running batch failed its checks")
    tokens = {k: r["tokens"] for k, r in tokens.items()}
    share = lambda a, b: (tokens[a] == tokens[b]).float().mean().item()  # noqa: E731
    pairs = (("kernel_per_call", "kernel_whole"), ("plain_per_call", "plain_whole"),
             ("kernel_whole", "plain_whole"), ("kernel_per_call", "plain_per_call"))
    log("imagenet_b16x", f"the guided batch free-running from the same draws at "
        f"{FREE_RUNNING_STEPS} sampling steps, +-1 agreement: "
        + ", ".join(f"{a} vs {b} {share(a, b):.4f}" for a, b in pairs)
        + f" ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# BitDance-14B-64x packed training (sparse flash kernels #10-#12) and the
# tokenizer's encode tail (#13)
# ---------------------------------------------------------------------------

def _t2i_samples(n: int, seed: int, side: int = 32, prompt: int = 40, p: int = 64):
    """Seeded T2I samples as benchmarks/bench_train.py draws them: prompts
    of ``prompt`` token ids, side x side ±1 latents (512 px at side 32)."""
    import numpy as np

    from bitdance_tpu_torch.data.packing import T2ISample

    rng = np.random.default_rng(seed)
    return [T2ISample(
        text_ids=rng.integers(1, 2000, prompt),
        image_latents=np.sign(rng.normal(size=(side * side, 32))).astype(np.float32),
        latent_h=side, latent_w=side, vision_start_id=2001, res_h_id=2033,
        res_w_id=2033, query_ids=np.arange(2100, 2100 + p - 1), text_loss=True)
        for _ in range(n)]


def _sparse_case(dev):
    """q, k, v, do (bf16, Qwen3-14B's 40 / 8 heads at head dim 128) over the
    ids of 7 samples packed by the port's packer into 8,192 tokens (7,910
    tokens of 7 documents, then the packer's padding, one block of 282), and
    the bound on live 64-key tiles from the longest document."""
    import torch

    from bitdance_tpu_torch.data.packing import pack_t2i_batch, sincos_1d_table_np
    from bitdance_tpu_torch.ops.attention import live_tile_bound

    samples = _t2i_samples(7, 77)
    raw = pack_t2i_batch(samples, 64, 8192, sincos_1d_table_np(64, 64))
    blk = torch.from_numpy(raw["block_ids"]).to(dev)[None]
    doc = torch.from_numpy(raw["doc_ids"]).to(dev)[None]
    ids = (blk, doc, blk, doc)
    L = blk.shape[1]
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, L, 40, 128), generator=g, device=dev).bfloat16()
    k = torch.randn((1, L, 8, 128), generator=g, device=dev).bfloat16()
    v = torch.randn((1, L, 8, 128), generator=g, device=dev).bfloat16()
    do = torch.randn((1, L, 40, 128), generator=g, device=dev).bfloat16()
    longest = 40 + 3 + 63 + 32 * 32
    return q, k, v, do, ids, live_tile_bound(longest), longest


def _row_stats(got, want):
    """Per token row of [B, L, H, D] tensors: (max abs error, max |want|)
    over the row's heads and dims, each [B, L]."""
    return ((got.float() - want.float()).abs().amax(dim=(2, 3)),
            want.float().abs().amax(dim=(2, 3)))


def _row_rel(err, mag) -> float:
    """The largest per-row error relative to its row's own max |want|."""
    return (err / mag.clamp_min(1e-30)).max().item()


def _one_tile_off(plan, ids, longest: int) -> dict:
    """Three kv tile lists one tile off plan's: the diagonal tile dropped
    from the q tile where document 1 starts (its first rows see nothing
    else), a middle tile dropped from a q tile deep in document 0 (rows that
    see about 1,000 keys), and that tile listed twice there."""
    import torch

    doc = ids[1][0]
    start = int((doc[1:] != doc[:-1]).nonzero()[0]) + 1
    deep = (longest - 1) // 64 - 1
    if int(doc[0]) != int(doc[deep * 64 + 63]):
        raise SystemExit("flash_sparse: the deep q tile is not inside document 0")

    def listed(row):
        return plan.kv_map[0, row, :plan.kv_counts[0, row]]

    def edit(row, tiles):
        m, c = plan.kv_map.clone(), plan.kv_counts.clone()
        m[0, row, :tiles.numel()] = tiles
        c[0, row] = tiles.numel()
        return m, c

    row = start // 64
    first = listed(row)
    deep_tiles = listed(deep)
    mid = deep_tiles[deep_tiles.numel() // 2]
    return {
        f"diagonal tile {row} dropped where document 1 starts": edit(row, first[first != row]),
        f"tile {int(mid)} of {deep_tiles.numel()} dropped from q tile {deep}":
            edit(deep, deep_tiles[deep_tiles != mid]),
        f"tile {int(mid)} listed twice in q tile {deep}":
            edit(deep, torch.cat([deep_tiles, mid[None]])),
    }


def phase_flash_sparse() -> dict:
    """#10-#12 against their plain versions (which compute over exactly the
    listed tiles) and their autograd Function against autograd of the plain
    forward, on a packed 8,192-token case; each map one tile off must move o
    by >= 4x its per-row bound, an undersized bound must raise, and the
    dense kernels must give the same bits; times, bounds over the live
    pairs, and SDPA's."""
    import torch

    from bitdance_tpu_torch.ops.attention import (
        flash_attention_sparse,
        flash_bwd_dkv,
        flash_bwd_dkv_sparse,
        flash_bwd_dq,
        flash_bwd_dq_sparse,
        flash_fwd,
        flash_fwd_sparse,
        flash_sparse_dkv_reference,
        flash_sparse_dq_reference,
        flash_sparse_reference,
        sparse_plan,
    )

    dev = torch.device("cuda")
    q, k, v, do, ids, bound, longest = _sparse_case(dev)
    scale = 128 ** -0.5
    plan = sparse_plan(*ids, bound)
    most = int(plan.kv_counts.max())
    try:
        sparse_plan(*ids, most - 1)
    except ValueError as e:
        log("flash_sparse", f"undersized bound {most - 1} raised: {str(e)[:100]}")
    else:
        raise SystemExit("flash_sparse: an undersized max_live_kv did not raise")
    o, lse = flash_fwd_sparse(q, k, v, *ids, plan, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq = flash_bwd_dq_sparse(q, k, v, do, lse, delta, *ids, plan, scale)
    dk, dv = flash_bwd_dkv_sparse(q, k, v, do, lse, delta, *ids, plan, scale)
    # the same Function under autograd against autograd of the plain forward
    qk, kk, vk = (t.detach().clone().requires_grad_() for t in (q, k, v))
    flash_attention_sparse(qk, kk, vk, *ids, plan=plan).backward(do)
    qr, kr, vr = (t.float().requires_grad_() for t in (q, k, v))
    o_ref, lse_ref = flash_sparse_reference(qr, kr, vr, *ids, plan.kv_map,
                                            plan.kv_counts, scale, return_lse=True)
    o_ref.backward(do.float())
    torch.cuda.synchronize()
    errs, rel = {}, {}
    for key, got, want in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, qr.grad),
                           ("dk", dk, kr.grad), ("dv", dv, vr.grad),
                           ("dq_function", qk.grad, qr.grad),
                           ("dk_function", kk.grad, kr.grad),
                           ("dv_function", vk.grad, vr.grad)):
        if not torch.isfinite(got).all():
            raise SystemExit(f"flash_sparse: {key} not finite")
        errs[key], rel[key] = _errors(got, want)
    rel["o_row"] = _row_rel(*_row_stats(o, o_ref))
    # the dense kernels (#7-#9) on the same inputs: the same tiles in the
    # same order, so the same bits
    o_d, lse_d = flash_fwd(q, k, v, *ids, scale)
    dk_d, dv_d = flash_bwd_dkv(q, k, v, do, lse, delta, *ids, scale)
    dense = {"o": (o, o_d), "lse": (lse, lse_d),
             "dq": (dq, flash_bwd_dq(q, k, v, do, lse, delta, *ids, scale)),
             "dk": (dk, dk_d), "dv": (dv, dv_d)}
    dense = {key: _errors(a, b)[0] for key, (a, b) in dense.items()}
    # the plain forward over maps one tile off, per row against the true map
    with torch.no_grad():
        shifts = {what: _row_rel(*_row_stats(flash_sparse_reference(
            qr, kr, vr, *ids, m, c, scale), o_ref))
            for what, (m, c) in _one_tile_off(plan, ids, longest).items()}
    with torch.no_grad():   # two launches of each kernel: the same bits
        same = {"fwd": all(map(torch.equal, (o, lse), flash_fwd_sparse(q, k, v, *ids, plan,
                                                                       scale))),
                "dq": torch.equal(dq, flash_bwd_dq_sparse(q, k, v, do, lse, delta, *ids,
                                                          plan, scale)),
                "dkv": all(map(torch.equal, (dk, dv), flash_bwd_dkv_sparse(
                    q, k, v, do, lse, delta, *ids, plan, scale)))}
    bounds = FLASH_SPARSE_MAX_REL_ERR
    bad = [key for key, e in rel.items()
           if e > bounds[key if key in bounds else key.split("_")[0]]]
    if bad or min(shifts.values()) < 4 * bounds["o_row"] or any(dense.values()) \
            or not all(same.values()):
        raise SystemExit(f"flash_sparse: rel errors {rel} (bounds {bounds}); maps one "
                         f"tile off move o per row by {shifts}; vs the dense kernels "
                         f"{dense}; two launches bit-equal {same}")
    with torch.no_grad():
        times = {
            "fwd": (cuda_time_ms(lambda: flash_fwd_sparse(q, k, v, *ids, plan, scale), 20),
                    cuda_time_ms(lambda: flash_sparse_reference(
                        q, k, v, *ids, plan.kv_map, plan.kv_counts, scale,
                        return_lse=True), 3)),
            "dq": (cuda_time_ms(lambda: flash_bwd_dq_sparse(
                q, k, v, do, lse, delta, *ids, plan, scale), 20),
                cuda_time_ms(lambda: flash_sparse_dq_reference(
                    q, k, v, do, lse, delta, *ids, plan.kv_map, plan.kv_counts,
                    scale), 3)),
            "dkv": (cuda_time_ms(lambda: flash_bwd_dkv_sparse(
                q, k, v, do, lse, delta, *ids, plan, scale), 20),
                cuda_time_ms(lambda: flash_sparse_dkv_reference(
                    q, k, v, do, lse, delta, *ids, plan.q_map, plan.q_counts,
                    plan.block_q_dkv, scale), 3))}
        dense_ms = {"fwd": cuda_time_ms(lambda: flash_fwd(q, k, v, *ids, scale), 20),
                    "dq": cuda_time_ms(lambda: flash_bwd_dq(
                        q, k, v, do, lse, delta, *ids, scale), 20),
                    "dkv": cuda_time_ms(lambda: flash_bwd_dkv(
                        q, k, v, do, lse, delta, *ids, scale), 20)}
        # the kernels device-only (captured graph) and the host's time a call
        extra = {key: {"device_ms": cuda_graph_time_ms(fn), "host_us": host_us(fn)}
                 for key, fn in (
                     ("fwd", lambda: flash_fwd_sparse(q, k, v, *ids, plan, scale)),
                     ("dq", lambda: flash_bwd_dq_sparse(q, k, v, do, lse, delta, *ids,
                                                        plan, scale)),
                     ("dkv", lambda: flash_bwd_dkv_sparse(q, k, v, do, lse, delta, *ids,
                                                          plan, scale)))}
    log("flash_sparse", f"q {tuple(q.shape)} k {tuple(k.shape)}, 7 packed documents of "
        f"{longest} tokens + padding; max_live_kv {bound} 64-key tiles from the longest "
        f"document (most live {most}, mean {plan.kv_counts.float().mean():.2f} of "
        f"{plan.kv_map.shape[1]}); dk/dv lists of {plan.block_q_dkv}-row q tiles, most "
        f"{int(plan.q_counts.max())} of bound {plan.q_map.shape[2]}")
    log("flash_sparse", "max abs err vs plain (relative to max |value|, bound): "
        + ", ".join(f"{key} {errs[key]:.3e} ({rel[key]:.2e}, "
                    f"{bounds[key.split('_')[0]]})" for key in errs)
        + f"; o per row {rel['o_row']:.2e} of the row's max |o| (bound "
        f"{bounds['o_row']}); vs the dense kernels (max abs): "
        + ", ".join(f"{key} {e:.3e}" for key, e in dense.items()))
    log("flash_sparse", "maps one tile off move o per row by (bound >= "
        f"{4 * bounds['o_row']:.3g}): "
        + "; ".join(f"{what} {e:.3e}" for what, e in shifts.items()))
    log("flash_sparse", "two launches of the forward, dq and dk/dv bit-equal; ms "
        "kernel/plain (dense kernel): " + ", ".join(
            f"{key} {a:.4f}/{b:.4f} ({dense_ms[key]:.4f})" for key, (a, b) in times.items())
        + "; device-only (host us a call): " + ", ".join(
            f"{key} {r['device_ms']:.4f} ({r['host_us']:.1f})" for key, r in extra.items()))
    bd = _flash_bounds_and_library(q, k, v, do, ids)
    worst = lambda keys: max(errs[key] for key in keys)  # noqa: E731
    return {"flash_fwd_sparse": {"max_abs_err": worst(("o", "lse")), "ms": times["fwd"][0],
                                 "plain_ms": times["fwd"][1], **extra["fwd"], **bd["fwd"]},
            "flash_bwd_dq_sparse": {"max_abs_err": worst(("dq", "dq_function")),
                                    "ms": times["dq"][0], "plain_ms": times["dq"][1],
                                    **extra["dq"], **bd["dq"]},
            "flash_bwd_dkv_sparse": {"max_abs_err": worst(("dk", "dv", "dk_function",
                                                           "dv_function")),
                                     "ms": times["dkv"][0], "plain_ms": times["dkv"][1],
                                     **extra["dkv"], **bd["dkv"]}}


def _mllm_fwd_flops(state, cfg, batch, n_txt: int, n_vis: int) -> float:
    """Forward matmul FLOPs of one step, benchmarks/bench_train.py:239-247's
    formula: the layer stack on every packed token, lm_head on ``n_txt``
    text-loss rows, the head on ``n_vis`` vision-loss rows."""
    n_tokens = batch.position_ids.numel()
    m = state.model
    layers = sum(p.numel() for p in m.llm.model.layers.parameters())
    head = sum(p.numel() for p in m.head.parameters())
    return (2.0 * n_tokens * layers + 2.0 * n_txt * cfg.llm.vocab_size * cfg.llm.hidden_size
            + 2.0 * n_vis * cfg.diff_batch_mul * head)


def _sparse_vs_plain_chunked(q, k, v, do, got, ids, plan, scale, tiles: int = 128):
    """The sparse kernels' outputs ``got`` = (o, lse, dq, dk, dv) on a long
    packed sequence against their plain versions, run per kv head (with its
    q-head group) over ranges of ``tiles`` 64-row tiles (q tiles for o, lse
    and dq, kv tiles for dk and dv) to bound the plain versions' memory.
    Returns {key: (max abs error, relative to max |want|)} with o's largest
    per-row relative error under "o_row"."""
    import torch

    from bitdance_tpu_torch.ops.attention import (
        flash_sparse_dkv_reference,
        flash_sparse_dq_reference,
        flash_sparse_reference,
    )

    o, lse, dq, dk, dv = got
    qb, qd, kb, kd = ids
    L, hq, hkv = q.shape[1], q.shape[2], k.shape[2]
    grp = hq // hkv
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    err = dict.fromkeys(("o", "lse", "dq", "dk", "dv"), 0.0)
    mag = dict(err)
    row_err = torch.zeros((1, L), device=q.device)
    row_mag = torch.zeros_like(row_err)

    def fold(key, g, w):
        err[key] = max(err[key], (g.float() - w.float()).abs().max().item())
        mag[key] = max(mag[key], w.float().abs().max().item())

    n_q, n_k = plan.kv_map.shape[1], plan.q_map.shape[1]
    with torch.no_grad():
        for h in range(hkv):
            hs, ks = slice(h * grp, (h + 1) * grp), slice(h, h + 1)
            kh, vh = k[:, :, ks], v[:, :, ks]
            for r0 in range(0, n_q, tiles):
                rows = slice(r0 * 64, min(n_q, r0 + tiles) * 64)
                m, c = plan.kv_map[:, r0:r0 + tiles], plan.kv_counts[:, r0:r0 + tiles]
                qc, dc = q[:, rows, hs], do[:, rows, hs]
                lc, dlc = lse[:, hs, rows], delta[:, hs, rows]
                want_o, want_lse = flash_sparse_reference(
                    qc, kh, vh, qb[:, rows], qd[:, rows], kb, kd, m, c, scale,
                    return_lse=True)
                fold("o", o[:, rows, hs], want_o)
                fold("lse", lc, want_lse)
                e, w = _row_stats(o[:, rows, hs], want_o)
                row_err[:, rows] = torch.maximum(row_err[:, rows], e)
                row_mag[:, rows] = torch.maximum(row_mag[:, rows], w)
                del want_o, want_lse
                fold("dq", dq[:, rows, hs], flash_sparse_dq_reference(
                    qc, kh, vh, dc, lc, dlc, qb[:, rows], qd[:, rows], kb, kd, m, c,
                    scale))
            for c0 in range(0, n_k, tiles):
                cols = slice(c0 * 64, min(n_k, c0 + tiles) * 64)
                want_dk, want_dv = flash_sparse_dkv_reference(
                    q[:, :, hs], k[:, cols, ks], v[:, cols, ks], do[:, :, hs],
                    lse[:, hs], delta[:, hs], qb, qd, kb[:, cols], kd[:, cols],
                    plan.q_map[:, c0:c0 + tiles], plan.q_counts[:, c0:c0 + tiles],
                    plan.block_q_dkv, scale)
                fold("dk", dk[:, cols, ks], want_dk)
                fold("dv", dv[:, cols, ks], want_dv)
    out = {key: (err[key], err[key] / mag[key]) for key in err}
    out["o_row"] = (None, _row_rel(row_err, row_mag))
    return out


def mllm_step_batch(dev):
    """The 14B packed training step's configuration (MLLM_LAYERS of 40
    layers, no warmup) and its one packed sequence: (cfg, tcfg, the yaml's
    data section, the packed samples, the PackedBatch on ``dev``). The
    samples are added to GreedyPacker until it emits a sequence; the text
    and vision loss budgets are the packer's default (the sequence budget),
    as scripts/train_mllm.py packs them."""
    import dataclasses

    from bitdance_tpu_torch.config import (
        BITDANCE_14B_64X,
        mllm_config_from_yaml,
        mllm_train_config_from_yaml,
    )
    from bitdance_tpu_torch.data.packing import (
        GreedyPacker,
        pack_t2i_batch,
        sincos_1d_table_np,
        stack_packed_batches,
    )
    from bitdance_tpu_torch.models.mllm import PackedBatch

    yaml = BITDANCE_14B_64X
    cfg = mllm_config_from_yaml(yaml, 152064)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_hidden_layers=MLLM_LAYERS))
    tcfg = dataclasses.replace(mllm_train_config_from_yaml(yaml), warmup_steps=0)
    data = yaml["data"]
    p = cfg.parallel_num
    packer = GreedyPacker(p, data["expected_num_tokens"], data["max_num_tokens"],
                          data["max_num_tokens_per_sample"])
    chosen, seed = None, 0
    while chosen is None:
        for s in _t2i_samples(8, 1000 + seed):
            chosen = chosen or packer.add(s)
        seed += 1
    raw = pack_t2i_batch(chosen, p, data["max_num_tokens"],
                         sincos_1d_table_np(cfg.llm.hidden_size // 2, cfg.pe_max_len))
    return cfg, tcfg, data, chosen, PackedBatch.from_numpy(stack_packed_batches([raw]), dev)


def phase_mllm(card: str) -> dict:
    """Path A: BitDance-14B-64x packed training at full width, MLLM_LAYERS of
    40 layers, bf16 parameters, gradients and AdamW moments, one packed
    sequence at the yaml's budget; steps on the sparse kernels, then one
    step on the dense kernels from the same state."""
    import dataclasses

    import torch

    from bitdance_tpu_torch.io.random_init import build_random_mllm_train_state
    from bitdance_tpu_torch.ops.attention import (
        flash_bwd_dkv,
        flash_bwd_dkv_sparse,
        flash_bwd_dq,
        flash_bwd_dq_sparse,
        flash_fwd,
        flash_fwd_sparse,
        sparse_plan,
    )
    from bitdance_tpu_torch.ops.chunked_ce import chunked_cross_entropy
    from bitdance_tpu_torch.train.mllm_train import loss_and_grads, train_step

    dev = torch.device("cuda")
    cfg, tcfg, data, chosen, batch = mllm_step_batch(dev)
    L = batch.position_ids.shape[1]
    used = int((batch.doc_ids >= 0).sum())
    n_txt = int((batch.ce_text_weights > 0).sum())
    n_vis = int((batch.vision_loss_weights > 0).sum())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = build_random_mllm_train_state(cfg, tcfg, dev, torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    m = state.model
    count = lambda mod: sum(x.numel() for x in mod.parameters())  # noqa: E731
    log("mllm", f"BitDance-14B-64x random bf16 train state ({MLLM_LAYERS} of 40 Qwen3-14B "
        f"layers, vocab {cfg.llm.vocab_size}, head {cfg.head_model_dim} x "
        f"{cfg.head_num_blocks} blocks, no EMA: {state.ema is None}) in "
        f"{time.perf_counter() - t0:.1f} s: layers {count(m.llm.model.layers) / 1e9:.3f} B, "
        f"embedding + lm_head {(count(m.llm) - count(m.llm.model.layers)) / 1e9:.3f} B, head "
        f"{count(m.head) / 1e9:.3f} B, projector {count(m.projector) / 1e6:.1f} M parameters; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    plan = sparse_plan(batch.block_ids, batch.doc_ids, batch.block_ids, batch.doc_ids,
                       cfg.attn_live_tiles())
    log("mllm", f"packed {len(chosen)} samples (40-token prompts, 512 px) by GreedyPacker "
        f"(expected {data['expected_num_tokens']}, max {data['max_num_tokens']}): "
        f"{used} of {L} tokens in documents; {n_txt} text-loss rows of the CE's "
        f"{batch.ce_text_indexes.numel()}, {n_vis} vision-loss rows of the head's "
        f"{batch.vision_loss_indexes.numel()}; attn_max_live_kv {cfg.attn_max_live_kv} JAX tiles -> "
        f"{cfg.attn_live_tiles()} 64-key tiles; live kv tiles per q tile: most "
        f"{int(plan.kv_counts.max())}, mean {plan.kv_counts.float().mean():.2f} of "
        f"{plan.kv_map.shape[1]}")
    del plan
    flops = _mllm_fwd_flops(state, cfg, batch, n_txt, n_vis)
    flops_all = _mllm_fwd_flops(state, cfg, batch, batch.ce_text_indexes.numel(),
                                batch.vision_loss_indexes.numel())
    watch = {n: x for n, x in m.named_parameters()
             if n in ("llm.model.layers.0.self_attn.q_proj.weight", "llm.lm_head.weight",
                      "llm.model.embed_tokens.weight", "head.net.final_layer.linear.weight",
                      "projector.fc1.weight")}
    init = {n: x.detach().clone() for n, x in watch.items()}
    sparse_fns = (flash_fwd_sparse, flash_bwd_dq_sparse, flash_bwd_dkv_sparse)
    dense_fns = (flash_fwd, flash_bwd_dq, flash_bwd_dkv)
    want = (2 * MLLM_LAYERS, MLLM_LAYERS, MLLM_LAYERS, 0, 0, 0)
    _reset_counts()
    steps = []
    for i in range(MLLM_STEPS):
        before = tuple(f.launches for f in sparse_fns + dense_fns)
        t = time.perf_counter()
        mt = train_step(state, batch, i, cfg=cfg, tcfg=tcfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        mt = {k: val.item() for k, val in mt.items()}
        got = tuple(f.launches - b for f, b in zip(sparse_fns + dense_fns, before))
        moved = {n.split(".")[-2]: (x.detach() != init[n]).any().item()
                 for n, x in watch.items()}
        steps.append({"s": dt, **mt})
        log("mllm", f"step {i + 1}: {dt:.3f} s; loss {mt['loss']:.5f} (ce_loss_text "
            f"{mt['ce_loss_text']:.5f}, ce_loss_vision {mt['ce_loss_vision']:.5f}), "
            f"grad_norm {mt['grad_norm']:.5f}; launches sparse fwd/dq/dkv, dense "
            f"fwd/dq/dkv {got}; parameters moved {moved}")
        finite = all(val == val and abs(val) < float("inf") for val in mt.values())
        if got != want or not finite or not all(moved.values()):
            raise SystemExit(f"mllm step {i + 1} failed its checks (launches {got}, "
                             f"want {want})")
    launches = {"flash_fwd_sparse": flash_fwd_sparse.launches,
                "flash_bwd_dq_sparse": flash_bwd_dq_sparse.launches,
                "flash_bwd_dkv_sparse": flash_bwd_dkv_sparse.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    steady = sorted(s["s"] for s in steps[1:])
    s_step = steady[len(steady) // 2]
    mfu = 3 * flops / s_step / H100_BF16_PEAK
    log("mllm", f"steady s/step {s_step:.4f} (median of steps 2-{MLLM_STEPS}: "
        f"{', '.join(f'{s:.4f}' for s in steady)}); {L / s_step:.1f} tokens/s ({used / s_step:.1f} "
        f"in documents); 3 x forward matmul FLOPs on the loss rows {3 * flops / 1e12:.2f} "
        f"TFLOP -> {3 * flops / s_step / 1e12:.1f} TFLOP/s, MFU {mfu:.4f} of the "
        f"{H100_BF16_PEAK / 1e12:.0f} TFLOP/s dense bf16 peak (with the padding rows the "
        f"step computes {3 * flops_all / 1e12:.2f} TFLOP: MFU {mfu * flops_all / flops:.4f}); "
        f"peak memory {peak:.2f} GiB; "
        f"launches per step sparse fwd/dq/dkv {want[:3]} (2 x layers: the checkpointed "
        f"layers run the forward again); card {card}")
    if peak > MLLM_PEAK_GIB:
        raise SystemExit(f"mllm: peak memory {peak:.2f} GiB over {MLLM_PEAK_GIB}")
    profile_run("mllm", "one train step (sparse attention)",
                lambda: train_step(state, batch, 90, cfg=cfg, tcfg=tcfg))
    # the chunked CE (forward and backward) at the CE's budget and at the
    # text-loss rows alone: what the padding rows cost
    g = torch.Generator(device=dev).manual_seed(8)
    lm_w = m.llm.output_weight().detach()
    ce_ms = {}
    for rows in (batch.ce_text_indexes.numel(), n_txt):
        h = torch.randn((rows, cfg.llm.hidden_size), generator=g, device=dev).bfloat16()
        lab = torch.randint(0, cfg.llm.vocab_size, (rows,), generator=g, device=dev)
        h.requires_grad_()
        w = lm_w.clone().requires_grad_()
        ce_ms[rows] = cuda_time_ms(lambda: torch.autograd.grad(  # noqa: B023
            chunked_cross_entropy(h, w, lab).sum(), (h, w)), 1, warmup=1)
        del h, w, lab
    log("mllm", "chunked CE forward + backward (152,064 columns, fp32 products): "
        + ", ".join(f"{rows} rows {t:.1f} ms" for rows, t in ce_ms.items()))
    # the sparse kernels at this batch's shape: against their plain versions
    # (in chunks) and the dense kernels (the same bits)
    hq, hkv, hd = cfg.llm.num_attention_heads, cfg.llm.num_key_value_heads, cfg.llm.head_dim
    q = torch.randn((1, L, hq, hd), generator=g, device=dev).bfloat16()
    k = torch.randn((1, L, hkv, hd), generator=g, device=dev).bfloat16()
    v = torch.randn((1, L, hkv, hd), generator=g, device=dev).bfloat16()
    do = torch.randn((1, L, hq, hd), generator=g, device=dev).bfloat16()
    ids = (batch.block_ids, batch.doc_ids, batch.block_ids, batch.doc_ids)
    plan = sparse_plan(*ids, cfg.attn_live_tiles())
    sc = hd ** -0.5
    with torch.no_grad():
        o, lse = flash_fwd_sparse(q, k, v, *ids, plan, sc)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq = flash_bwd_dq_sparse(q, k, v, do, lse, delta, *ids, plan, sc)
        dk, dv = flash_bwd_dkv_sparse(q, k, v, do, lse, delta, *ids, plan, sc)
        o_d, lse_d = flash_fwd(q, k, v, *ids, sc)
        dk_d, dv_d = flash_bwd_dkv(q, k, v, do, lse, delta, *ids, sc)
        equal = {"o": torch.equal(o, o_d), "lse": torch.equal(lse, lse_d),
                 "dq": torch.equal(dq, flash_bwd_dq(q, k, v, do, lse, delta, *ids, sc)),
                 "dk": torch.equal(dk, dk_d), "dv": torch.equal(dv, dv_d)}
        del o_d, lse_d, dk_d, dv_d
        ms = [cuda_time_ms(fn, 5) for fn in (
            lambda: flash_fwd_sparse(q, k, v, *ids, plan, sc),
            lambda: flash_fwd(q, k, v, *ids, sc),
            lambda: flash_bwd_dq_sparse(q, k, v, do, lse, delta, *ids, plan, sc),
            lambda: flash_bwd_dq(q, k, v, do, lse, delta, *ids, sc),
            lambda: flash_bwd_dkv_sparse(q, k, v, do, lse, delta, *ids, plan, sc),
            lambda: flash_bwd_dkv(q, k, v, do, lse, delta, *ids, sc))]
        fwd_dev = cuda_graph_time_ms(lambda: flash_fwd_sparse(q, k, v, *ids, plan, sc),
                                     calls=5, reps=2)
    t = time.perf_counter()
    errs = _sparse_vs_plain_chunked(q, k, v, do, (o, lse, dq, dk, dv), ids, plan, sc)
    t = time.perf_counter() - t
    bounds = FLASH_SPARSE_MAX_REL_ERR
    log("mllm", f"attention at the step's shape q {tuple(q.shape)}: ms sparse/dense "
        f"kernel fwd {ms[0]:.3f}/{ms[1]:.3f} (sparse device-only {fwd_dev:.3f}), dq "
        f"{ms[2]:.3f}/{ms[3]:.3f}, dkv "
        f"{ms[4]:.3f}/{ms[5]:.3f}; equal to the dense kernels {equal}; vs plain "
        f"(in chunks, {t:.1f} s) max abs err (relative, bound): " + ", ".join(
            (f"{key} {e:.3e} ({r:.2e}, {bounds[key]})" if e is not None
             else f"{key} {r:.2e} of the row's max |o| ({bounds[key]})")
            for key, (e, r) in errs.items()))
    bad = [key for key, (_, r) in errs.items() if r > bounds[key]]
    if bad or not all(equal.values()):
        raise SystemExit(f"mllm: the sparse kernels at the step's shape: over their "
                         f"bounds {bad}, equal to the dense kernels {equal}")
    del q, k, v, do, o, lse, delta, dq, dk, dv, plan
    # one step's loss and grad norm on the dense kernels from the same state
    # and draws as the sparse ones
    cfg_dense = dataclasses.replace(cfg, attn_max_live_kv=None)
    ms_, grads = loss_and_grads(state, batch, 7, cfg=cfg, tcfg=tcfg)
    del grads
    ms_ = {k: val.item() for k, val in ms_.items()}
    before = tuple(f.launches for f in sparse_fns + dense_fns)
    t = time.perf_counter()
    md = train_step(state, batch, 7, cfg=cfg_dense, tcfg=tcfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    md = {k: val.item() for k, val in md.items()}
    got = tuple(f.launches - b for f, b in zip(sparse_fns + dense_fns, before))
    rl = abs(md["loss"] - ms_["loss"]) / abs(ms_["loss"])
    rg = abs(md["grad_norm"] - ms_["grad_norm"]) / ms_["grad_norm"]
    log("mllm", f"dense-kernel step from the same state: {dt:.3f} s, launches {got}; "
        f"loss {md['loss']:.6f} vs sparse {ms_['loss']:.6f} (rel {rl:.2e}, bound "
        f"{MLLM_DENSE_LOSS_REL}); grad_norm {md['grad_norm']:.6f} vs {ms_['grad_norm']:.6f} "
        f"(rel {rg:.2e}, bound {MLLM_DENSE_GRAD_NORM_REL})")
    if (rl > MLLM_DENSE_LOSS_REL or rg > MLLM_DENSE_GRAD_NORM_REL
            or got != (0, 0, 0, 2 * MLLM_LAYERS, MLLM_LAYERS, MLLM_LAYERS)):
        raise SystemExit("mllm: the dense-kernel step disagrees with the sparse one")
    # the last use of the state: forward and backward only, so the AdamW
    # moments (~17 GiB) go first; "dots" keeps ~14.5 GiB more than "full"
    state.tx.opt.state.clear()
    remat = _remat_dots(state, batch, cfg, tcfg, card)
    return {"launches": launches, "s_per_step": s_step, "mfu": mfu, "peak_gib": peak,
            "remat": remat}


def _remat_dots(state, batch, cfg, tcfg, card: str) -> dict:
    """ROADMAP A4 on the 14B step: loss_and_grads (forward and backward, no
    update) from the same state and draws with remat_policy "full", then
    "dots" (the layers' weight products kept for the backward): loss equal,
    every gradient max |d| / max |ref| (expected 0), peak GiB and s of each.
    The full step's gradients wait on the host while "dots" runs, so both
    peaks hold the same state."""
    import dataclasses

    import torch

    from bitdance_tpu_torch.ops.attention import flash_fwd_sparse
    from bitdance_tpu_torch.train.mllm_train import loss_and_grads

    res, ref = {}, None
    for policy in ("full", "dots"):
        c = dataclasses.replace(cfg, remat_policy=policy)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = flash_fwd_sparse.launches
        (m, grads), dt = _timed(lambda: loss_and_grads(state, batch, 11, cfg=c,  # noqa: B023
                                                       tcfg=tcfg))
        res[policy] = {"s": dt, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                       "loss": m["loss"].item(),
                       "flash_fwd": flash_fwd_sparse.launches - before}
        if ref is None:
            ref = [g.cpu() for g in grads]
            del grads
    worst, err, equal = 0.0, 0.0, True
    for g, r in zip(grads, ref):
        r = r.cuda()
        worst = max(worst, r.abs().max().item())
        err = max(err, (g.float() - r.float()).abs().max().item())
        equal &= torch.equal(g, r)
    del grads, ref
    f, d = res["full"], res["dots"]
    log("mllm", f"remat_policy full / dots, loss_and_grads from the same state: loss "
        f"{f['loss']:.6f} / {d['loss']:.6f}; gradients bit-equal {equal}, max |d| / max |ref| "
        f"{err / worst:.2e} (bound {REMAT_GRAD_REL}); s {f['s']:.3f} / {d['s']:.3f}; peak "
        f"{f['peak_gib']:.2f} / {d['peak_gib']:.2f} GiB; sparse forward launches "
        f"{f['flash_fwd']} / {d['flash_fwd']}; card {card}")
    if f["loss"] != d["loss"] or err > REMAT_GRAD_REL * worst or d["peak_gib"] > MLLM_PEAK_GIB:
        raise SystemExit("mllm: remat_policy dots disagrees with full")
    return {**res, "grads_bit_equal": equal, "grad_rel": err / worst}


def _sharded_vs_unsharded(run):
    """run(sharded) -> (metrics per step, s per step, peak GiB, parameters,
    kernel launches of the run): the unsharded run, then the sharded one,
    the first run's parameters kept for the comparison."""
    import torch

    ref = run(False)
    got = run(True)
    diffs = {n: (got["params"][n].float() - p.float()).abs().max().item()
             for n, p in ref["params"].items()}
    bit_equal = (all(torch.equal(got["params"][n], p) for n, p in ref["params"].items())
                 and got["metrics"] == ref["metrics"])
    return ref, got, diffs, bit_equal


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _fresh_peak() -> int:
    """Free what can be freed, start a new peak and return the bytes
    allocated now (what a run's peak is measured above)."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def parallel_mllm_case(dev, layers: int) -> tuple:
    """(cfg, tcfg, batch): the 14B yaml at full width and ``layers`` of its
    40 layers, lr PARALLEL_MLLM_LR, on mllm_step_batch's packed sequence."""
    import dataclasses

    mcfg, mtcfg, _, _, batch = mllm_step_batch(dev)
    mcfg = dataclasses.replace(mcfg, llm=dataclasses.replace(
        mcfg.llm, num_hidden_layers=layers))
    return mcfg, dataclasses.replace(mtcfg, lr=PARALLEL_MLLM_LR), batch


def parallel_mllm_run(mesh, case: tuple, sharded: bool) -> dict:
    """One bf16 step of ``case`` (:func:`parallel_mllm_case`) from seed 0,
    through make_sharded_train_step on ``mesh`` (the 14B command's step)
    or the unsharded train_step: its metrics, s, kernel launches, peak GiB
    above the run's start and parameters (each process's shards)."""
    import torch

    from bitdance_tpu_torch.io.random_init import build_random_mllm_train_state
    from bitdance_tpu_torch.train import mllm_train as mt
    from bitdance_tpu_torch.utils.dtensor import local

    mcfg, mtcfg, batch = case
    base = _fresh_peak()
    state = build_random_mllm_train_state(mcfg, mtcfg, batch.position_ids.device,
                                          torch.bfloat16, seed=0)
    if sharded:
        fn, state = mt.make_sharded_train_step(mesh, state, mcfg, mtcfg)
    else:
        fn = lambda st, b, s: mt.train_step(st, b, s, cfg=mcfg, tcfg=mtcfg)  # noqa: E731
    _reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    m = fn(state, batch, 7)
    metrics = [{k: v.item() for k, v in m.items()}]
    s = time.perf_counter() - t
    return {"metrics": metrics, "s": [s], "launches": _counts(),
            "peak": (torch.cuda.max_memory_allocated() - base) / 2**30,
            "params": {n: local(p).detach() for n, p in state.model.named_parameters()}}


def phase_parallel(card: str) -> dict:
    """The data-parallel half of ROADMAP A11 on the card at world 1 (an NCCL
    group of one; one card cannot hold a world of 2): BitDance-B-1x at 256
    px, batch 16 of random ±1 tokens, PARALLEL_STEPS steps, and the 14B yaml
    at full width and PARALLEL_MLLM_LAYERS layers on one packed sequence,
    one step, each through make_sharded_train_step (FSDP2 on a (1, 1, 1)
    mesh) and the unsharded train_step from one state and seed: max |delta|
    of the losses and parameters, s/step, peak GiB both ways. Returns the
    sharded runs' kernel launches."""
    import torch

    from bitdance_tpu_torch.io.random_init import build_random_train_state
    from bitdance_tpu_torch.models.imagenet_ar import config_b
    from bitdance_tpu_torch.parallel.mesh import create_mesh
    from bitdance_tpu_torch.train import imagenet_train as it
    from bitdance_tpu_torch.utils.dtensor import local

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    mesh = create_mesh(device_type="cuda")
    log("parallel", f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} on an NCCL group "
        f"of {torch.distributed.get_world_size()} (torch {torch.__version__}); a world of "
        "2 needs a second card, so worlds 2 and 4 are held on the CPU over gloo")

    def timed_steps(state, step, batches):
        metrics, times = [], []
        for i, args in enumerate(batches):
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = step(state, *args, i)
            metrics.append({k: v.item() for k, v in m.items()})
            times.append(time.perf_counter() - t)
        return metrics, times

    # BitDance-B-1x
    cfg = config_b()
    tcfg = it.ImageNetTrainConfig(warmup_steps=0)
    g = torch.Generator(device=dev).manual_seed(3)
    batches = [(torch.sign(torch.randn((16, cfg.num_tokens, cfg.token_dim), generator=g,
                                       device=dev)),
                torch.randint(0, cfg.num_classes, (16,), generator=g, device=dev))
               for _ in range(PARALLEL_STEPS)]
    before = {}

    def run_imagenet(sharded):
        base = _fresh_peak()
        state = build_random_train_state(cfg, tcfg, dev, seed=0)
        if not before:
            before.update({n: p.detach().clone() for n, p in state.model.named_parameters()})
        if sharded:
            fn, state = it.make_sharded_train_step(mesh, state, cfg, tcfg)
            step = lambda st, t, c, i: fn(  # noqa: E731
                st, t, c, torch.Generator(device=dev).manual_seed(50 + i))
        else:
            step = lambda st, t, c, i: it.train_step(  # noqa: E731
                st, t, c, torch.Generator(device=dev).manual_seed(50 + i),
                ema_decay=tcfg.ema_decay, mixed_precision=tcfg.mixed_precision)
        _reset_counts()
        metrics, times = timed_steps(state, step, batches)
        return {"metrics": metrics, "s": times, "launches": _counts(),
                "peak": (torch.cuda.max_memory_allocated() - base) / 2**30,
                "params": {n: local(p).detach() for n, p in state.model.named_parameters()}}

    ref, got, diffs, bit_equal = _sharded_vs_unsharded(run_imagenet)
    loss_d = max(abs(a["loss"] - b["loss"]) for a, b in zip(got["metrics"], ref["metrics"]))
    gn_d = max(abs(a["grad_norm"] - b["grad_norm"])
               for a, b in zip(got["metrics"], ref["metrics"]))
    lr = tcfg.lr
    mt_ = torch.cat([(got["params"][n] - before[n]).flatten() for n in before])
    mr_ = torch.cat([(ref["params"][n] - before[n]).flatten() for n in before])
    move_d = (mt_ - mr_).abs() / lr
    first = got["metrics"][0], ref["metrics"][0]
    within = (all(abs(first[0][k] - first[1][k]) <= 1e-4 * abs(first[1][k])
                  for k in ("loss", "grad_norm"))
              and all(abs(a["loss"] - b["loss"]) <= 1e-3 * abs(b["loss"])
                      for a, b in zip(got["metrics"], ref["metrics"]))
              and (move_d < 0.1).float().mean().item() > 0.99
              and move_d.max().item() < 2 and mr_.abs().max().item() > 0.5 * lr)
    s_sh, s_ref = _median(got["s"][1:]), _median(ref["s"][1:])
    launches = {k: v for k, v in got["launches"].items() if v}
    log("parallel", f"BitDance-B-1x, 256 px, batch 16, {PARALLEL_STEPS} steps from one state "
        f"and seed: sharded vs unsharded max |d loss| {loss_d:.3e}, |d grad_norm| "
        f"{gn_d:.3e}, |d parameter| {max(diffs.values()):.3e}; bit-equal {bit_equal}; "
        f"within the CPU tolerance {within}; losses {[round(m['loss'], 5) for m in got['metrics']]}"
        f"; s/step sharded {', '.join(f'{s:.3f}' for s in got['s'])} (median after the "
        f"first {s_sh:.4f}), unsharded {', '.join(f'{s:.3f}' for s in ref['s'])} "
        f"({s_ref:.4f}); peak above each run's start {got['peak']:.2f} / {ref['peak']:.2f} "
        f"GiB; sharded launches {launches}; card {card}")
    if not within:
        raise SystemExit("parallel: the sharded B-1x step is outside the CPU tolerance "
                         "of the unsharded one")
    out = {"imagenet": {"bit_equal": bit_equal, "s_per_step": (s_sh, s_ref),
                        "peak_gib": (got["peak"], ref["peak"])}}
    del ref, got, before, mt_, mr_, move_d, batches

    # the 14B yaml at full width, PARALLEL_MLLM_LAYERS layers, one step
    case = parallel_mllm_case(dev, PARALLEL_MLLM_LAYERS)
    mcfg, batch = case[0], case[2]
    ref, got, diffs, bit_equal = _sharded_vs_unsharded(
        lambda sharded: parallel_mllm_run(mesh, case, sharded))
    c = mcfg.head_model_dim
    keyb = {n for n in diffs if n.endswith("attn.wqkv.bias")}
    worst = max(v for n, v in diffs.items() if n not in keyb)
    key_worst = max((ref["params"][n][c:2 * c].float() - got["params"][n][c:2 * c].float())
                    .abs().max().item() for n in keyb)
    m_got, m_ref = got["metrics"][0], ref["metrics"][0]
    rel = {k: abs(m_got[k] - m_ref[k]) / abs(m_ref[k]) for k in m_ref}
    others = [torch.equal(got["params"][n], p) for n, p in ref["params"].items()
              if n not in keyb]
    within = (all(r <= 2e-5 for r in rel.values())
              and (worst <= 1e-5 or all(others)) and key_worst <= 2 * PARALLEL_MLLM_LR)
    launches_m = {k: v for k, v in got["launches"].items() if v}
    log("parallel", f"BitDance-14B-64x yaml, full width, {PARALLEL_MLLM_LAYERS} of 40 "
        f"layers, one packed sequence ({batch.position_ids.shape[1]} tokens), one step "
        f"at lr {PARALLEL_MLLM_LR}: sharded vs unsharded relative d "
        + ", ".join(f"{k} {v:.2e}" for k, v in rel.items())
        + f"; max |d parameter| {worst:.3e} (key biases {key_worst:.3e}); bit-equal "
        f"{bit_equal}; within the CPU tolerance {within}; loss {m_got['loss']:.5f}; s/step "
        f"sharded {got['s'][0]:.3f}, unsharded {ref['s'][0]:.3f}; peak above each run's "
        f"start {got['peak']:.2f} / {ref['peak']:.2f} GiB; sharded launches {launches_m}; "
        f"card {card}")
    if not within:
        raise SystemExit("parallel: the sharded 14B step is outside the CPU tolerance of "
                         "the unsharded one")
    out["mllm"] = {"bit_equal": bit_equal, "s_per_step": (got["s"][0], ref["s"][0]),
                   "peak_gib": (got["peak"], ref["peak"])}
    for k, v in launches_m.items():
        launches[k] = launches.get(k, 0) + v
    del ref, got, batch, case
    gc.collect()
    torch.cuda.empty_cache()
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_sparse",
              "flash_bwd_dq_sparse", "flash_bwd_dkv_sparse"):
        if launches.get(k, 0) < 1:
            raise SystemExit(f"parallel: {k} was not launched by the sharded steps")
    log("parallel", f"phase {time.perf_counter() - t_phase:.1f} s")
    out["launches"] = launches
    return out


def _t2i_request_inputs(pipe, prompt: str, px: int):
    """The request T2IPipeline.generate builds for one image: (prompt ids,
    pads, image start ids, pos-embed, latent side, prompt bucket)."""
    import torch

    from bitdance_tpu_torch.data.special_tokens import chatml_prompts

    b = pipe.bundle
    side = px // b.vae_patch_size
    cond, uncond = (pipe.tokenizer.encode(t) for t in chatml_prompts(prompt))
    P = next(pb for pb in pipe.PROMPT_BUCKETS if pb >= len(cond))
    rows = [[0] * (P - len(ids)) + list(ids) for ids in (cond, uncond)]
    pads = torch.tensor([P - len(cond), P - len(uncond)], dtype=torch.int32, device=b.device)
    start, pe = pipe._geometry(side, side)
    return torch.tensor(rows, device=b.device), pads, start, pe, side, P


def teacher_forced(pipe, prompt: str, px: int, tokens) -> list:
    """The prefill's and every AR step's hidden states (fp32, on the card)
    of ``pipe``'s bundle fed the ±1 grid ``tokens`` [1, h*w, z] in place of
    its own samples (decode_t2i's steps otherwise)."""
    import torch

    from bitdance_tpu_torch.models import qwen3 as q3
    from bitdance_tpu_torch.pipelines.t2i import prefill_t2i

    b = pipe.bundle
    p = b.parallel_num
    rows, pads, start, pe, side, P = _t2i_request_inputs(pipe, prompt, px)
    with torch.no_grad():
        cache, hidden = prefill_t2i(b, rows, pads, start, latent_h=side, latent_w=side,
                                    num_images=1)
        out = [hidden.float()]
        pe = pe.to(hidden.dtype)
        tok = torch.as_tensor(tokens, device=b.device)
        for step in range(side * side // p):
            pe_s = pe[step * p:(step + 1) * p]
            emb = (b.projector(tok[:, step * p:(step + 1) * p]) + pe_s[None]).to(hidden.dtype)
            cache_len = P + 2 + p + step * p
            pos = (cache_len + torch.arange(p, dtype=torch.int32, device=b.device))[None] \
                - pads[:, None]
            hidden, cache = q3.qwen3_forward_cached(b.llm, torch.cat([emb, emb]), pos, cache,
                                                    cache_len, pads, causal_block=False)
            out.append(hidden.float())
    return out


def _head_sample(pipe, cond, seed: int, steps: int):
    """One AR step's head sample (the continuous latent before sign) of
    ``pipe``'s bundle from ``cond`` [2, p, D] and a generator of ``seed``."""
    import torch

    from bitdance_tpu_torch.models.diff_head import _run_fused_sample

    b = pipe.bundle
    gen = torch.Generator(device=b.device).manual_seed(seed)
    with torch.no_grad():
        return _run_fused_sample(b.head, b.stacked_head(), cond, gen, TP_CFG, steps)


def tp_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of the tp phase (spawned): joins a gloo group on card 0,
    runs :func:`_tp_rank_run` and writes its results under ``workdir``."""
    import os

    import torch
    import torch.distributed as dist

    from bitdance_tpu_torch.utils.fs import init_distributed

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    init_distributed("cuda", init_method=f"file://{workdir}/store", backend="gloo",
                     device_index=0)
    try:
        torch.save(_tp_rank_run(world), os.path.join(workdir, f"tp.{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _tp_rank_run(world: int, device: str = "cuda") -> dict:
    """The seeded bundle on ``device``, a tp 1 run (free-running tokens, the
    teacher-forced hidden states, one head sample), then the same bundle
    sharded over a (1, 1, world) mesh in place and the same three at tp
    ``world``: the request timed, then again with its all-reduces timed."""
    import dataclasses

    import numpy as np
    import torch

    from bitdance_tpu_torch.io.random_init import build_random_bundle
    from bitdance_tpu_torch.models.qwen3 import Qwen3Config
    from bitdance_tpu_torch.ops.decode_attention import decode_attention
    from bitdance_tpu_torch.ops.fused_head import fused_em_sample, head_gemm
    from bitdance_tpu_torch.parallel.mesh import create_mesh
    from bitdance_tpu_torch.pipelines.t2i import T2IPipeline

    prompt, px, seed = TP_REQUEST
    dev = torch.device(device)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(Qwen3Config.qwen3_14b(), num_hidden_layers=TP_LAYERS)
    bundle = build_random_bundle(dev, llm_cfg=cfg, seed=0)
    tok = StubTokenizer(bundle.parallel_num)
    gen = dict(height=px, width=px, num_sampling_steps=TP_STEPS, guidance_scale=TP_CFG,
               num_images=1, seed=seed, return_tokens=True)
    pipe1 = T2IPipeline(bundle, tok)
    _, tokens1 = pipe1.generate(prompt, **gen)
    hidden1 = teacher_forced(pipe1, prompt, px, tokens1)
    p = bundle.parallel_num
    pe0 = _t2i_request_inputs(pipe1, prompt, px)[3][:p].to(hidden1[0].dtype)
    cond = (hidden1[0] + pe0[None]).bfloat16()
    latents1 = [_head_sample(pipe1, cond, seed + 100, n) for n in (4, TP_STEPS)]
    built = time.perf_counter() - t0

    mesh = create_mesh(1, 1, world, device_type=dev.type)
    pipe = T2IPipeline(bundle, tok, mesh=mesh)
    del pipe1
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at = pipe.bundle.llm.model.layers[0].self_attn
    counts = (decode_attention, head_gemm, fused_em_sample)
    for fn in counts:
        fn.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img, tokens = pipe.generate(prompt, **gen)
    s_request = time.perf_counter() - t1
    launches = {fn.__name__: fn.launches for fn in counts}
    reduces = pipe.last_tp["all_reduces"]
    pipe.tp.timed = True
    t2 = time.perf_counter()
    _, again = pipe.generate(prompt, **gen)
    s_timed = time.perf_counter() - t2
    timed = dict(pipe.last_tp)
    pipe.tp.timed = False
    hidden = teacher_forced(pipe, prompt, px, tokens1)
    latents = [_head_sample(pipe, cond, seed + 100, n) for n in (4, TP_STEPS)]
    torch.cuda.synchronize()
    h_err = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(hidden, hidden1)]
    h_mean = [((a - b).abs().mean() / b.abs().mean()).item() for a, b in zip(hidden, hidden1)]
    clear = latents1[1].abs() > SIGN_MARGIN
    hs = pipe.bundle.head_stacked
    out = {
        "tokens": tokens, "again_equal": bool(np.array_equal(tokens, again)),
        "free_agreement": float(np.mean(tokens == tokens1)),
        "image_ok": bool(img.dtype == np.uint8 and img.shape == (1, px, px, 3)),
        "tokens_ok": bool(set(np.unique(tokens).tolist()) <= {-1.0, 1.0}),
        "hidden_rel": h_err, "hidden_mean_rel": h_mean,
        "finite": all(bool(torch.isfinite(h).all()) for h in hidden),
        "latent_rel": ((latents[0] - latents1[0]).abs().max()
                       / latents1[0].abs().max()).item(),
        "latent_sign": ((torch.sign(latents[1]) == torch.sign(latents1[1]))[clear])
        .float().mean().item(),
        "latent_clear": clear.float().mean().item(),
        "launches": launches, "all_reduces": reduces, "timed": timed,
        "s_request": s_request, "s_timed": s_timed, "s_build_and_tp1": built,
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "heads": (at.num_heads, at.num_kv_heads),
        "stacked": {k: tuple(hs[k].shape) for k in ("wqkv", "w1", "wo", "w2")},
        "placements": dict(hs["tp"].placements),
        "steps": len(hidden) - 1, "layers": TP_LAYERS,
        "head_blocks": pipe.bundle.head.depth_latent}
    del pipe, bundle, hs, at, hidden, hidden1, latents, latents1, cond
    gc.collect()
    torch.cuda.empty_cache()
    out["plain"] = _tp_plain_run(world, dev, cfg, tok)
    return out


def phase_tp(card: str) -> dict:
    """Tensor-parallel T2I serving (ROADMAP A11b): two spawned ranks on the
    one card over gloo (NCCL refuses two ranks on one card) at tp 2, each
    building the seeded random BitDance-14B-64x at full width and TP_LAYERS
    layers and serving one guided 256 px request, held against a tp 1 run
    of the same seed (teacher-forced hidden states, one head sample, the
    free-running grids' agreement reported); the ranks' grids must be equal
    (the pipeline checks a checksum; here the grids themselves). The same
    for the plain-MLP head (:func:`_tp_plain_run`): the ranks' grids equal,
    the head whole and its sample from one cond bit-equal to tp 1's, the
    hidden states within the bound, the free-running grids' agreement
    reported. Then #1 at the local heads and the head GEMM's four products
    at the local shapes against their plain versions. Returns the records
    and the launches."""
    import os
    import shutil

    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from bitdance_tpu_torch.ops.fused_head import head_gemm_split_plain

    t_phase = time.perf_counter()
    world = 2
    workdir = os.path.abspath("build/tp_phase")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ctx = mp.start_processes(tp_rank, args=(world, workdir), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TP_DEADLINE_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise SystemExit(f"tp: the ranks ran past {TP_DEADLINE_S} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
    ranks = [torch.load(os.path.join(workdir, f"tp.{r}.pt"), weights_only=False)
             for r in range(world)]
    shutil.rmtree(workdir, ignore_errors=True)
    r0 = ranks[0]
    layers, steps = r0["layers"], r0["steps"]
    want_da = layers * (1 + steps)
    # each AR step's TP_STEPS + 1 net calls run a rank's four products of
    # every head block on the head GEMM
    want_hg = steps * (TP_STEPS + 1) * r0["head_blocks"] * 4
    same = all(np.array_equal(r["tokens"], r0["tokens"]) for r in ranks)
    hid = max(max(r["hidden_rel"]) for r in ranks)
    ok = (same and all(r["again_equal"] and r["image_ok"] and r["tokens_ok"] and r["finite"]
                       for r in ranks)
          and hid <= TP_HIDDEN_MAX_REL_ERR
          and max(r["latent_rel"] for r in ranks) <= SAMPLER_MAX_REL_ERR
          and min(r["latent_sign"] for r in ranks) >= SAMPLER_SIGN_AGREEMENT_FLOOR
          and all(r["launches"]["decode_attention"] == want_da
                  and r["launches"]["head_gemm"] == want_hg
                  and r["launches"]["fused_em_sample"] == 0 for r in ranks))
    for r, rec in enumerate(ranks):
        log("tp", f"rank {r} of {world} (gloo on card 0), BitDance-14B-64x full width, "
            f"{layers} of 40 layers, {TP_REQUEST[1]} px, {TP_STEPS} steps, cfg {TP_CFG}: "
            f"local heads {rec['heads'][0]} q / {rec['heads'][1]} kv; head shards "
            f"{rec['stacked']} {rec['placements']}; {rec['s_request']:.3f} s/request "
            f"({rec['s_timed']:.3f} s with the all-reduces timed, a sync around each: "
            f"{rec['timed']['all_reduces']} all-reduces, {rec['timed']['all_reduce_s']:.3f} s); "
            f"all-reduces a request {rec['all_reduces']}; launches {rec['launches']} (want "
            f"decode_attention {want_da}, head_gemm {want_hg}, fused_em_sample 0); teacher-forced hidden states "
            f"against tp 1, max |d| / max |ref| "
            + ", ".join(f"{v:.3e}" for v in rec["hidden_rel"])
            + f" (bound {TP_HIDDEN_MAX_REL_ERR}), mean |d| / mean |ref| "
            + ", ".join(f"{v:.3e}" for v in rec["hidden_mean_rel"])
            + f"; one head sample from the same cond and draws: at 4 steps max |d| / max "
            f"|ref| {rec['latent_rel']:.3e} (bound {SAMPLER_MAX_REL_ERR}), at {TP_STEPS} "
            f"sign agreement {rec['latent_sign']:.4f} over the {rec['latent_clear']:.4f} of "
            f"latents clear of {SIGN_MARGIN} (floor {SAMPLER_SIGN_AGREEMENT_FLOOR}); free-running grid "
            f"agreement with tp 1 {rec['free_agreement']:.4f} (reported); peak "
            f"{rec['peak_gib']:.2f} GiB; bundle and tp 1 run {rec['s_build_and_tp1']:.1f} s; "
            f"card {card}")
    log("tp", f"ranks' grids equal {same}; two requests on each rank equal "
        f"{all(r['again_equal'] for r in ranks)}")
    if not ok:
        raise SystemExit("tp: the tensor-parallel run failed its checks")
    # the plain-MLP head: the LLM split, the head whole on each rank. The
    # free-running grid is reported, not held to tp 1's: the tp LLM's
    # hidden states differ by its rounding (held to the bound above), and
    # a flipped token is fed back (the SwiGLU request's agreement likewise)
    plain = [r["plain"] for r in ranks]
    p0 = plain[0]
    want_fab = p0["steps"] * (TP_STEPS + 1) * r0["head_blocks"]
    plain_same = all(np.array_equal(p["tokens"], p0["tokens"]) for p in plain)
    for r, p in enumerate(plain):
        log("tp", f"rank {r}: the plain-MLP head (use_swiglu false, the per-call route, "
            f"whole on each rank) with the LLM at tp {world} (local heads {p['heads'][0]} q / "
            f"{p['heads'][1]} kv), {TP_REQUEST[1]} px, {TP_STEPS} steps: {p['s_request']:.3f} "
            f"s/request; free-running grid equal to the same head's at tp 1 {p['grid_equal']} "
            f"(agreement {p['agreement']:.4f}, reported: the tp LLM's rounding); "
            f"teacher-forced hidden states max |d| / max |ref| "
            f"{p['hidden_rel']:.3e} (bound {TP_HIDDEN_MAX_REL_ERR}); a head sample from the "
            f"same cond and seed bit-equal to tp 1's {p['sample_equal']}; head parameters "
            f"whole and unchanged, no sampler stack {p['head_whole']}; launches "
            f"{p['launches']} (want decode_attention {want_da}, fused_attn_block {want_fab}, "
            f"fused_em_sample 0); card {card}")
    log("tp", f"plain-MLP head: the ranks' grids equal {plain_same}")
    if not (plain_same and all(
            p["sample_equal"] and p["head_whole"]
            and p["hidden_rel"] <= TP_HIDDEN_MAX_REL_ERR
            and p["launches"] == {"decode_attention": want_da, "fused_attn_block": want_fab,
                                  "fused_em_sample": 0} for p in plain)):
        raise SystemExit("tp: the plain-MLP head at tp 2 failed its checks")

    # the kernels at the ranks' shapes, in this process
    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X, init_head
    from bitdance_tpu_torch.parallel.tp import TPGroup, shard_head_stacked

    dev = torch.device("cuda")
    decode = _check_decode_window(64 + 2 + 64 + (TP_REQUEST[1] // 16) ** 2, 61, phase="tp",
                                  b=2, hq=r0["heads"][0], hkv=r0["heads"][1],
                                  bound=DECODE_MAX_ABS_ERR["prefill_pass2"])
    geo = BITDANCE_14B_64X["head"]
    head = init_head(dict(geo, depth_latent=2), dev, torch.bfloat16,
                     torch.Generator(device=dev).manual_seed(0))
    local = shard_head_stacked(head._stack_for_sampler(), TPGroup(0, world),
                               geo["ch_latent"] // 128)
    del head
    rows = 2 * geo["parallel_num"]
    gemm = _check_head_gemm("tp2", local, ("wqkv", "wo", "w1", "w2"), rows, dev, 62,
                            products=TP_GEMM_PRODUCTS, phase="tp")
    g = torch.Generator(device=dev).manual_seed(63)
    plain_ms = 0.0
    with torch.no_grad():
        for key, got in gemm.items():
            w = local[key][0]
            a = torch.randn((rows, w.shape[1]), generator=g, device=dev).bfloat16()
            plain_ms += cuda_time_ms(lambda a=a, w=w, sp=got["splits"]: head_gemm_split_plain(
                a, w, "out_f32", None, splits=sp), 3, warmup=1)
    del local
    gc.collect()
    torch.cuda.empty_cache()
    worst = max(gemm.values(), key=lambda g: g["rel_err"])
    # one block's four products (a rank's share): times, bound and the
    # library's summed; the errors the worst product's
    rec = {"max_abs_err": max(g["max_abs_err"] for g in gemm.values()),
           "max_rel_err": worst["rel_err"],
           **{k: sum(p[k] for p in gemm.values()) for k in ("ms", "bound_ms", "library_ms")},
           "plain_ms": plain_ms, "bound_by": worst["bound_by"], "products": gemm}
    log("tp", f"head GEMM, a rank's four products of one block at tp {world}: "
        f"{rec['ms']:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul "
        f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms; card {card}")
    log("tp", f"phase {time.perf_counter() - t_phase:.1f} s")
    return {"decode": decode, "head_gemm": rec,
            "launches": {"decode_attention": sum(r["launches"]["decode_attention"]
                                                  + r["plain"]["launches"]["decode_attention"]
                                                  for r in ranks),
                         "head_gemm_tp": sum(r["launches"]["head_gemm"] for r in ranks),
                         "fused_attn_block": sum(r["plain"]["launches"]["fused_attn_block"]
                                                 for r in ranks)}}


def _encode_case(shape, dtype, dev, seed):
    """A trunk output x (GroupNorm-ready, mean 0.3) and the tail's weights."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    c = shape[-1]
    x = (1.5 * torch.randn(shape, generator=g, device=dev) + 0.3).to(dtype)
    gw = 1 + 0.2 * torch.randn(c, generator=g, device=dev)
    gb = 0.2 * torch.randn(c, generator=g, device=dev)
    w = (torch.randn((c, 32), generator=g, device=dev) / c ** 0.5).to(dtype)
    b = 0.1 * torch.randn(32, generator=g, device=dev)
    return x, gw, gb, w, b


def phase_encode_kernel() -> dict:
    """#13 vs its plain version at the release tokenizer's trunk shapes
    (C 1024 at 1/16 of 256, 512 and 1024 px), bf16 and fp32: the raw tail
    (before the sign) within its bound, two launches bit-equal (the
    statistics' partials are summed in a fixed order), the ±1 output exact
    wherever the plain raw value clears SIGN_MARGIN; bf16 eager and
    device-only (a captured graph) ms a call at each shape (the 1024 px
    record; the others under "shapes")."""
    import torch

    from bitdance_tpu_torch.ops.fused_encode import (
        fused_encode_tail,
        fused_encode_tail_reference,
    )

    dev = torch.device("cuda")
    rec, shapes, worst = None, {}, 0.0
    for name, shape in (("256px", (8, 16, 16, 1024)), ("512px", (8, 32, 32, 1024)),
                        ("1024px", (2, 64, 64, 1024))):
        for dtype in (torch.bfloat16, torch.float32):
            args = _encode_case(shape, dtype, dev, sum(shape))
            raw = fused_encode_tail(*args, quantize=False)
            again = fused_encode_tail(*args, quantize=False)
            ref = fused_encode_tail_reference(*args, quantize=False)
            sgn = fused_encode_tail(*args)
            torch.cuda.synchronize()
            err, rel = _errors(raw, ref)
            same = torch.equal(raw, again)
            clear = ref.float().abs() > SIGN_MARGIN
            flips = int(((sgn != torch.where(ref > 0, 1.0, -1.0).to(sgn.dtype))
                         & clear).sum())
            vals = set(sgn.unique().tolist())
            bound = ENCODE_MAX_REL_ERR[dtype == torch.bfloat16]
            log("encode_kernel", f"{name} {tuple(shape)} {str(dtype)[6:]}: raw max abs err "
                f"{err:.3e} ({rel:.2e} of max, bound {bound}); 2 launches bit-equal {same}; "
                f"±1 outputs {sorted(vals)}, {flips} sign flips where |plain| > "
                f"{SIGN_MARGIN} ({clear.float().mean().item():.5f} of outputs)")
            if rel > bound or flips or not vals <= {-1.0, 1.0} or not same:
                raise SystemExit(f"encode_kernel {name} {dtype} failed its checks")
            worst = max(worst, err)
            if dtype == torch.bfloat16:
                x = args[0]
                ms = cuda_time_ms(lambda: fused_encode_tail(*args), 20)
                dms = cuda_graph_time_ms(lambda: fused_encode_tail(*args))
                pms = cuda_time_ms(lambda: fused_encode_tail_reference(*args), 5)
                n_px = x.numel() // x.shape[-1]
                bd = roofline(nbytes(x, args[3]) + n_px * 32 * x.element_size(),
                              2.0 * n_px * x.shape[-1] * 32)
                shapes[name] = {"ms": ms, "device_ms": dms, "plain_ms": pms, **bd}
                log("encode_kernel", f"{name} bf16: kernel {ms:.4f} ms eager, {dms:.4f} "
                    f"device-only, plain {pms:.4f} ms, bound {bd['bound_ms']:.4f} ms "
                    f"({bd['bound_by']}); no single PyTorch call computes the tail")
    rec = shapes.pop("1024px")
    return {"fused_encode_tail": {"max_abs_err": worst, **rec, "library_ms": None,
                                  "shapes": shapes}}


def phase_tokenizer(card: str) -> dict:
    """Path B: the release tokenizer (ch 256, mult [1,1,2,2,4], 4 res
    blocks, z 32; scripts/eval_tokenizer_recon.py) random bf16 on the card,
    ``reconstruct`` on 16 seeded 256 px images (batch 8) and 2 at 1024 px:
    exact ±1 latents through #13, shapes, images/s, encode / decode phase
    times, PSNR against the input (random weights: reported only)."""
    import numpy as np
    import torch

    from bitdance_tpu_torch.eval.recon import psnr, reconstruct
    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X as GEO
    from bitdance_tpu_torch.models.tokenizer import init_vq
    from bitdance_tpu_torch.ops.fused_encode import fused_encode_tail
    from bitdance_tpu_torch.utils.timing import PhaseTimer

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    ae = init_vq(GEO["ddconfig"], dev, torch.bfloat16, gen, encoder=True, decoder=True)
    log("tokenizer", f"release VQ tokenizer {GEO['ddconfig']} random bf16: "
        f"{sum(p.numel() for p in ae.parameters()) / 1e6:.1f} M parameters")
    rng = np.random.default_rng(12)
    out = {}
    fused_encode_tail.launches = 0
    for px, n, batch in ((256, 16, 8), (1024, 2, 8)):
        imgs = np.clip(rng.normal(size=(n, px, px, 3)) * 0.5, -1, 1).astype(np.float32)
        reconstruct(ae, imgs[:1], batch=1)              # warm-up (cuDNN plans)
        before = fused_encode_tail.launches
        timer, lat = PhaseTimer(dev), []
        torch.cuda.synchronize()
        t = time.perf_counter()
        rec = reconstruct(ae, imgs, batch=batch, timer=timer, latents_out=lat)
        dt = time.perf_counter() - t
        tot = timer.totals()
        launches = fused_encode_tail.launches - before
        h = px // 16
        shapes_ok = (rec.shape == imgs.shape and all(
            tuple(q.shape[1:]) == (h, h, 32) for q in lat) and sum(q.shape[0] for q in lat) == n)
        pm1 = all(set(q.unique().tolist()) <= {-1.0, 1.0} for q in lat)
        log("tokenizer", f"{n} x {px} px, batch {batch}: {dt:.3f} s, {n / dt:.2f} images/s; "
            f"encode {tot['encode']:.3f} s, decode {tot['decode']:.3f} s (CUDA events); "
            f"latents {tuple(lat[0].shape)} exactly ±1: {pm1}; fused_encode_tail launches "
            f"{launches}; PSNR vs input {psnr(imgs, rec):.2f} dB (random weights); card {card}")
        if not (shapes_ok and pm1 and np.isfinite(rec).all()
                and launches == -(-n // batch)):
            raise SystemExit(f"tokenizer {px} px failed its checks")
        out[px] = {"s": dt, "images_per_s": n / dt, **tot}
    # one warm-up image and ceil(n / batch) batches per size
    if fused_encode_tail.launches != 2 + 2 + 1:
        raise SystemExit(f"tokenizer: {fused_encode_tail.launches} encode-tail launches")
    out["launches"] = fused_encode_tail.launches
    return out


def _rel_l2(got, want) -> float:
    """||got - want|| / ||want||, in float64 on the CPU."""
    g, w = got.detach().double().cpu(), want.detach().double().cpu()
    return ((g - w).norm() / w.norm()).item()


def _seeded(seed: int):
    import torch

    return torch.Generator(device="cuda").manual_seed(seed)


def _cpu_copy(module):
    """An fp32 copy of ``module`` on the CPU."""
    import copy

    return copy.deepcopy(module).cpu().float()


def _timed(fn) -> tuple:
    """(fn(), its seconds on the host clock, synced before and after)."""
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def _family_gan(ae, imgs: dict, card: str) -> dict:
    """The GAN decoder's reconstructions (bf16): a seed twice bit-equal,
    two seeds different; one 256 px decode on the card in fp32 and in bf16
    against the CPU's fp32 decode of the same latents and noise. "launches":
    #13's over the reconstructions."""
    import numpy as np
    import torch

    from bitdance_tpu_torch.eval.recon import psnr, reconstruct
    from bitdance_tpu_torch.models.tokenizer import VQModel
    from bitdance_tpu_torch.ops.fused_encode import fused_encode_tail

    out = {}
    fused_encode_tail.launches = 0
    for px, n, batch in FAMILY_IMAGES:
        reconstruct(ae, imgs[px][:1], batch=1, generator=_seeded(0))   # cuDNN plans
        rec, dt = _timed(lambda: reconstruct(ae, imgs[px], batch=batch,  # noqa: B023
                                             generator=_seeded(5)))
        again = reconstruct(ae, imgs[px], batch=batch, generator=_seeded(5))
        other = reconstruct(ae, imgs[px], batch=batch, generator=_seeded(6))
        same, differs = np.array_equal(rec, again), not np.array_equal(rec, other)
        out[px] = {"s_per_image": dt / n, "psnr": psnr(imgs[px], rec)}
        log("tokenizer_family", f"GAN decoder bf16, {n} x {px} px (batch {batch}): "
            f"{dt / n:.4f} s/image; one seed twice bit-equal {same}, another seed "
            f"differs {differs}; PSNR vs input {out[px]['psnr']:.2f} dB (random "
            f"weights); card {card}")
        if not (same and differs and rec.shape == imgs[px].shape and np.isfinite(rec).all()):
            raise SystemExit(f"tokenizer_family: the GAN reconstruction at {px} px failed")
    out["launches"] = fused_encode_tail.launches
    x = torch.from_numpy(imgs[256][:1]).cuda()
    cpu_ae = VQModel(ae.ddconfig, gan_decoder=True)
    cpu_ae.decoder.load_state_dict(ae.decoder.state_dict())
    with torch.no_grad():
        q = ae.encode(x)
        noise = torch.randn(tuple(q.shape), generator=_seeded(7), device="cuda")
        bf16 = ae.decode(q, noise=noise)
        ae.decoder.float()
        card32 = ae.decode(q.float(), noise=noise)
        ae.decoder.to(torch.bfloat16)
        t = time.perf_counter()
        cpu32 = cpu_ae.decode(q.float().cpu(), noise=noise.cpu())
        cpu_s = time.perf_counter() - t
    r32, r16 = _rel_l2(card32, cpu32), _rel_l2(bf16, cpu32)
    log("tokenizer_family", f"GAN decode at 256 px against the CPU fp32 decode of the same "
        f"latents and noise ({cpu_s:.1f} s on the CPU): card fp32 relative L2 {r32:.3e} "
        f"(bound {CARD_FP32_REL_L2}), card bf16 {r16:.3e} (bound {CARD_BF16_REL_L2}); "
        f"max |d| fp32 {(card32.cpu() - cpu32).abs().max().item():.3e}")
    if not (r32 <= CARD_FP32_REL_L2 and r16 <= CARD_BF16_REL_L2):
        raise SystemExit("tokenizer_family: the GAN decode disagrees with the CPU's")
    out["card_vs_cpu"] = {"fp32_rel_l2": r32, "bf16_rel_l2": r16}
    return out


def _family_int8(vq, card: str) -> dict:
    """The W8A8 decoder (conv_int8) against the bf16 decoder of the same
    latents at 256 and 1024 px, s/image of each, and one trunk conv's
    integer sums on the card against the CPU's float64 twin."""
    import torch

    from bitdance_tpu_torch.models.tokenizer import (
        VQModel,
        conv_int8_acc,
        quantize_conv_input,
        quantize_conv_weight,
    )

    with torch.device("meta"):
        q8 = VQModel(vq.ddconfig, dtype=torch.bfloat16, conv_int8=True)
    q8 = q8.to_empty(device="cuda").eval()
    q8.decoder.load_state_dict(vq.decoder.state_dict())
    z_ch = vq.ddconfig["z_channels"]
    out, seen = {}, {}
    conv = q8.decoder.mid_block[0].conv1
    hook = conv.register_forward_pre_hook(lambda m, a: seen.__setitem__("x", a[0]))
    for px, n, _ in FAMILY_IMAGES:
        h = px // 16
        z = torch.where(torch.randn((n, h, h, z_ch), generator=_seeded(px), device="cuda") > 0,
                        1.0, -1.0).bfloat16()
        with torch.no_grad():
            vq.decode(z[:1])
            q8.decode(z[:1])
            y16, s16 = _timed(lambda: vq.decode(z))           # noqa: B023
            y8, s8 = _timed(lambda: q8.decode(z))             # noqa: B023
        rel = _rel_l2(y8, y16)
        out[px] = {"rel_l2": rel, "int8_s_per_image": s8 / n, "bf16_s_per_image": s16 / n}
        log("tokenizer_family", f"W8A8 decoder at {px} px ({n} image(s)): relative L2 against "
            f"the bf16 decode {rel:.4f} (bound {CONV_INT8_REL_L2}); s/image int8 "
            f"{s8 / n:.4f}, bf16 {s16 / n:.4f}; card {card}")
        if not rel < CONV_INT8_REL_L2:
            raise SystemExit(f"tokenizer_family: the W8A8 decoder at {px} px is over its bound")
    hook.remove()
    # the mid block's first conv at 1024 px (64 x 64 x 1024, K 9216)
    with torch.no_grad():
        xq, _ = quantize_conv_input(seen["x"].permute(0, 2, 3, 1))
        wq, _ = quantize_conv_weight(conv.weight)
        acc = conv_int8_acc(xq, wq, 3)
        t = time.perf_counter()
        twin = conv_int8_acc(xq.cpu(), wq.cpu(), 3)
        cpu_s = time.perf_counter() - t
    big = acc.abs().max().item()
    equal = torch.equal(acc.cpu(), twin)
    log("tokenizer_family", f"W8A8 conv (mid block conv1 at 1024 px, M {acc[..., 0].numel()}, "
        f"K {wq.shape[1]}, N {wq.shape[0]}): int32 sums on the card (torch._int_mm) equal the "
        f"CPU float64 twin's ({cpu_s:.1f} s): {equal}; max |sum| {big:.0f} (< 2^24, so exact "
        f"in fp32: {big < 2 ** 24})")
    if not (equal and big < 2 ** 24):
        raise SystemExit("tokenizer_family: the W8A8 conv's sums differ from the twin's")
    del q8
    return out


def _family_uni(dd: dict, imgs: dict, card: str) -> dict:
    """UniWeTok (bf16) reconstructions, encode_raw's range, s/image and peak
    GiB; one 256 px encode on the card in fp32 against the CPU's fp32
    encode: signs equal wherever |raw| > SIGN_MARGIN."""
    import numpy as np
    import torch

    from bitdance_tpu_torch.eval.recon import reconstruct
    from bitdance_tpu_torch.models.tokenizer_uni import init_uni_vq

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    uni = init_uni_vq(dd, "cuda", torch.bfloat16, _seeded(23))
    n_par = sum(p.numel() for p in uni.parameters())
    out = {}
    for px, n, batch in FAMILY_IMAGES:
        reconstruct(uni, imgs[px][:1], batch=1, generator=_seeded(0))
        rec, dt = _timed(lambda: reconstruct(uni, imgs[px], batch=batch,  # noqa: B023
                                             generator=_seeded(5)))
        with torch.no_grad():
            raw = uni.encode_raw(torch.from_numpy(imgs[px][:batch]).cuda())
        lo, hi = raw.min().item(), raw.max().item()
        out[px] = {"s_per_image": dt / n}
        tokens = (px // 16) ** 2 + 4
        log("tokenizer_family", f"UniWeTok bf16 {n} x {px} px (batch {batch}; mid-attention "
            f"{tokens} tokens of width {dd['ch'] * dd['ch_mult'][-1]}): {dt / n:.4f} s/image; "
            f"encode_raw in [{lo:.4f}, {hi:.4f}]; card {card}")
        if not (-1.0 <= lo and hi <= 1.0 and np.isfinite(rec).all()
                and rec.shape == imgs[px].shape):
            raise SystemExit(f"tokenizer_family: UniWeTok at {px} px failed its checks")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    out["peak_gib"] = peak
    with torch.no_grad():
        enc = uni.encoder.float()
        x = torch.from_numpy(imgs[256][:1]).cuda()
        raw_card = uni.encode_raw(x)
        cpu_enc = _cpu_copy(enc)
        uni.encoder.to(torch.bfloat16)
        t = time.perf_counter()
        want = cpu_enc(x.cpu().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        cpu_s = time.perf_counter() - t
    clear = want.abs() > SIGN_MARGIN
    flips = int((((raw_card.cpu() > 0) != (want > 0)) & clear).sum())
    rel = _rel_l2(raw_card, want)
    log("tokenizer_family", f"UniWeTok {n_par / 1e6:.1f} M parameters (release geometry, "
        f"{UNI_EXTRA}: UniVQModel's defaults, no published UniWeTok ddconfig in the "
        f"repository), peak {peak:.2f} GiB above the phase's start; 256 px card fp32 encode "
        f"against the CPU fp32 encode ({cpu_s:.1f} s): relative L2 {rel:.3e}, {flips} sign "
        f"flips where |raw| > {SIGN_MARGIN} ({clear.float().mean().item():.5f} of the values)")
    if flips or rel > CARD_FP32_REL_L2:
        raise SystemExit("tokenizer_family: UniWeTok's card encode disagrees with the CPU's")
    out["card_vs_cpu_rel_l2"] = rel
    del uni, enc, cpu_enc
    return out


def _family_batched(ae, card: str) -> dict:
    """BatchedEncoder on 2 x 256^2, 512 x 384 and 1024 x 640 (a "long"
    image): vt_forward's tokens equal the encodes of its batches bit for bit
    (each image alone in its group against its own encode; the 256^2 pair
    against the pair's encode, and against each image's own encode:
    reported), and vt_forward_maxpad's shapes and crops. Every encode takes
    its images as vt_forward stacks them (the convolutions' algorithm may
    follow the input's strides). Returns #13's launches of the two calls."""
    import numpy as np
    import torch

    from bitdance_tpu_torch.models.tokenizer import latents_to_tokens
    from bitdance_tpu_torch.models.vt_encode import BatchedEncoder, bucket_of
    from bitdance_tpu_torch.ops.fused_encode import fused_encode_tail

    rng = np.random.default_rng(24)
    shapes = ((256, 256), (256, 256), (512, 384), (1024, 640))
    ims = [np.clip(rng.normal(size=(h, w, 3)) * 0.5, -1, 1).astype(np.float32)
           for h, w in shapes]
    ps = 8
    enc = BatchedEncoder(ae, ps=ps)
    fused_encode_tail.launches = 0
    packed = enc.vt_forward(ims)
    vt_launches = fused_encode_tail.launches
    fused_encode_tail.launches = 0
    padded = enc.vt_forward_maxpad(ims)
    pad_launches = fused_encode_tail.launches
    # the comparisons' own encodes
    with torch.no_grad():
        encode = lambda *xs: ae.encode(torch.from_numpy(np.stack(xs)).cuda())  # noqa: E731
        pair = encode(ims[0], ims[1])
        batches = [pair[0:1], pair[1:2], encode(ims[2]), encode(ims[3])]
        singles = [encode(im) for im in ims[:2]]
    want = [latents_to_tokens(q, ps)[0] for q in batches]
    start, exact = 0, []
    for t in want:
        exact.append(torch.equal(packed[start:start + t.shape[0]], t))
        start += t.shape[0]
    own = [int((latents_to_tokens(s, ps)[0] != t).sum()) for s, t in zip(singles, want)]
    crops_ok, start = True, 0
    for im, q in zip(ims, batches):
        hl, wl = -(-im.shape[0] // 32), -(-im.shape[1] // 32)
        crops_ok &= torch.equal(padded[start:start + hl * wl], q[0, :hl, :wl].reshape(hl * wl, -1))
        start += hl * wl
    n_tokens = sum(-(-h // 32) * -(-w // 32) for h, w in shapes)
    buckets = [bucket_of(h, w) for h, w in shapes]
    log("tokenizer_family", f"BatchedEncoder (ps {ps}) on {shapes}, buckets {buckets}: "
        f"vt_forward {tuple(packed.shape)}, equal to its batches' encodes bit for bit {exact} "
        f"(the 256^2 pair against each image encoded alone: {own} of "
        f"{want[0].numel()} values differ); vt_forward_maxpad {tuple(padded.shape)} (want "
        f"{n_tokens} tokens), crops equal to the encodes' top-left latents {crops_ok}; #13 "
        f"launches {vt_launches} + {pad_launches}; card {card}")
    if not (all(exact) and crops_ok and start == padded.shape[0] == n_tokens
            and packed.shape[0] == sum(t.shape[0] for t in want)
            and buckets[-1] == "long" and vt_launches == 3 and pad_launches == 3):
        raise SystemExit("tokenizer_family: BatchedEncoder failed its checks")
    return {"launches": vt_launches + pad_launches, "pair_vs_alone_differ": own}


def _family_cli(vq, dd_uni: dict, card: str) -> dict:
    """cli.recon on 8 seeded 256 px PNGs with random release weights in
    ae.safetensors, once plain and once --uni (its model_ema.* keys are the
    weights the command must load): its PSNR / SSIM equal the in-process
    reconstruct of the same images and seed."""
    import contextlib
    import io
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from bitdance_tpu_torch.cli import recon as cli_recon
    from bitdance_tpu_torch.cli.t2i import write_png
    from bitdance_tpu_torch.eval.recon import (
        compare_reconstructions,
        load_image_folder,
        reconstruct,
    )
    from bitdance_tpu_torch.io.safetensors import save_file
    from bitdance_tpu_torch.models.tokenizer_uni import init_uni_vq

    root = Path(__file__).resolve().parent / "build" / "recon_cli"
    shutil.rmtree(root, ignore_errors=True)
    (root / "images").mkdir(parents=True)
    rng = np.random.default_rng(25)
    for i in range(8):
        write_png(root / "images" / f"{i:03d}.png", rng.integers(0, 256, (256, 256, 3), np.uint8))
    (root / "ae_config.json").write_text(json.dumps({"ddconfig": dd_uni}))
    save_file(vq.state_dict(), root / "ae.safetensors")
    uni = init_uni_vq(dd_uni, "cuda", torch.bfloat16, _seeded(26))
    state = {k: v * 0.5 for k, v in uni.state_dict().items()}
    state.update({"model_ema." + k.replace(".", ""): v for k, v in uni.state_dict().items()})
    save_file(state, root / "uni.safetensors")
    del state
    out = {}
    try:
        for name, extra in (("plain", []), ("uni", ["--uni"])):
            path = str(root / ("uni.safetensors" if extra else "ae.safetensors"))
            argv = ["--images", str(root / "images"), "--ae", path, "--limit", "0",
                    "--seed", "3", "--ae-config", str(root / "ae_config.json")] + extra
            buf = io.StringIO()
            t = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_recon.main(argv)
            cli_s = time.perf_counter() - t
            said = json.loads(buf.getvalue().strip().splitlines()[-1])
            model = cli_recon.load_tokenizer(path, dd_uni if extra else vq.ddconfig,
                                             bool(extra), torch.device("cuda"))
            images = load_image_folder(str(root / "images"), 256)
            rec = reconstruct(model, images, batch=8, generator=_seeded(3))
            want = {"n_images": 8, "resolution": 256,
                    **compare_reconstructions(images, rec).as_dict()}
            ema = (not extra) or torch.equal(model.encoder.conv_in.weight,
                                             uni.encoder.conv_in.weight.float())
            out[name] = {"s": cli_s, **said}
            log("tokenizer_family", f"cli.recon {name}: {cli_s:.1f} s, {said}; equal to the "
                f"in-process reconstruct {said == want}; EMA weights loaded {ema}; card {card}")
            if rc != 0 or said != want or not ema:
                raise SystemExit(f"tokenizer_family: cli.recon {name} failed its checks")
            del model
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_tokenizer_family(card: str) -> dict:
    """The tokenizer family (ROADMAP A5 / A9) at the release tokenizer's
    geometry: the GAN decoder (bf16, 8 x 256 and 1 x 1024 px, seeds, the
    card against the CPU), the W8A8 decoder against bf16 and one conv's
    integer sums against a float64 twin, UniWeTok (reconstructions, peak,
    the card's encode against the CPU's), BatchedEncoder and cli.recon
    (plain and --uni). Returns #13's launches of the phase's encode paths."""
    import numpy as np
    import torch

    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X as GEO
    from bitdance_tpu_torch.models.tokenizer import init_vq
    from bitdance_tpu_torch.ops.fused_encode import fused_encode_tail

    t_phase = time.perf_counter()
    dd = GEO["ddconfig"]
    dd_uni = dict(dd, **UNI_EXTRA)
    rng = np.random.default_rng(21)
    imgs = {px: np.clip(rng.normal(size=(n, px, px, 3)) * 0.5, -1, 1).astype(np.float32)
            for px, n, _ in FAMILY_IMAGES}
    ae = init_vq(dd, "cuda", torch.bfloat16, _seeded(22), encoder=True, gan_decoder=True)
    out = {"gan": _family_gan(ae, imgs, card)}
    launches = out["gan"]["launches"] + _family_batched(ae, card)["launches"]
    del ae
    vq = init_vq(dd, "cuda", torch.bfloat16, _seeded(27), encoder=True)
    out["int8"] = _family_int8(vq, card)
    fused_encode_tail.launches = 0
    out["cli"] = _family_cli(vq, dd_uni, card)
    launches += fused_encode_tail.launches
    del vq
    out["uni"] = _family_uni(dd_uni, imgs, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = launches
    log("tokenizer_family", f"#13 launches on the phase's encode paths {launches}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    return out


def phase_head_leftovers(card: str) -> dict:
    """ROADMAP A2 / A3 on the card: the T2I head at the 14B width with
    plain-MLP blocks (use_swiglu=False) through DiffHead.sample, which
    takes the per-call route (#15 for each block's attention half), against
    the plain route, one net call and a
    guided AR step's sample, the SwiGLU head beside it as the yardstick;
    the three alt heads and SwiGLUConnector at hidden 5120 in bf16 against
    the CPU's fp32 on the same weights. Returns the plain-MLP head's #15
    launches (the SwiGLU head's are a yardstick's)."""
    import torch

    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X as GEO
    from bitdance_tpu_torch.io.random_init import draw_head_, init_head
    from bitdance_tpu_torch.models.alt_heads import (
        GaussianRegressionVisionHead,
        RegressionVisionHead,
        StandardVisionHead,
    )
    from bitdance_tpu_torch.models.connector import SwiGLUConnector
    from bitdance_tpu_torch.ops.fused_block import fused_attn_block

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    cond = torch.randn((2, GEO["head"]["parallel_num"], GEO["head"]["ch_cond"]),
                       generator=_seeded(32), device=dev).bfloat16()
    out = {}
    for swiglu in (False, True):
        kw = dict(GEO["head"], use_swiglu=swiglu)
        head = init_head(kw, dev, torch.bfloat16, _seeded(31))
        c, p, blocks = kw["ch_latent"], kw["parallel_num"], kw["depth_latent"]
        calls = []
        hook = head.net.register_forward_hook(lambda *a: calls.append(1))  # noqa: B023
        fused_attn_block.launches = 0
        # the plain-MLP head through DiffHead.sample, the entry point the
        # pipelines call, which routes it to the per-call sampler; the
        # SwiGLU yardstick straight to that route (its guided default is the
        # whole sampler)
        if head.stackable != swiglu:
            raise SystemExit("head_leftovers: DiffHead.stackable disagrees with use_swiglu")
        sample = head.sample_per_call if swiglu else head.sample
        got4 = sample(cond, _seeded(33), 7.5, 4, 2)
        got50 = sample(cond, _seeded(33), 7.5, 50, 2)
        launches, net_calls = fused_attn_block.launches, len(calls)
        hook.remove()
        x = torch.randn((2, p, kw["ch_target"]), generator=_seeded(34), device=dev).bfloat16()
        t = torch.full((2,), 0.5, device=dev)
        with torch.no_grad():
            net = head.net(x, t, cond)
            with _plain_head():
                want4 = sample(cond, _seeded(33), 7.5, 4, 2)
                want50 = sample(cond, _seeded(33), 7.5, 50, 2)
                net_ref = head.net(x, t, cond)
        _, net_rel = _errors(net, net_ref)
        err, rel = _errors(got4, want4)
        agree = ((got50 > 0) == (want50 > 0)).float().mean().item()
        name = "SwiGLU" if swiglu else "plain-MLP"
        log("head_leftovers", f"T2I head C {c}, {blocks} {name} blocks, the per-call route "
            f"against the plain route: one net call {net_rel:.2e} of max (bound "
            f"{HEAD_BLOCK_MAX_REL_ERR}); a guided AR step's sample ({p} tokens, cfg 7.5) at 4 "
            f"steps max abs err {err:.3e} ({rel:.2e} of max, bound {PLAIN_HEAD_MAX_REL_ERR}), "
            f"signs after 50 steps equal {agree:.4f} (floor {PLAIN_HEAD_SIGN_FLOOR}); #15 "
            f"launches {launches} over {net_calls} net calls; card {card}")
        if not (net_rel <= HEAD_BLOCK_MAX_REL_ERR and rel <= PLAIN_HEAD_MAX_REL_ERR
                and agree >= PLAIN_HEAD_SIGN_FLOOR and launches == blocks * net_calls
                and net_calls == (4 + 1) + (50 + 1)):
            raise SystemExit(f"head_leftovers: the {name} head failed its checks")
        out[name] = {"launches": launches, "net_rel": net_rel, "rel": rel,
                     "sign_agreement": agree}
        del head
    # the alt heads and the connector, bf16 on the card vs fp32 on the CPU
    h = torch.randn((128, 5120), generator=_seeded(34), device=dev).bfloat16()
    labels = torch.randint(0, 4096, (128,), generator=_seeded(35), device=dev)
    lat = torch.where(torch.randn((128, 32), generator=_seeded(36), device=dev) > 0, 1.0, -1.0)
    eps = torch.randn((128, 32), generator=_seeded(37), device=dev)
    mods = {"standard": StandardVisionHead(4096, 5120, device=dev, dtype=torch.bfloat16),
            "regression": RegressionVisionHead(5120, 32, 5120, device=dev, dtype=torch.bfloat16),
            "gaussian": GaussianRegressionVisionHead(5120, 32, 5120, device=dev,
                                                     dtype=torch.bfloat16),
            "swiglu_connector": SwiGLUConnector(32, 5120, device=dev, dtype=torch.bfloat16)}
    calls = {"standard": lambda m, a: (*m(a["h"], a["labels"]), m.loss(a["h"], a["labels"])),
             "regression": lambda m, a: (m(a["h"]), m.loss(a["h"], a["lat"])),
             "gaussian": lambda m, a: (m(a["h"], a["eps"]), m.loss(a["h"], a["lat"], a["eps"])),
             "swiglu_connector": lambda m, a: (m(a["lat"]),)}
    args = {"h": h, "labels": labels, "lat": lat, "eps": eps}
    cpu_args = {k: (v.float() if v.is_floating_point() else v).cpu() for k, v in args.items()}
    worst = {}
    with torch.no_grad():
        for name, m in mods.items():
            draw_head_(m, _seeded(38))
            got = calls[name](m.eval(), args)
            want = calls[name](_cpu_copy(m).eval(), cpu_args)
            worst[name] = max(_errors(g.cpu(), w)[1] for g, w in zip(got, want))
    log("head_leftovers", "alt heads and SwiGLUConnector at hidden 5120 (128 rows; the "
        "standard head over 4,096 codes), bf16 on the card against fp32 on the CPU, max "
        "|d| / max |ref| of each output: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (bound {ALT_HEAD_MAX_REL_ERR}); phase {time.perf_counter() - t_phase:.1f} s")
    if max(worst.values()) > ALT_HEAD_MAX_REL_ERR:
        raise SystemExit("head_leftovers: an alt head or the connector disagrees with the CPU")
    return {"launches": out["plain-MLP"]["launches"], **out, "alt": worst}


# ---------------------------------------------------------------------------
# The training entry points: the tar index, cli.train_imagenet with resume,
# cli.sample_fid, tokenizer training and cli.train_mllm with resume
# ---------------------------------------------------------------------------

TRAIN_CLI_DIR = "build/train_cli"   # gitignored; emptied before and after
TRAIN_CLI_TAR = (8, 8, ((400, 320), (375, 500)))   # classes, images each, (H, W)s
TRAIN_CLI_IMAGENET = ["--model", "BitDance-B", "--image-size", "256",
                      "--global-batch-size", "16", "--epochs", "2", "--warmup-steps", "0",
                      "--log-every", "1", "--global-seed", "5", "--device", "cuda"]
TRAIN_CLI_STEPS = 4          # straight; the resumed run takes 2, then 2 more
# (50 sampling steps: 100 until PR 23, cut for the script's time)
TRAIN_CLI_FID_STEPS = 50
TRAIN_CLI_FID = ["--model", "BitDance-B", "--image-size", "256",
                 "--per-proc-batch-size", "16", "--num-fid-samples", "32",
                 "--cfg-scale", "4.6", "--sample-steps", str(TRAIN_CLI_FID_STEPS),
                 "--seed", "99", "--device", "cuda"]
TOKENIZER_TRAIN = dict(batch=4, px=256, steps=3)
# the 14B trainer's cut of train/configs/bitdance_14b_64x.yaml: at Qwen3-14B
# width the embedding, lm_head and head hold over 2.5 B parameters, ~40 GB a
# checkpoint; with the LLM alone cut, the 5120-wide head still makes it 12.5
# GB. The check writes three, and the card's machine accepts 45 GiB of disk
# writes in one call (the whole script's), so the head is cut to 1024 wide
# (its 6 blocks kept): 2.46 GB a checkpoint. The `mllm` phase holds the
# full-width step.
MLLM_CLI_LLM = dict(hidden_size=1024, intermediate_size=3072, num_hidden_layers=2,
                    num_attention_heads=8, num_key_value_heads=8, head_dim=128)
MLLM_CLI_HEAD = dict(model_dim=1024)
MLLM_CLI_TRAINING = dict(num_replicate=1, num_shard=1, warmup_steps=0, lr=1e-3,
                         save_every=4, validate_every=2, log_every=1)


def _synthetic_imagenet_tar(path: str) -> int:
    """The official train tar's layout: an outer tar of <wnid>.tar members,
    each holding <wnid>_<i>.JPEG at mixed sizes (random pixels)."""
    import io
    import tarfile

    import numpy as np
    from PIL import Image

    classes, per_class, sizes = TRAIN_CLI_TAR
    rng = np.random.default_rng(7)
    with tarfile.open(path, "w") as outer:
        for c in range(classes):
            wnid = f"n{1440764 + c:08d}"
            buf = io.BytesIO()
            with tarfile.open(fileobj=buf, mode="w") as inner:
                for i in range(per_class):
                    h, w = sizes[(c + i) % len(sizes)]
                    img = io.BytesIO()
                    Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                        img, "JPEG", quality=90)
                    info = tarfile.TarInfo(f"{wnid}_{i}.JPEG")
                    info.size = img.tell()
                    img.seek(0)
                    inner.addfile(info, img)
            info = tarfile.TarInfo(f"{wnid}.tar")
            info.size = buf.tell()
            buf.seek(0)
            outer.addfile(info, buf)
    return classes * per_class


def _dir_gb(path: str) -> float:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, files in os.walk(path)
               for f in files) / 1e9


def _same_checkpoint(a: str, b: str, step: int) -> tuple[int, list]:
    """(tensors compared, names that differ) of two step directories, the
    meta and data status files compared as text (a difference raises)."""
    import os

    import torch

    from bitdance_tpu_torch.io.safetensors import load_file

    da, db = os.path.join(a, str(step)), os.path.join(b, str(step))
    for name in ("meta.json", "data_status.json"):
        with open(os.path.join(da, name)) as fa, open(os.path.join(db, name)) as fb:
            ta, tb = fa.read(), fb.read()
        if ta != tb:
            raise SystemExit(f"train_cli: {name} of step {step} differs: {ta} vs {tb}")
    sa = load_file(os.path.join(da, "state.safetensors"))
    sb = load_file(os.path.join(db, "state.safetensors"))
    if set(sa) != set(sb):
        raise SystemExit(f"train_cli: step {step}'s tensors differ in name")
    dev = torch.device("cuda")
    diff = [k for k in sorted(sa) if sa[k].dtype != sb[k].dtype
            or not torch.equal(sa[k].to(dev), sb[k].to(dev))]
    return len(sa), diff


def _trained(a: str, b: str, step: int, half: int, ema: bool) -> str:
    """That a command trained, which a resumed run equal to its straight run
    does not show by itself (a step that leaves the state as it was passes
    that check too): every AdamW step count of ``a``'s step directory is
    ``step``, its master parameters moved from ``b``'s step-``half`` ones
    and, with ``ema``, so did the EMA, which also differs from the masters.
    Returns the counts for the log; a failure raises."""
    import os

    import torch

    from bitdance_tpu_torch.io.safetensors import load_file

    last = load_file(os.path.join(a, str(step), "state.safetensors"))
    mid = load_file(os.path.join(b, str(half), "state.safetensors"))
    counts = [float(v) for k, v in last.items() if k.startswith("opt/") and k.endswith("/step")]
    masters = [k for k in last if k.startswith("model/") and last[k].is_floating_point()]
    moved = [k for k in masters if not torch.equal(last[k], mid[k])]
    got = (f"{len(moved)} of {len(masters)} master tensors moved from step {half} to "
           f"{step}, AdamW step counts {sorted(set(counts))}")
    bad = not counts or set(counts) != {float(step)} or not moved
    if ema:
        keys = [k for k in last if k.startswith("ema/")]
        ema_moved = [k for k in keys if not torch.equal(last[k], mid[k])]
        apart = [k for k in keys if not torch.equal(last[k], last["model/" + k[4:]])]
        got += (f", {len(ema_moved)} of {len(keys)} EMA tensors moved, "
                f"{len(apart)} apart from the masters")
        bad = bad or not ema_moved or not apart
    if bad:
        raise SystemExit(f"train_cli: the command did not train: {got}")
    return got


def _cli_run(phase: str, main, argv: list, what: str, stats: dict | None = None) -> dict:
    """One command run in this process through its main(argv): the kernel
    launch counts set to 0 before it and read after, its wall seconds and
    its peak device memory above what was allocated before it."""
    import torch

    base = _fresh_peak()
    _reset_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    kw = {} if stats is None else {"stats": stats}
    rc = main(argv, **kw)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    counts = {k: v for k, v in _counts().items() if v}
    log(phase, f"{what}: rc {rc}, {dt:.2f} s, peak {peak:.2f} GiB above its start "
        f"({base / 2**30:.2f} allocated before), kernel launches {counts}")
    if rc != 0:
        raise SystemExit(f"{phase}: {what} returned {rc}")
    gc.collect()
    torch.cuda.empty_cache()
    return {"s": dt, "peak_gib": peak, "launches": counts}


def _train_imagenet_resume(tar: str, root: str, card: str) -> dict:
    """BitDance-B-1x (dim 768, 24 layers, MlpEncoder head) at 256 px,
    global batch 16 through cli.train_imagenet: TRAIN_CLI_STEPS steps
    straight, then TRAIN_CLI_STEPS // 2 and the rest resumed in a second
    results directory; the final checkpoints bit for bit."""
    import os

    import numpy as np

    from bitdance_tpu_torch.cli import train_imagenet

    base = ["--data-path", tar] + TRAIN_CLI_IMAGENET
    a, b = os.path.join(root, "straight"), os.path.join(root, "resumed")
    st_a, st_b1, st_b2 = {}, {}, {}
    half = str(TRAIN_CLI_STEPS // 2)
    runs = [_cli_run("train_cli", train_imagenet.main,
                     base + ["--results-dir", a, "--max-steps", str(TRAIN_CLI_STEPS)],
                     f"train_imagenet BitDance-B-1x, {TRAIN_CLI_STEPS} steps straight",
                     st_a),
            _cli_run("train_cli", train_imagenet.main,
                     base + ["--results-dir", b, "--max-steps", half],
                     f"train_imagenet, {half} steps", st_b1),
            _cli_run("train_cli", train_imagenet.main,
                     base + ["--results-dir", b, "--max-steps", str(TRAIN_CLI_STEPS)],
                     "train_imagenet resumed to the same step", st_b2)]
    n, diff = _same_checkpoint(os.path.join(a, "checkpoints"), os.path.join(b, "checkpoints"),
                               TRAIN_CLI_STEPS)
    trained = _trained(os.path.join(a, "checkpoints"), os.path.join(b, "checkpoints"),
                       TRAIN_CLI_STEPS, TRAIN_CLI_STEPS // 2, ema=True)
    # the command trains through its FSDP step, so the run resumed from a
    # sharded checkpoint (world 1: one rank's file and its places)
    mid = os.path.join(b, "checkpoints", half)
    with open(os.path.join(mid, "meta.json")) as f:
        world = json.load(f).get("world")
    sharded = world == 1 and os.path.exists(os.path.join(mid, "shards.rank00000.json"))
    log("train_cli", f"the resumed run restored a sharded checkpoint (world {world}, "
        f"{sorted(os.listdir(mid))}): {sharded}")
    if not sharded:
        raise SystemExit("train_cli: the B-1x run's checkpoint is not the sharded format")
    steps = st_a["step_seconds"]
    steady = sorted(steps[1:])
    s_step = steady[len(steady) // 2]
    ph = st_a["phase_seconds"]
    fmt = lambda xs, d=3: ", ".join(f"{x:.{d}f}" for x in xs)  # noqa: E731
    saves = st_a["save_seconds"] + st_b1["save_seconds"] + st_b2["save_seconds"]
    log("train_cli", f"B-1x through the CLI: s/step {fmt(steps)} (median after the "
        f"first {s_step:.3f}; data {fmt(st_a['data_seconds'])} s of it on the host; "
        f"encode {ph['encode']:.3f} s and train_step {ph['train_step']:.3f} s over the "
        f"{len(steps)} steps, {ph['clock']}), saves {fmt(saves, 2)} s, "
        f"checkpoint {st_a['ckpt_bytes'][-1] / 1e9:.3f} GB, restore "
        f"{st_b2['restore_seconds']:.2f} s; resumed == straight: {n - len(diff)} of {n} "
        f"tensors bit-equal, differing {diff[:6]}; {trained}; card {card}")
    if diff:
        raise SystemExit(f"train_cli: the resumed B-1x run differs from the straight "
                         f"one in {len(diff)} tensors: {diff[:8]}")
    if not all(np.isfinite(steps)) or st_a["save_seconds"] == []:
        raise SystemExit("train_cli: the straight run recorded no steps or saves")
    return {"straight": a, "resumed": b, "s_per_step": s_step, "stats": st_a,
            "restore_s": st_b2["restore_seconds"], "launches": _summed(runs)}


def _summed(runs: list) -> dict:
    out: dict = {}
    for r in runs:
        for k, v in r["launches"].items():
            out[k] = out.get(k, 0) + v
    return out


def _sample_fid_check(ckpt_dir: str, root: str, card: str) -> dict:
    """cli.sample_fid from the straight run's checkpoint (EMA weights, bf16,
    the whole sampler #3/#4): PNGs and the npz, and its first batch's ±1
    tokens equal to imagenet_ar.sample called directly on the restored EMA
    weights with iteration 0's generator."""
    import os

    import numpy as np
    import torch

    from bitdance_tpu_torch.cli import sample_fid
    from bitdance_tpu_torch.eval import fid
    from bitdance_tpu_torch.eval.fid import sampler_from_train_state
    from bitdance_tpu_torch.models.diff_head import make_fused_sampler
    from bitdance_tpu_torch.models.imagenet_ar import config_b
    from bitdance_tpu_torch.train.checkpoints import CheckpointManager
    from bitdance_tpu_torch.train.imagenet_train import ImageNetTrainConfig, init_train_state

    out_dir = os.path.join(root, "samples")
    calls, real = [], fid.sample

    def spy(model, head, cfg, cls, gen, **kw):
        t = time.perf_counter()
        toks = real(model, head, cfg, cls, gen, **kw)
        torch.cuda.synchronize()
        calls.append({"cls": cls.clone(), "tokens": toks.clone(), "kw": kw,
                      "s": time.perf_counter() - t})
        return toks

    fid.sample = spy
    try:
        r = _cli_run("train_cli", sample_fid.main,
                     TRAIN_CLI_FID + ["--ckpt", ckpt_dir, "--sample-dir", out_dir],
                     f"sample_fid, 32 samples in 2 batches of 16, cfg 4.6, "
                     f"{TRAIN_CLI_FID_STEPS} steps")
    finally:
        fid.sample = real
    folder = os.path.join(out_dir, f"BitDance-B-size-256-steps-{TRAIN_CLI_FID_STEPS}"
                                   "-cfg-4.6-seed-99")
    pngs = sorted(os.listdir(folder))
    arr = np.load(folder + ".npz")["arr_0"]
    dev = torch.device("cuda")
    cfg = config_b(resolution=256)
    state = init_train_state(cfg, ImageNetTrainConfig(), dev)
    CheckpointManager(ckpt_dir).restore(state)
    model, head, stacked = sampler_from_train_state(state, cfg, ema=True)
    del state
    first = calls[0]
    gen = torch.Generator(device=dev).manual_seed(99 * 1 + 0 + 0 * 131)
    direct = real(model, head, cfg, first["cls"], gen,
                  head_sampler=make_fused_sampler(head, stacked), **{
                      k: v for k, v in first["kw"].items() if k != "head_sampler"})
    same = torch.equal(direct, first["tokens"])
    pm1 = set(first["tokens"].unique().tolist()) <= {-1.0, 1.0}
    log("train_cli", f"sample_fid: {len(pngs)} PNGs, npz {tuple(arr.shape)} {arr.dtype}, "
        f"{len(np.unique(arr))} distinct values; s/batch "
        f"{', '.join(str(round(c['s'], 2)) for c in calls)} (AR + sampler, CUDA-synced), "
        f"classes of batch 0 {first['cls'][:4].tolist()}...; first batch's ±1 tokens "
        f"{tuple(first['tokens'].shape)} equal to a direct sample on the restored EMA "
        f"weights: {same}; card {card}")
    if not (pngs == [f"{i:06d}.png" for i in range(32)] and arr.shape == (32, 256, 256, 3)
            and arr.dtype == np.uint8 and len(calls) == 2 and same and pm1
            and first["cls"].tolist() == list(range(16))):
        raise SystemExit("train_cli: sample_fid's files or its first batch failed a check")
    del model, head, stacked
    return {"s_per_batch": [c["s"] for c in calls], "launches": r["launches"]}


def _tokenizer_train_steps(card: str) -> dict:
    """TOKENIZER_TRAIN's steps of train/tokenizer_train.py at the commands'
    tokenizer width (ch 256, mult [1, 1, 2, 2, 4], 4 blocks, z 16)."""
    import math

    import torch

    from bitdance_tpu_torch.cli.common import TOKENIZER_DDCONFIG
    from bitdance_tpu_torch.train.tokenizer_train import (
        TokenizerTrainConfig,
        init_tokenizer_train,
        make_tokenizer_train_step,
    )

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    tcfg = TokenizerTrainConfig(warmup_steps=0)
    state = init_tokenizer_train(dict(TOKENIZER_DDCONFIG, z_channels=16), tcfg, dev,
                                 generator=torch.Generator(device=dev).manual_seed(3))
    step = make_tokenizer_train_step(tcfg)
    g = torch.Generator(device=dev).manual_seed(4)
    n, px = TOKENIZER_TRAIN["batch"], TOKENIZER_TRAIN["px"]
    images = torch.rand((n, px, px, 3), generator=g, device=dev) * 2 - 1
    times, rows = [], []
    for _ in range(TOKENIZER_TRAIN["steps"]):
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = step(state, images)
        m = {k: v.item() for k, v in m.items()}
        times.append(time.perf_counter() - t)
        rows.append(m)
    finite = all(math.isfinite(v) for m in rows for v in m.values())
    log("train_cli", f"tokenizer training {sum(p.numel() for p in state.tx.params) / 1e6:.1f} "
        f"M parameters, batch {n} x {px} px: s/step {', '.join(f'{s:.3f}' for s in times)}; "
        f"loss {', '.join(f'{m['loss']:.4f}' for m in rows)}, grad_norm "
        f"{', '.join(f'{m['grad_norm']:.4f}' for m in rows)}, l2 "
        f"{', '.join(f'{m['l2']:.4f}' for m in rows)}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; card {card}")
    if not (finite and rows[-1]["grad_norm"] > 0 and state.step == len(rows)):
        raise SystemExit("train_cli: a tokenizer training step is not finite")
    del state
    return {"s_per_step": times}


def _mllm_cli_data(root: str, cfg) -> tuple[str, str]:
    """Two packed training sequences and a validation one, at the yaml's
    budget (GreedyPacker as scripts/train_mllm.py's data is packed), as
    .npz files."""
    import os

    import numpy as np

    from bitdance_tpu_torch.config import BITDANCE_14B_64X
    from bitdance_tpu_torch.data.packing import GreedyPacker, pack_t2i_batch, sincos_1d_table_np

    data = BITDANCE_14B_64X["data"]
    d = os.path.join(root, "packed")
    os.makedirs(d)
    table = sincos_1d_table_np(cfg.llm.hidden_size // 2, cfg.pe_max_len)
    paths, seed = [], 0
    for name in ("000.npz", "001.npz", "val.npz"):
        packer = GreedyPacker(cfg.parallel_num, data["expected_num_tokens"],
                              data["max_num_tokens"], data["max_num_tokens_per_sample"])
        chosen = None
        while chosen is None:
            for s in _t2i_samples(8, 2000 + seed):
                chosen = chosen or packer.add(s)
            seed += 1
        raw = pack_t2i_batch(chosen, cfg.parallel_num, data["max_num_tokens"], table)
        path = os.path.join(d if name != "val.npz" else root, name)
        np.savez(path, **raw)
        paths.append(path)
    return d, paths[-1]


def _train_mllm_resume(root: str, card: str) -> dict:
    """cli.train_mllm on a YAML derived from bitdance_14b_64x.yaml (the LLM
    cut to MLLM_CLI_LLM, the head to MLLM_CLI_HEAD, the mesh to one
    device): 4 steps straight, then 2 and 2 more resumed from the step-2
    checkpoint and its data file."""
    import os

    import yaml

    from bitdance_tpu_torch.cli import train_mllm
    from bitdance_tpu_torch.config import load_yaml, mllm_config_from_yaml

    ycfg = load_yaml("train/configs/bitdance_14b_64x.yaml")
    ycfg.model.llm.update(MLLM_CLI_LLM)
    ycfg.model.head.vision_pred.update(MLLM_CLI_HEAD)
    ycfg.training.update(MLLM_CLI_TRAINING)
    path = os.path.join(root, "bitdance_14b_64x_cut.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(yaml.safe_load(json.dumps(ycfg)), f)
    cfg = mllm_config_from_yaml(ycfg, 152064)
    log("train_cli", f"14B trainer's YAML: train/configs/bitdance_14b_64x.yaml with "
        f"model.llm {MLLM_CLI_LLM} and model.head.vision_pred {MLLM_CLI_HEAD} (at "
        f"Qwen3-14B width a checkpoint is ~40 GB, with the LLM alone cut 12.5 GB; the "
        f"check writes three and the machine takes 45 GiB of writes a call; the mllm "
        f"phase holds the full-width step) and training {MLLM_CLI_TRAINING} (one "
        f"device; lr 1e-3 so bf16 weights move within 4 steps); head "
        f"{cfg.head_model_dim} x {cfg.head_num_blocks} blocks, parallel "
        f"{cfg.parallel_num}, live kv tiles {cfg.attn_max_live_kv}")
    data, val_path = _mllm_cli_data(root, cfg)
    base = ["--config", path, "--data-dir", data, "--val-batch", val_path,
            "--device", "cuda"]
    a, b = os.path.join(root, "mllm_straight"), os.path.join(root, "mllm_resumed")
    st_a, st_b1, st_b2 = {}, {}, {}
    runs = [_cli_run("train_cli", train_mllm.main,
                     base + ["--results-dir", a, "--max-steps", "4"],
                     "train_mllm, 4 steps straight", st_a),
            _cli_run("train_cli", train_mllm.main,
                     base + ["--results-dir", b, "--max-steps", "2"],
                     "train_mllm, 2 steps", st_b1),
            _cli_run("train_cli", train_mllm.main,
                     base + ["--results-dir", b, "--max-steps", "4"],
                     "train_mllm resumed to step 4", st_b2)]
    gb = _dir_gb(os.path.join(a, "checkpoints", "4"))
    n, diff = _same_checkpoint(os.path.join(a, "checkpoints"), os.path.join(b, "checkpoints"), 4)
    trained = _trained(os.path.join(a, "checkpoints"), os.path.join(b, "checkpoints"), 4, 2,
                       ema=False)      # the 14B yaml keeps no EMA
    val = st_a.get("val", [])
    ph = st_a["phase_seconds"]
    saves = st_a["save_seconds"] + st_b1["save_seconds"] + st_b2["save_seconds"]
    log("train_cli", f"train_mllm: s/step {', '.join(f'{x:.3f}' for x in st_a['step_seconds'])} "
        f"(batch loads {ph['batch']:.3f} s, train steps {ph['train_step']:.3f} s over the 4, "
        f"{ph['clock']}), saves {', '.join(f'{x:.2f}' for x in saves)} s, "
        f"checkpoint {gb:.3f} GB, restore {st_b2['restore_seconds']:.2f} s, validation "
        f"{[round(v['val_loss'], 4) for v in val]}; resumed == straight: {n - len(diff)} of "
        f"{n} tensors bit-equal, differing {diff[:6]}; {trained}; card {card}")
    if diff or len(val) != 2:
        raise SystemExit(f"train_cli: the resumed 14B run differs from the straight one "
                         f"in {len(diff)} tensors ({diff[:8]}) or validation did not run")
    return {"s_per_step": st_a["step_seconds"], "gb": gb,
            "restore_s": st_b2["restore_seconds"], "launches": _summed(runs)}


def phase_train_cli(card: str) -> dict:
    """The training entry points (ROADMAP A10) on the card, in this process
    through each command's main(argv): (a) a synthetic tar in the official
    layout, its native index equal to the Python walk; (b) cli.train_imagenet
    at BitDance-B-1x, resumed equal to straight bit for bit; (c)
    cli.sample_fid from its checkpoint; (d) tokenizer training steps; (e)
    cli.train_mllm on a cut 14B YAML, resumed equal to straight. Returns the
    launches of the kernels on these paths (every command run; the checks'
    own launches not counted)."""
    import os
    import shutil

    from bitdance_tpu_torch.data.imagenet import python_tar_index
    from bitdance_tpu_torch.data.native import build_tar_index_native

    t_phase = time.perf_counter()
    root = os.path.abspath(TRAIN_CLI_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    free = shutil.disk_usage(root).free / 1e9
    if free < 30:                   # two B-1x runs' checkpoints at once: ~12 GB
        raise SystemExit(f"train_cli: {free:.1f} GB free under {root}, want 30")
    tar = os.path.join(root, "train.tar")
    t = time.perf_counter()
    n_img = _synthetic_imagenet_tar(tar)
    t_tar = time.perf_counter() - t
    t = time.perf_counter()
    native, classes = build_tar_index_native(tar, tar + ".native")
    t_native = time.perf_counter() - t
    py = python_tar_index(tar)
    same = [tuple(e) for e in native] == py
    log("train_cli", f"synthetic tar {TRAIN_CLI_TAR[0]} classes x {TRAIN_CLI_TAR[1]} JPEGs "
        f"at {TRAIN_CLI_TAR[2]} ({os.path.getsize(tar) / 1e6:.1f} MB, written in "
        f"{t_tar:.2f} s); native index {len(native)} entries, {len(classes)} classes in "
        f"{t_native * 1e3:.1f} ms; equal to the Python walk: {same}")
    if not (same and len(py) == n_img and len(classes) == TRAIN_CLI_TAR[0]):
        raise SystemExit("train_cli: the native tar index differs from the Python walk")

    im = _train_imagenet_resume(tar, root, card)
    fid = _sample_fid_check(os.path.join(im["straight"], "checkpoints"), root, card)
    shutil.rmtree(im["straight"])
    shutil.rmtree(im["resumed"])
    tok = _tokenizer_train_steps(card)
    ml = _train_mllm_resume(root, card)
    shutil.rmtree(root)
    launches = _summed([im, fid, ml])
    log("train_cli", f"phase {time.perf_counter() - t_phase:.1f} s; kernel launches of its "
        f"commands {launches}; card {card}")
    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_em_sample",
              "flash_fwd_sparse", "flash_bwd_dq_sparse", "flash_bwd_dkv_sparse"):
        if launches.get(k, 0) < 1:
            raise SystemExit(f"train_cli: {k} was not launched by the commands")
    return {"launches": launches, "imagenet_s_per_step": im["s_per_step"],
            "imagenet_stats": im["stats"], "fid_s_per_batch": fid["s_per_batch"],
            "tokenizer_s_per_step": tok["s_per_step"], "mllm": ml}


# ---------------------------------------------------------------------------
# The release directory: export, load_t2i_pipeline and the CLI
# ---------------------------------------------------------------------------

RELEASE_LAYERS = 2           # of the 40: the fp32 LLM alone is 8.8 GB at 2
RELEASE_REQUEST = ("a lighthouse at dusk, released", 512, 11)
# cli.interleaved on the release directory, the T2I CLI's PNG as user image
RELEASE_INTERLEAVED = dict(side=256, max_length_text=16)
# eval.dpg / eval.geneval's commands on the release directory
RELEASE_EVAL_PX = 256
RELEASE_EVAL_STEPS = 4


def phase_release(card: str) -> dict:
    """A random BitDance-14B-64x bundle at full width, RELEASE_LAYERS of its
    40 layers, exported as a release directory (the LLM as fp32 HF Qwen3,
    the head, VQ decoder and projector in their bf16, as the released
    shards are) under the gitignored build/, loaded back with
    load_t2i_pipeline: one 512 px request whose +-1 grid must equal the
    in-memory bundle's bit for bit, one 2-image request (R = 256 sampler
    rows), one quantized load (int8 W8A8 LLM, int8 embedding, int4 W4A8
    head) whose grid must equal the same quantizers applied in memory; then
    the CLI once on the directory as a subprocess (its PNG must equal the
    in-memory image), and cli.interleaved once with that PNG as the user
    image (the bundle has an lm_head and the VQ encoder, which the export
    carries): its text and PNG must equal an in-memory InterleavedGenerator
    on the same plan and seed; eval.dpg.main and eval.geneval.main on the
    directory (:func:`_release_eval_cmds`). The directory is deleted."""
    import copy
    import dataclasses
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from bitdance_tpu_torch.io.random_init import (
        BITDANCE_14B_64X,
        _module_tree_copy,
        build_random_bundle,
    )
    from bitdance_tpu_torch.cli import interleaved as interleaved_cli
    from bitdance_tpu_torch.cli.common import read_png
    from bitdance_tpu_torch.models.qwen3 import Qwen3Config, quantized_structure_
    from bitdance_tpu_torch.ops.fused_head import fused_em_sample
    from bitdance_tpu_torch.pipelines.interleaved import InterleavedGenerator, plan_slots
    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline
    from bitdance_tpu_torch.pipelines.t2i import T2IPipeline
    from bitdance_tpu_torch.train.checkpoints import export_hf_qwen3, export_release_dir

    root = Path(__file__).resolve().parent / "build"
    out_dir = root / "release_14b"
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(Qwen3Config.qwen3_14b(), num_hidden_layers=RELEASE_LAYERS)
    bundle = build_random_bundle("cuda", llm_cfg=cfg, seed=5, lm_head=True, encoder=True)
    tok = StubTokenizer(bundle.parallel_num)
    prompt, px, seed = RELEASE_REQUEST

    def request(pipe, n=1):
        img, tokens = pipe.generate(prompt, px, px, num_sampling_steps=50,
                                    guidance_scale=7.5, num_images=n, seed=seed,
                                    return_tokens=True)
        ok = (img.shape == (n, px, px, 3) and tokens.shape == (n, (px // 16) ** 2, 32)
              and set(np.unique(tokens).tolist()) <= {-1.0, 1.0})
        if not ok:
            raise SystemExit(f"release: a {n}-image request failed its checks")
        return img, tokens

    mem_img, mem_tok = request(T2IPipeline(bundle, tok))
    # the interleaved CLI's plan on the T2I image, in memory
    plan = interleaved_cli.example_plan(interleaved_cli.PROMPT, mem_img[0],
                                        RELEASE_INTERLEAVED["side"])
    gen = InterleavedGenerator(bundle, tok, max_seq_len=plan_slots(
        plan, tok, bundle, RELEASE_INTERLEAVED["max_length_text"]))
    inter = gen.generate(plan, cfg_scale=7.5, sample_steps=50, seed=seed,
                         max_length_text=RELEASE_INTERLEAVED["max_length_text"])
    mem_said = "model said: " + inter["generated_text"][0]
    mem_inter = interleaved_cli.to_uint8(inter["generated_image"][0])
    del gen
    llm_q = quantized_structure_(_module_tree_copy(bundle.llm), "int8",
                                 embed_int8=True, fill=True)
    head_q = copy.copy(bundle.head)
    head_q.sample_weight_quant = "int4"
    bundle_q = dataclasses.replace(bundle, llm=llm_q, head=head_q,
                                   head_stacked=head_q._stack_for_sampler())
    _, mem_tok_q = request(T2IPipeline(bundle_q, tok))
    del bundle_q, llm_q, head_q
    log("release", f"BitDance-14B-64x at {RELEASE_LAYERS} of 40 layers: bundle and "
        f"the two in-memory requests in {time.perf_counter() - t0:.1f} s")

    need = sum(p.numel() * 4 for p in bundle.llm.parameters()) + sum(
        p.numel() * p.element_size()
        for m in (bundle.head, bundle.ae, bundle.projector) for p in m.state_dict().values())
    root.mkdir(exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < 1.05 * need:
        raise SystemExit(f"release: the export needs {need / 1e9:.1f} GB under "
                         f"{root}, {free / 1e9:.1f} GB are free (short by "
                         f"{(1.05 * need - free) / 1e9:.1f} GB)")
    geo = BITDANCE_14B_64X
    t0 = time.perf_counter()
    export_release_dir(str(out_dir), ae=bundle.ae, head=bundle.head,
                       projector=bundle.projector, dtype=None, configs={
                           "ae_config": {"ddconfig": geo["ddconfig"], "gan_decoder": False},
                           "vision_head_config": dict(geo["head"])})
    export_hf_qwen3(bundle.llm, str(out_dir))
    export_s = time.perf_counter() - t0
    gb = sum(f.stat().st_size for f in out_dir.iterdir()) / 1e9
    del bundle
    gc.collect()
    torch.cuda.empty_cache()

    try:
        t0 = time.perf_counter()
        pipe = load_t2i_pipeline(str(out_dir), tokenizer=tok)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        _, tokens = request(pipe)
        same = np.array_equal(tokens, mem_tok)
        fused_em_sample.launches = 0
        t0 = time.perf_counter()
        request(pipe, 2)
        two_s = time.perf_counter() - t0
        two_launches = fused_em_sample.launches
        plain_256 = pipe.generate(prompt, GAN_RELEASE_PX, GAN_RELEASE_PX, num_sampling_steps=50,
                                  guidance_scale=7.5, seed=seed, return_tokens=True)
        evals = _release_eval_cmds(out_dir, pipe, tok, card)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        pipe = load_t2i_pipeline(str(out_dir), quantize_llm=True, quantize_head="int4",
                                 quantize_embed=True, tokenizer=tok)
        torch.cuda.synchronize()
        load_q_s = time.perf_counter() - t0
        _, tokens_q = request(pipe)
        same_q = np.array_equal(tokens_q, mem_tok_q)
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
        png = out_dir / "cli.png"
        t0 = time.perf_counter()
        cli = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; from bitdance_tpu_torch.cli "
             "import t2i; sys.exit(t2i.main(sys.argv[1:], tokenizer="
             "chip_smoke.StubTokenizer(64)))", str(out_dir), "--prompt", prompt,
             "--resolution", str(px), "--seed", str(seed), "--out", str(png)],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
            timeout=600)
        cli_s = time.perf_counter() - t0
        if cli.returncode != 0:
            raise SystemExit(f"release: the CLI failed:\n{cli.stderr[-3000:]}")
        cli_same = np.array_equal(read_png(png), mem_img[0])
        inter_png = out_dir / "interleaved.png"
        t0 = time.perf_counter()
        icli = subprocess.run(
            [sys.executable, "-c", "import sys, chip_smoke; from bitdance_tpu_torch.cli "
             "import interleaved; sys.exit(interleaved.main(sys.argv[1:], tokenizer="
             "chip_smoke.StubTokenizer(64)))", str(out_dir), "--image", str(png),
             "--image-size", str(RELEASE_INTERLEAVED["side"]), "--max-length-text",
             str(RELEASE_INTERLEAVED["max_length_text"]), "--seed", str(seed),
             "--out", str(inter_png)],
            cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
            timeout=600)
        icli_s = time.perf_counter() - t0
        if icli.returncode != 0:
            raise SystemExit(f"release: the interleaved CLI failed:\n{icli.stderr[-3000:]}")
        icli_lines = icli.stdout.strip().splitlines()
        icli_same = (icli_lines[0] == mem_said
                     and np.array_equal(read_png(inter_png), mem_inter))
        gan = _gan_release(out_dir, tok, prompt, seed, plain_256, card)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
        shutil.rmtree(out_dir.parent / "release_14b_gan", ignore_errors=True)
    steps = (px // 16) ** 2 // 64
    log("release", f"export {export_s:.1f} s, {gb:.2f} GB on disk; load "
        f"{load_s:.1f} s (bf16), {load_q_s:.1f} s (int8 LLM and embedding, int4 "
        f"head); {px} px grid equal to the in-memory bundle's: {same}; 2-image "
        f"request {two_s:.2f} s ({two_launches} sampler launches at R = 256, want "
        f"{steps}); quantized grid equal to the in-memory quantizers': {same_q}; "
        f"CLI {cli_s:.1f} s ({cli.stdout.strip().splitlines()[-1]}), PNG equal to "
        f"the in-memory image: {cli_same}; interleaved CLI {icli_s:.1f} s "
        f"({icli_lines[-1]}), text and PNG equal to the in-memory generator's: "
        f"{icli_same} ({mem_said[:80]}...); card {card}")
    if not (same and same_q and cli_same and icli_same and two_launches == steps):
        raise SystemExit("release: a loaded grid, a CLI's output or the "
                         "2-image request failed its check")
    return {"export_s": export_s, "gb": gb, "load_s": load_s, "load_q_s": load_q_s,
            "interleaved_cli_s": icli_s, "gan": gan, "evals": evals}


GAN_RELEASE_PX = 256


def _gan_release(out_dir, tok, prompt: str, seed: int, plain, card: str) -> dict:
    """The release served a second time with a GAN-decoder tokenizer: a
    sibling directory whose ae_config.json says ``gan_decoder: true`` and
    which holds a random GAN decoder's ae.safetensors, every other file a
    link into ``out_dir``. One GAN_RELEASE_PX request twice: its token grid
    equals the plain release's (``plain``: (image, tokens) of the same
    request; the LLM, head and seed are the same), and its two images are
    equal bit for bit (the decoder's noise from the request's generator)."""
    import os

    import numpy as np
    import torch

    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X as GEO
    from bitdance_tpu_torch.models.tokenizer import init_vq
    from bitdance_tpu_torch.pipelines.loader import load_t2i_pipeline
    from bitdance_tpu_torch.train.checkpoints import export_release_dir

    gan_dir = out_dir.parent / "release_14b_gan"
    gan_dir.mkdir()
    for f in out_dir.iterdir():
        if f.name not in ("ae.safetensors", "ae_config.json") and f.suffix != ".png":
            os.symlink(f.resolve(), gan_dir / f.name)
    ae = init_vq(GEO["ddconfig"], "cuda", torch.bfloat16, _seeded(41), gan_decoder=True)
    export_release_dir(str(gan_dir), ae=ae, dtype=None, configs={
        "ae_config": {"ddconfig": GEO["ddconfig"], "gan_decoder": True}})
    del ae
    pipe, load_s = _timed(lambda: load_t2i_pipeline(str(gan_dir), tokenizer=tok))
    px = GAN_RELEASE_PX
    runs = [_timed(lambda: pipe.generate(prompt, px, px, num_sampling_steps=50,  # noqa: B023
                                         guidance_scale=7.5, seed=seed, return_tokens=True))
            for _ in range(2)]
    (img, tokens), s = runs[0]
    (img2, tokens2), _ = runs[1]
    grid_same = np.array_equal(tokens, plain[1]) and np.array_equal(tokens2, plain[1])
    img_same = np.array_equal(img, img2)
    gan = pipe.bundle.ae.gan_decoder and pipe.bundle.ae.decoder.conv_in.weight.shape[1] == 64
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    log("release", f"GAN-decoder release (linked beside the plain one): load {load_s:.1f} s, a "
        f"{px} px request {s:.2f} s; GAN decoder loaded {gan}; grid equal to the plain "
        f"release's {grid_same}; the request twice gives equal images {img_same} (and "
        f"another image than the plain decoder's: {not np.array_equal(img, plain[0])}); "
        f"card {card}")
    if not (gan and grid_same and img_same):
        raise SystemExit("release: the GAN-decoder release failed its checks")
    return {"load_s": load_s, "request_s": s}


# ---------------------------------------------------------------------------
# The last entry points: the DPG / GenEval harnesses and the demo server on
# the e2e bundle, and the hard-kill training proof
# ---------------------------------------------------------------------------

EVAL_SERVE_PX = 512
EVAL_DPG_PROMPTS = "eval_assets/dpg/prompts.json"
EVAL_GENEVAL_LONG = "eval_assets/geneval/evaluation_metadata_long.jsonl"
SERVE_REQUEST = ("a red fox in the snow, served", 21)        # prompt, seed
DEMO_CONTROLS = ("prompt", "resolution", "steps", "cfg", "num_images", "seed")


def _tiled(images):
    """[4, H, W, 3] -> the 2x2 grid eval/base.py::save_grid writes."""
    import numpy as np

    top, bottom = np.concatenate(images[:2], axis=1), np.concatenate(images[2:], axis=1)
    return np.concatenate([top, bottom], axis=0)


def _serve_once(pipe, request: dict, png_path) -> tuple:
    """The demo's fallback server on a free port in a thread: its page, one
    POST /generate of ``request`` (seconds on the host clock) decoded to
    uint8 images through ``png_path``, then shut down. Returns (page, the
    answer's error or None, images, seconds)."""
    import base64
    import threading
    import urllib.request

    import numpy as np

    from bitdance_tpu_torch.cli.app import make_fallback_server
    from bitdance_tpu_torch.cli.common import read_png

    srv = make_fallback_server(pipe, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        page = urllib.request.urlopen(url + "/", timeout=60).read().decode()
        t0 = time.perf_counter()
        out = json.loads(urllib.request.urlopen(urllib.request.Request(
            url + "/generate", data=json.dumps(request).encode(),
            headers={"Content-Type": "application/json"}), timeout=600).read())
        s = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()
    images = []
    for b64 in out.get("images", []):
        png_path.write_bytes(base64.b64decode(b64))
        images.append(read_png(png_path))
    return page, out.get("error"), np.stack(images) if images else None, s


def phase_eval_serve(bundle, card: str) -> dict:
    """The DPG and GenEval harnesses and the demo server on the e2e phase's
    full-width, full-depth BitDance-14B-64x bundle, EVAL_SERVE_PX px, 50
    steps: DPGEvaluator on the first two vendored DPG prompts (4 images a
    prompt, cfg 7.5), each grid PNG equal to a direct generate of the same
    prompt and seed tiled 2x2; GenevalEvaluator on the first long GenEval
    line (cfg 13.0), its metadata the line verbatim, its samples and grid
    equal to a direct generate; the fallback server's page (the six control
    ids) and one 1-image request, decoded equal to a direct generate, no
    error. Returns #1's and #2's launches and the times."""
    import os
    import shutil
    from pathlib import Path

    import numpy as np
    import torch

    from bitdance_tpu_torch.cli.common import read_png
    from bitdance_tpu_torch.eval.dpg import DPGEvaluator
    from bitdance_tpu_torch.eval.geneval import GenevalEvaluator
    from bitdance_tpu_torch.ops.decode_attention import decode_attention
    from bitdance_tpu_torch.ops.fused_head import fused_em_sample
    from bitdance_tpu_torch.pipelines.t2i import T2IPipeline

    t_phase = time.perf_counter()
    here = Path(__file__).resolve().parent
    out = here / "build" / "eval_serve"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    pipe = T2IPipeline(bundle, StubTokenizer(bundle.parallel_num))
    px, layers = EVAL_SERVE_PX, bundle.llm_cfg.num_hidden_layers
    steps = (px // bundle.vae_patch_size) ** 2 // bundle.parallel_num
    decode_attention.launches = 0
    fused_em_sample.launches = 0
    requests = 0

    def direct(prompt, n, cfg_scale, seed):
        nonlocal requests
        requests += 1
        return pipe.generate(prompt, px, px, num_sampling_steps=50, guidance_scale=cfg_scale,
                             num_images=n, seed=seed)

    def harness(cls, data, where, n):
        nonlocal requests
        ev = cls("unused", pipeline=pipe)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev.eval(str(here / data), str(out / where), num_sampling_steps=50,
                image_size=(px, px), max_prompts=n)
        requests += n
        return ev, (time.perf_counter() - t0) / n

    dpg, dpg_s = harness(DPGEvaluator, EVAL_DPG_PROMPTS, "dpg", 2)
    with open(here / EVAL_DPG_PROMPTS) as f:
        prompts = list(json.load(f).items())[:2]
    dpg_ok = (dpg.seed == 4396 and sorted(os.listdir(out / "dpg"))
              == sorted(f"{pid}.png" for pid, _ in prompts))
    t0 = time.perf_counter()
    for pid, prompt in prompts:
        dpg_ok = dpg_ok and np.array_equal(read_png(out / "dpg" / f"{pid}.png"),
                                           _tiled(direct(prompt, 4, 7.5, 4396)))
    direct_s = (time.perf_counter() - t0) / len(prompts)

    gen, gen_s = harness(GenevalEvaluator, EVAL_GENEVAL_LONG, "geneval", 1)
    with open(here / EVAL_GENEVAL_LONG) as f:
        line = f.readline()
    d = out / "geneval" / "00000"
    layout = sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())
    want = direct(json.loads(line)["prompt"], 4, 13.0, 4396)
    gen_ok = (os.listdir(out / "geneval") == ["00000"]
              and layout == ["grid.png", "metadata.jsonl"]
              + [f"samples/{i:04d}.png" for i in range(4)]
              and (d / "metadata.jsonl").read_text() == line
              and all(np.array_equal(read_png(d / "samples" / f"{i:04d}.png"), want[i])
                      for i in range(4))
              and np.array_equal(read_png(d / "grid.png"), _tiled(want)))

    prompt, seed = SERVE_REQUEST
    page, error, served, serve_s = _serve_once(pipe, {
        "prompt": prompt, "resolution": f"{px}x{px}", "steps": 50, "cfg": 7.5,
        "num_images": 1, "seed": seed}, out / "served.png")
    requests += 1
    ids_ok = all(f'id="{c}"' in page for c in DEMO_CONTROLS)
    serve_ok = (ids_ok and not error and served is not None and served.shape == (1, px, px, 3)
                and np.array_equal(served, direct(prompt, 1, 7.5, seed)))
    da, fs = decode_attention.launches, fused_em_sample.launches
    want_da, want_fs = requests * layers * (1 + steps), requests * steps
    shutil.rmtree(out, ignore_errors=True)
    log("eval_serve", f"BitDance-14B-64x (full width and depth, random bf16), {px} px, 50 "
        f"steps, 4 images a prompt: DPG harness {dpg_s:.3f} s a prompt (cfg 7.5; a direct "
        f"4-image generate {direct_s:.3f} s), its 2 grids equal to direct generates tiled "
        f"2x2 {dpg_ok}; GenEval harness {gen_s:.3f} s a prompt (cfg 13.0), layout, "
        f"metadata, samples and grid equal {gen_ok}; demo server: page has the six control "
        f"ids {ids_ok}, one 1-image request {serve_s:.3f} s (host clock, through HTTP), "
        f"error {error!r}, images equal to a direct generate {serve_ok}; {requests} requests, "
        f"decode_attention +{da} (want {want_da}), fused_em_sample +{fs} (want {want_fs}); "
        f"phase {time.perf_counter() - t_phase:.1f} s; card {card}")
    if not (dpg_ok and gen_ok and serve_ok and da == want_da and fs == want_fs):
        raise SystemExit("eval_serve: a harness, the server or a launch count failed its check")
    return {"launches": {"decode_attention": da, "fused_em_sample": fs},
            "dpg_s": dpg_s, "geneval_s": gen_s, "serve_s": serve_s, "direct_s": direct_s}


# the training-run proof: BitDance-B-1x (a published model) at 256 px,
# parallel_num 1, world 1; a kill after the run phase's save
TRAIN_PROOF = dict(batch=32, steps=24, kill_at=12, warmup=4)
TRAIN_PROOF_DIR = "build/train_proof"     # gitignored; emptied before and after


def phase_train_proof(card: str) -> dict:
    """``python -m bitdance_tpu_torch.cli.train_proof`` as a real process
    pair (run, killed with os._exit(9) right after its save, then resume) at
    world 1, BitDance-B-1x, 256 px, descent required: TRAIN_PROOF OK, one
    resume event bit-identical at the kill step, steps 1..N with no gap, the
    loss descended; s/step, first and last loss, GB written. Returns the
    flash kernels' launches the two phases printed."""
    import os
    import shutil
    from pathlib import Path

    from bitdance_tpu_torch.models.imagenet_ar import IMAGENET_MODELS

    layers = IMAGENET_MODELS["BitDance-B"]().n_layer   # each kernel once a layer a step
    here = Path(__file__).resolve().parent
    root = here / TRAIN_PROOF_DIR
    shutil.rmtree(root, ignore_errors=True)
    p = TRAIN_PROOF
    out = root / "proof.jsonl"
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "bitdance_tpu_torch.cli.train_proof", "--model", "BitDance-B",
         "--parallel", "1", "--batch", str(p["batch"]), "--steps", str(p["steps"]),
         "--kill-at", str(p["kill_at"]), "--ckpt-every", str(p["kill_at"]),
         "--keep-last-n", "1", "--warmup", str(p["warmup"]), "--workdir", str(root / "work"),
         "--out", str(out), "--require-descent"],
        cwd=here, capture_output=True, text=True, timeout=600)
    s = time.perf_counter() - t0
    try:
        lines = [json.loads(ln) for ln in out.read_text().splitlines()] if out.exists() else []
        ckpt = root / "work" / "checkpoints"
        kept = [d for d in os.listdir(ckpt) if d.isdigit()] if ckpt.exists() else []
        per_ckpt = _dir_gb(str(ckpt)) / max(1, len(kept))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches, seconds = {}, []
    for ln in run.stdout.splitlines():
        if ln.startswith("LAUNCHES "):
            for k, v in json.loads(ln[len("LAUNCHES "):]).items():
                launches[k] = launches.get(k, 0) + v
        elif ln.startswith("SECONDS "):
            seconds.append(json.loads(ln[len("SECONDS "):]))
    events = [e.get("event") for e in lines if "event" in e]
    steps = [e for e in lines if "loss" in e]
    resume = [e for e in lines if e.get("event") == "resume"]
    done = lines[-1] if lines and lines[-1].get("event") == "done" else {}
    saves = events.count("save")
    step_s = [e["step_s"] for e in steps]
    log("train_proof", f"cli.train_proof, BitDance-B-1x, 256 px, batch {p['batch']}, "
        f"{p['steps']} steps (warmup {p['warmup']}), killed with os._exit(9) after the "
        f"step-{p['kill_at']} save, resumed in a new process: rc {run.returncode}, "
        f"{s:.1f} s of command; events {events}; resume (step, bit-identical) "
        f"{[(e['step'], e['bit_identical']) for e in resume]}; s/step median "
        f"{_median(step_s[1:]) if len(step_s) > 1 else float('nan'):.3f} (first "
        f"{step_s[0] if step_s else float('nan'):.3f}; host clock, each step read back); "
        f"loss {steps[0]['loss'] if steps else None} -> {steps[-1]['loss'] if steps else None}"
        f", first / last {done.get('loss_first20')} / {done.get('loss_last20')}, descended "
        f"{done.get('descended')}; {saves} saves of {per_ckpt:.2f} GB, {saves * per_ckpt:.2f} "
        f"GB written; flash launches {launches}; the phases' seconds (run, resume) "
        f"{seconds}, the rest of the {s:.1f} s (process starts, imports) "
        f"{s - sum(sum(x.values()) for x in seconds):.1f}; card {card}")
    if run.returncode != 0:
        raise SystemExit(f"train_proof: the command failed (rc {run.returncode}):\n"
                         f"{run.stdout[-2000:]}\n{run.stderr[-3000:]}")
    ok = ("TRAIN_PROOF OK" in run.stdout and f"KILL at step {p['kill_at']}" in run.stdout
          and len(resume) == 1 and resume[0]["bit_identical"] is True
          and resume[0]["step"] == p["kill_at"]
          and [e["step"] for e in steps] == list(range(1, p["steps"] + 1))
          and done.get("descended") is True and len(launches) == 3
          and all(n == p["steps"] * layers for n in launches.values()))
    if not ok:
        raise SystemExit("train_proof: the proof's log or output failed its checks")
    return {"launches": launches, "s": s, "step_s": _median(step_s[1:]),
            "loss": (steps[0]["loss"], steps[-1]["loss"]), "gb_written": saves * per_ckpt}


def _release_eval_cmds(out_dir, pipe, tok, card: str) -> dict:
    """eval.dpg.main and eval.geneval.main on the release directory (one
    prompt each, RELEASE_EVAL_PX px, RELEASE_EVAL_STEPS steps, the stub
    tokenizer), each file tree equal byte for byte to the same evaluator run
    in this process on ``pipe`` (load_t2i_pipeline of the directory), the
    GenEval layout and metadata checked."""
    import shutil
    from pathlib import Path

    import torch

    from bitdance_tpu_torch.eval import dpg, geneval

    here = Path(__file__).resolve().parent
    px, n = RELEASE_EVAL_PX, RELEASE_EVAL_STEPS
    got = {}
    for name, mod, cls, data in (("dpg", dpg, dpg.DPGEvaluator, EVAL_DPG_PROMPTS),
                                 ("geneval", geneval, geneval.GenevalEvaluator,
                                  EVAL_GENEVAL_LONG)):
        mem, cmd = out_dir / f"{name}_mem", out_dir / f"{name}_cmd"
        cls("unused", pipeline=pipe).eval(str(here / data), str(mem), num_sampling_steps=n,
                                          image_size=(px, px), max_prompts=1)
        t0 = time.perf_counter()
        rc = mod.main(["--model_path", str(out_dir), "--data_path", str(here / data),
                       "--save_dir", str(cmd), "--image_size", str(px), str(px),
                       "--num_sampling_steps", str(n), "--max_prompts", "1"], tokenizer=tok)
        s = time.perf_counter() - t0
        tree = {str(p.relative_to(cmd)): p.read_bytes() for p in sorted(cmd.rglob("*"))
                if p.is_file()}
        same = rc == 0 and tree == {str(p.relative_to(mem)): p.read_bytes()
                                    for p in sorted(mem.rglob("*")) if p.is_file()}
        with open(here / data) as f:
            first = f.readline() if name == "geneval" else next(iter(json.load(f)))
        layout = (sorted(tree) == [f"{first}.png"] if name == "dpg" else
                  sorted(tree) == ["00000/grid.png", "00000/metadata.jsonl"]
                  + [f"00000/samples/{i:04d}.png" for i in range(4)]
                  and tree["00000/metadata.jsonl"] == first.encode())
        got[name] = {"s": s, "same": same, "layout": layout}
        shutil.rmtree(mem, ignore_errors=True)
        shutil.rmtree(cmd, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    log("release", f"eval.dpg.main / eval.geneval.main on the directory (1 prompt, 4 images, "
        f"{px} px, {n} steps): {got['dpg']['s']:.1f} / {got['geneval']['s']:.1f} s of command "
        f"(load included); layout {got['dpg']['layout']} / {got['geneval']['layout']}; every "
        f"file equal to the evaluator in this process on the loaded pipeline "
        f"{got['dpg']['same']} / {got['geneval']['same']}; card {card}")
    if not all(g["same"] and g["layout"] for g in got.values()):
        raise SystemExit("release: an eval command's files failed their check")
    return got


def _tp_plain_run(world: int, dev, cfg, tok) -> dict:
    """The plain-MLP T2I head (head_leftovers' seeded head: use_swiglu
    false, no sampler stack, the per-call route with #15) beside the seeded
    2-layer LLM: TP_REQUEST at tp 1, one head sample from the prefill's
    cond, then the bundle sharded over a (1, 1, world) mesh in place (the
    LLM split, the head whole) and the same request and sample at tp
    ``world``, with #1 / #15 launches and a checksum of the head before
    and after."""
    import numpy as np
    import torch

    from bitdance_tpu_torch.io.random_init import BITDANCE_14B_64X, build_random_bundle, init_head
    from bitdance_tpu_torch.ops.decode_attention import decode_attention
    from bitdance_tpu_torch.ops.fused_block import fused_attn_block
    from bitdance_tpu_torch.ops.fused_head import fused_em_sample
    from bitdance_tpu_torch.parallel.mesh import create_mesh
    from bitdance_tpu_torch.pipelines.t2i import T2IPipeline

    prompt, px, seed = TP_REQUEST
    kw = dict(BITDANCE_14B_64X["head"], use_swiglu=False)
    bundle = build_random_bundle(dev, llm_cfg=cfg, seed=0,
                                 geometry=dict(BITDANCE_14B_64X, head=kw))
    bundle.head = init_head(kw, dev, torch.bfloat16, _seeded(31))

    def checksum():
        return sum(p.double().sum().item() + p.double().abs().sum().item()
                   for p in bundle.head.parameters())

    gen = dict(height=px, width=px, num_sampling_steps=TP_STEPS, guidance_scale=TP_CFG,
               num_images=1, seed=seed, return_tokens=True)

    def head_sample(pipe, cond):
        with torch.no_grad():
            return pipe.bundle.head.sample(cond, _seeded(seed + 100), TP_CFG, TP_STEPS, 2)

    pipe1 = T2IPipeline(bundle, tok)
    _, tokens1 = pipe1.generate(prompt, **gen)
    hidden1 = teacher_forced(pipe1, prompt, px, tokens1)
    pe0 = _t2i_request_inputs(pipe1, prompt, px)[3][:bundle.parallel_num]
    cond = (hidden1[0] + pe0.to(hidden1[0].dtype)[None]).bfloat16()
    latent1 = head_sample(pipe1, cond)
    before = checksum()
    del pipe1
    pipe = T2IPipeline(bundle, tok, mesh=create_mesh(1, 1, world, device_type=dev.type))
    counts = (decode_attention, fused_attn_block, fused_em_sample)
    for fn in counts:
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tokens = pipe.generate(prompt, **gen)
    s_request = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counts}
    hidden = teacher_forced(pipe, prompt, px, tokens1)
    latent = head_sample(pipe, cond)
    at = pipe.bundle.llm.model.layers[0].self_attn
    return {"tokens": tokens, "tokens1": tokens1, "s_request": s_request,
            "grid_equal": bool(np.array_equal(tokens, tokens1)),
            "agreement": float(np.mean(tokens == tokens1)),
            "hidden_rel": max(((a - b).abs().max() / b.abs().max()).item()
                              for a, b in zip(hidden, hidden1)),
            "sample_equal": bool(torch.equal(latent, latent1)),
            "head_whole": pipe.bundle.head_stacked is None and checksum() == before,
            "launches": launches, "heads": (at.num_heads, at.num_kv_heads),
            "steps": len(hidden) - 1}


def build_imagenet_samplers():
    """Random BitDance-H-1x (IMAGENET_H1X_LAYERS of its 40 backbone layers)
    and BitDance-B-16x samplers (bf16) on the card."""
    import dataclasses

    import torch

    from bitdance_tpu_torch.io.random_init import build_random_imagenet_sampler
    from bitdance_tpu_torch.models.imagenet_ar import config_b, config_h

    out = []
    h1x = dataclasses.replace(config_h(), n_layer=IMAGENET_H1X_LAYERS)
    for name, cfg, seed in (("BitDance-H-1x", h1x, 3),
                            ("BitDance-B-16x", config_b(parallel_num=16), 4)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b = build_random_imagenet_sampler(cfg, "cuda", seed=seed)
        torch.cuda.synchronize()
        n = lambda m: sum(p.numel() for p in m.parameters()) / 1e6  # noqa: E731
        log("imagenet", f"{name} random bf16 sampler in {time.perf_counter() - t0:.1f} "
            f"s: backbone {n(b.model):.1f} M, head {n(b.head):.1f} M, VQ decoder "
            f"{n(b.ae):.1f} M parameters; "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
        out.append(b)
    return out


# run by --train-memory in each checkout (its chip_smoke.py and package)
TRAIN_MEMORY_CHILD = r"""
import sys

import torch

import chip_smoke as c

if "peak" not in c._cli_run.__doc__:            # from before the peaks
    inner = c._cli_run

    def _cli_run(phase, main, argv, what, stats=None):
        c.gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = inner(phase, main, argv, what, stats)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        c.log(phase, f"{what}: peak {peak:.2f} GiB above its start")
        return out

    c._cli_run = _cli_run
c.phase_device()
card = c.card_line()
c.phase_build()
c.phase_train_cli(card)
layers = int(sys.argv[1])
if hasattr(c, "parallel_mllm_run"):
    from bitdance_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(device_type="cuda")
    case = c.parallel_mllm_case(torch.device("cuda"), layers)
    for sharded in (True, False):
        how = "sharded" if sharded else "unsharded"
        try:
            r = c.parallel_mllm_run(mesh, case, sharded)
            c.log("train_memory", f"14B yaml, full width, {layers} of 40 layers, one "
                  f"step {how}: {r['s'][0]:.3f} s, peak {r['peak']:.2f} GiB above its "
                  f"start, loss {r['metrics'][0]['loss']:.5f}; card {card}")
            del r
        except torch.OutOfMemoryError as e:
            c.log("train_memory", f"14B yaml, full width, {layers} of 40 layers, one "
                  f"step {how}: out of device memory ({str(e).splitlines()[0]}); "
                  f"card {card}")
"""


def train_memory(dirs: list) -> int:
    """The --train-memory mode (module docstring): each checkout in turn."""
    for d in dirs:
        log("train_memory", f"checkout {d}")
        rc = subprocess.run([sys.executable, "-c", TRAIN_MEMORY_CHILD,
                             str(TRAIN_MEMORY_MLLM_LAYERS)], cwd=d).returncode
        if rc != 0:
            raise SystemExit(f"train_memory: {d} exited {rc}")
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--train-memory"]:
        return train_memory(sys.argv[2:] or ["."])
    t_start = time.perf_counter()
    phase_device()
    card = card_line()
    phase_build()
    results = {"decode_attention": phase_decode_attention()}
    from bitdance_tpu_torch.io.random_init import build_random_bundle

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = build_random_bundle("cuda", seed=0, lm_head=True, encoder=True)
    torch.cuda.synchronize()
    log("bundle", f"BitDance-14B-64x random bf16 bundle (with lm_head and VQ encoder) "
        f"on the card in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    results["sampler"] = phase_sampler(bundle)
    torch.cuda.reset_peak_memory_stats()
    launches = phase_e2e(bundle, card)
    log("e2e", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        "(with lm_head and VQ encoder)")
    first_image = [r.pop("image") for r in launches["requests"]][0]
    inter = phase_interleaved(bundle, card, first_image)
    # T2I serving loads neither the text head nor the encoder: the later T2I
    # phases (int8 / int4 weights and memory) measure T2I's own weights
    del bundle.llm.lm_head, bundle.ae.encoder
    gc.collect()
    torch.cuda.empty_cache()
    phase_profile(bundle)
    for name, n in phase_eval_serve(bundle, card)["launches"].items():
        launches[name] += n
    bf16_tokens = [r.pop("tokens") for r in launches.pop("requests")]
    results.update(phase_quant_kernels(bundle))
    launches.update(phase_e2e_quant(bundle, card, bf16_tokens)["launches"])
    del bundle                              # the training phases need the room
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"T2I bundles freed: {torch.cuda.memory_allocated() / 2**30:.2f} "
        "GiB allocated")

    results.update(phase_flash_attention())
    train = phase_train(card)
    launches.update(train["launches"])
    gc.collect()                            # the training state is gone
    torch.cuda.empty_cache()

    h1x, b16x = build_imagenet_samplers()
    results.update(phase_imagenet_kernels(h1x, b16x))
    h = phase_imagenet_h1x(h1x, card)
    b = phase_imagenet_b16x(b16x, card)
    net = phase_fused_net(h1x, b16x, {"h1x": h.pop("unguided_run"),
                                      "b16x": b.pop("unguided_run")}, card)
    results["fused_net"] = net["h1x_8"]
    launches["fused_diffnet_forward"] = net["launches"]
    quant = phase_imagenet_int8(h1x, b16x, {"h1x": h.pop("guided_tokens"),
                                            "b16x": b.pop("guided_tokens")}, card)
    for key, r in quant["results"].items():
        results[f"fused_em_sample_{key}"] = r
    for key, n in quant["launches"].items():
        launches[f"fused_em_sample_{key}"] = n
    launches.update({
        "fused_em_sample_mlp": h["guided"]["fused_em_sample"],
        "fused_em_sample_b16x": b["guided"]["fused_em_sample"],
        "fused_mlp_block": (h["unguided"]["fused_mlp_block"]
                            + b["unguided"]["fused_mlp_block"]),
        "fused_attn_block": b["unguided"]["fused_attn_block"]})
    del h1x, b16x                           # packed training needs the room
    gc.collect()
    torch.cuda.empty_cache()

    results.update(phase_flash_sparse())
    mllm = phase_mllm(card)
    launches.update(mllm["launches"])
    del mllm
    gc.collect()                            # the 14B training state is gone
    torch.cuda.empty_cache()
    for name, n in phase_parallel(card)["launches"].items():
        launches[name] = launches.get(name, 0) + n
    tp = phase_tp(card)
    results["decode_attention"].setdefault("shapes", {})["tp2_20x4"] = tp["decode"]
    results["head_gemm_tp"] = tp["head_gemm"]
    launches["decode_attention"] += tp["launches"]["decode_attention"]
    launches["head_gemm_tp"] = tp["launches"]["head_gemm_tp"]
    launches["fused_attn_block"] += tp["launches"]["fused_attn_block"]
    results.update(phase_encode_kernel())
    launches["fused_encode_tail"] = phase_tokenizer(card)["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    launches["fused_encode_tail"] += phase_tokenizer_family(card)["launches"]
    launches["fused_attn_block"] += phase_head_leftovers(card)["launches"]
    gc.collect()
    torch.cuda.empty_cache()
    # the training commands' launches join each kernel's count (B-1x's head
    # is the MlpEncoder family of the whole sampler)
    for name, n in phase_train_cli(card)["launches"].items():
        key = "fused_em_sample_mlp" if name == "fused_em_sample" else name
        launches[key] = launches.get(key, 0) + n
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in phase_train_proof(card)["launches"].items():
        launches[name] += n
    from bitdance_tpu_torch.ops import int4

    int4._CALLS.clear()
    phase_release(card)
    log("release", f"int4_matmul's (M, N, K) on the release phase's loads: "
        f"{w4a8_shapes_seen() or 'none (its quantized load serves the LLM in int8)'}")

    # the interleaved phase's launches join each kernel's count; its checks
    # of #1, #14 and #15 at that path's shapes go under "shapes"
    for name, n in inter["launches"].items():
        launches[name] += n
    for key, shape, rec in (("decode_attention", "b1_interleaved", inter["decode"]),
                            ("fused_mlp_block", "14b_64x5120", inter["mlp"]),
                            ("fused_attn_block", "14b_1x64x5120", inter["attn"])):
        results[key].setdefault("shapes", {})[shape] = rec

    records = []
    meta = {
        "decode_attention": ("decode_attention", "bitdance_tpu_torch/csrc/decode_attention.cu",
                             "bitdance_tpu/ops/decode_attention.py:121"),
        "fused_em_sample": ("sampler", "bitdance_tpu_torch/csrc/fused_head.cu",
                            "bitdance_tpu/ops/fused_head.py:1076"),
        "flash_fwd": ("flash_fwd", "bitdance_tpu_torch/csrc/flash_attention.cu",
                      "bitdance_tpu/ops/attention.py:285"),
        "flash_bwd_dq": ("flash_bwd_dq", "bitdance_tpu_torch/csrc/flash_attention.cu",
                         "bitdance_tpu/ops/attention.py:456"),
        "flash_bwd_dkv": ("flash_bwd_dkv", "bitdance_tpu_torch/csrc/flash_attention.cu",
                          "bitdance_tpu/ops/attention.py:474"),
        # the MlpEncoder family and the unbounded TransEncoder of the same
        # kernel: the JAX package takes its per-block kernel #3 for both
        # heads (177 MB and 60 MB of block weights, over its 48 MB resident
        # limit)
        "fused_em_sample_mlp": ("fused_em_sample_mlp",
                                "bitdance_tpu_torch/csrc/fused_head.cu",
                                "bitdance_tpu/ops/fused_head.py:1234"),
        "fused_em_sample_b16x": ("fused_em_sample_b16x",
                                 "bitdance_tpu_torch/csrc/fused_head.cu",
                                 "bitdance_tpu/ops/fused_head.py:1234"),
        "fused_mlp_block": ("fused_mlp_block", "bitdance_tpu_torch/csrc/fused_block.cu",
                            "bitdance_tpu/ops/fused_block.py:95"),
        "fused_attn_block": ("fused_attn_block", "bitdance_tpu_torch/csrc/fused_block.cu",
                             "bitdance_tpu/ops/fused_block.py:183"),
        "w4a8_matmul": ("w4a8_matmul", "bitdance_tpu_torch/csrc/w4a8.cu",
                        "bitdance_tpu/ops/int4.py:121"),
        "decode_attention_fusedkv": ("decode_attention_fusedkv",
                                     "bitdance_tpu_torch/csrc/decode_attention.cu",
                                     "bitdance_tpu/ops/decode_attention.py:340"),
        # the quant mode of kernel #2 (stage_quant / stage_dot)
        "fused_em_sample_int8": ("fused_em_sample_int8",
                                 "bitdance_tpu_torch/csrc/fused_head.cu",
                                 "bitdance_tpu/ops/fused_head.py:1076"),
        "fused_em_sample_int4": ("fused_em_sample_int4",
                                 "bitdance_tpu_torch/csrc/fused_head.cu",
                                 "bitdance_tpu/ops/fused_head.py:1076"),
        "flash_fwd_sparse": ("flash_fwd_sparse", "bitdance_tpu_torch/csrc/flash_attention.cu",
                             "bitdance_tpu/ops/attention.py:767"),
        "flash_bwd_dq_sparse": ("flash_bwd_dq_sparse",
                                "bitdance_tpu_torch/csrc/flash_attention.cu",
                                "bitdance_tpu/ops/attention.py:964"),
        "flash_bwd_dkv_sparse": ("flash_bwd_dkv_sparse",
                                 "bitdance_tpu_torch/csrc/flash_attention.cu",
                                 "bitdance_tpu/ops/attention.py:1013"),
        "fused_encode_tail": ("fused_encode_tail", "bitdance_tpu_torch/csrc/fused_encode.cu",
                              "bitdance_tpu/ops/fused_encode.py:83"),
        # the quant modes of #3/#4 (the round route's quant_round_block):
        # H-1x's int8 stack (88.9 MB of block weights) goes to the JAX
        # package's per-block #3, B-16x's int8 and int4 and H-1x's int4
        # stacks (under its 48 MB resident limit) to #4
        "fused_em_sample_h1x_int8": ("fused_em_sample_h1x_int8",
                                     "bitdance_tpu_torch/csrc/fused_head.cu",
                                     "bitdance_tpu/ops/fused_head.py:1234"),
        "fused_em_sample_b16x_int8": ("fused_em_sample_b16x_int8",
                                      "bitdance_tpu_torch/csrc/fused_head.cu",
                                      "bitdance_tpu/ops/fused_head.py:1294"),
        "fused_em_sample_b16x_int4": ("fused_em_sample_b16x_int4",
                                      "bitdance_tpu_torch/csrc/fused_head.cu",
                                      "bitdance_tpu/ops/fused_head.py:1294"),
        # the H-1x unguided rows (8 x C 1280); the B-16x shape's numbers are
        # in the fused_net phase's log
        "fused_diffnet_forward": ("fused_net", "bitdance_tpu_torch/csrc/fused_net.cu",
                                  "bitdance_tpu/ops/fused_head.py:426"),
        # the head GEMM alone, as the tensor-parallel sampler launches it
        # (the tp phase): a rank's shares of the block products at tp 2,
        # with the fp32 sums all-reduced outside. The JAX package runs a
        # head-major stack on plain XLA, no Pallas kernel
        "head_gemm_tp": ("head_gemm_tp", "bitdance_tpu_torch/csrc/head_gemm.cuh",
                         "bitdance_tpu/ops/fused_head.py:1309 (_block_body_xla: "
                         "plain XLA, no Pallas kernel)"),
    }
    for name, (key, src, repl) in meta.items():
        r = results[key]
        if launches[name] < 1:
            raise SystemExit(f"{name} was not launched by the main path")
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": repl, "launches": launches[name],
                        **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms",
                                             "bound_ms", "bound_by", "library_ms")},
                        # #1 / #6 and the flash kernels also carry their
                        # device-only time (#7-#9: the host's a call, SDPA's
                        # device-only); #16 its cold-L2 times, the GEMM
                        # launch alone and its splits; #3/#4 their times
                        # without PDL, launches per net call and each head
                        # GEMM product's check and cold-L2 times
                        **{k: r[k] for k in ("device_ms", "host_us", "library_device_ms",
                                             "cold_ms", "cold_device_ms", "library_cold_ms",
                                             "gemm_ms",
                                             "splits", "no_pdl_ms", "no_pdl_device_ms",
                                             "pdl_gemms_ms", "pdl_gemms_device_ms",
                                             "launches_per_net_call", "launches_per_call",
                                             "products", "shapes", "sign_agreement",
                                             "max_rel_err",
                                             "batch_s", "peak_gib", "bf16_agreement")
                           if k in r}})
    log("done", f"all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

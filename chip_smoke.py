"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure makes the script exit non-zero without the
result line:

1. print the card, its power limit, and the torch / CUDA / nvcc versions;
2. build every CUDA kernel of the main path from the sources in this
   checkout (one nvcc per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version on the card at the
   shapes its path gives it, every variant (attention cores f32/bf16/int8 x
   static / per-row activations x calibrated softmax offset on/off; MLP
   static / per-row, at the flagship's and the per-point path's widths; the
   split-path projections at both batch sizes, a ragged row count, D=1024
   and mixed dtypes; flash attention with no bias,
   key bias, full bias, fully masked rows, Lq != Lk off the tiles,
   float32);
4. drive each path through the user-facing entry points, on seeded random
   weights with a non-zero output head, DummyTextEncoder(256, 32), DDPM
   squaredcos_cap_v2 with 25 steps, CFG 7.5 with guidance truncation at 800:
   - flagship t2pc serving (pc_d48w1024, 2048 points at patch 16, int8 with
     calibrated static scales, bf16 attention core, batch 128);
   - per-point float serving (path A: build_pipeline's defaults, pc_d8w768,
     2048 points at patch 1 = 2048 tokens, bf16, batch 8): flash attention;
   - per-point int8 serving (path B: the same model with quantize=True,
     calibrated, batch 8): the split path's two kernels and the MLP kernel;
   for each, set the launch counts to 0, run one call, read the counts,
   check the output, and hold it against the same call with the plain
   versions substituted;
5. time each kernel per launch at both batch sizes of its path, its plain
   version, one library call where one computes the same function, and each
   pipeline's samples/s (CUDA events and torch.cuda.synchronize);
6. profile one call of each path (torch.profiler): device time by kernel and
   the device's idle share.

The NOVA text-to-image slice adds, in their places in that order:

3d. its kernels against their plain versions on the card at the t2i path's
    shapes: fused_int8_mlp_postln (static / per row, 8 x 288, 8 x 300
    (ragged), 8 x 768 and 8 x 1280 rows, f32 and bf16 residual streams), fused_int8_diffusion_block
    (static / per row, 200 rows and a ragged count), flash_attention_static
    (bf16 and int8 score cores, no bias / a visibility bias with -inf keys
    and a fully masked sample, L = 288, 768, 1280), int8_linear (the
    ViT's qkv and out projections) and flash_attention at the t2i float
    path's (8, 16, 1280, 64) with and without its visibility bias; also the
    widened row pass (the split path's kernels at D=1536);
4d. NOVA t2i int8 serving as bench.py --mode t2i: NOVATransformer(vit_d16w1024,
    vit_d32w1024, mlp_d6w1024) at full width and depth, bf16 weights,
    flow-matching Euler, DummyTextEncoder(256, 32), calibrated (16 AR steps,
    margin 1.05), then one call at 64 AR x 25 diffusion steps, CFG 5.0 with
    no truncation, batch 4, latent output: exact launch counts (2032
    flash_attention_static, 2032 fused_int8_mlp_postln, 9450
    fused_int8_diffusion_block, 4064 int8_linear, 0 of every other TPU
    kernel), finite latents with a spread; a call at 16 AR steps held
    against the same call with the plain versions (gate 2 x floor + 1e-3;
    floor: the kernel path against itself with the AR noise moved by 1e-6);
    one encoder pass + one head eval held against plain (relative, 2 x floor
    + 1e-3);
4e. the same model with quantize=False: the dispatcher's flash_attention
    launches (1344 by its 1024-key rule) and the one-step check against
    plain (the whole float call is chaotic on random weights);
5c. times of the t2i kernels (the MLP and the static attention at L = 1280
    and 768, the diffusion block at 200 rows), their plain versions, bounds,
    F.scaled_dot_product_attention beside the static attention, and both
    t2i paths' samples/s (p50 of 2 calls since row 1's hd-96 slice, batch 4);
6.  (in the profiles phase) one profiled t2i int8 call (16 AR steps since
    row 1's hd-96 slice).

The NOVA t2i training slice adds:

3e. the flash backward kernels against their plain version at the training
    shape (8, 16, 1280, 64), bf16 (prep, the one-pass dkvq kernel on wgmma
    and TMA, cast) and f32 (prep, the one-pass register-tiled SIMT kernel
    flash_attention_bwd_f32): no bias; a
    key bias with -inf keys and a fully masked sample (its gradients exactly
    0); a full bias; a ragged Lq != Lk; the prep and cast kernels exactly
    equal to their plain versions; two backward runs on the same tensors,
    bf16 and f32: dk and dv bitwise equal (a gate), max |dq1 - dq2| printed
    (the f32 reduce-adds of the dQ parts run in no fixed order);
4f. t2i training as bench.py --mode train --train-arch t2i:
    NOVATransformer(vit_d16w1024, vit_d32w1024, mlp_d6w1024) at full width
    and depth, seeded init_weights (zero AdaLN, as the JAX initialisers),
    f32 master weights, bf16 compute, remat on, AdamW (constant lr 1e-4,
    wd 0.02, betas 0.9 / 0.95) with the T2I freeze rules, batch 8 in the
    records layout: exact launches in one step of NOVATrainT2IPipeline.train
    (16 each of flash_attention_bwd_prep, flash_attention_bwd_dkvq,
    flash_attention_bwd_dq_cast, 32 flash_attention: the decoder half's 16
    layers at 1280 keys, their forward run again by remat; 0 of every other
    kernel) and in the f32 step's loss and gradients (16 prep, 16
    flash_attention_bwd_f32, 32 flash_attention), finite
    loss and gradients, the
    backward kernels on the tensors of every one of the step's 16 backward
    calls against the plain backward (flash bf16 tolerance), the f32 step
    through the kernels against the f32 plain step (relative L2 of the whole
    gradient, gate 2 x floor + 1e-6; floor: the f32 plain step against
    itself with the latents moved by 1e-6), and the loss of one fixed batch
    with fixed draws falling over 10 steps; the bf16 step against the plain
    bf16 step is printed as a reading with no gate (the plain bf16 step is
    over 1 in relative L2 from the plain f32 step on random weights, so a
    tolerance built on that floor cannot fail);
5d. times of the bf16 backward's kernels (prep, dkvq, cast) and of the f32
    route's one-pass kernel, their plain version, the SDPA backward (from a
    graph built once) beside the port's whole backward through autograd and
    the kernels' sum, the bounds, and the whole backward's joint bound (10
    BH Lq Lk d FLOPs) with the dkvq kernel's ptxas registers and spills;
    the training step (p50 of 5 after 2 warm-ups),
    samples/s, peak memory, the step's FLOPs (FlopCounterMode for the
    library ops, the flash kernels' counted from their shapes) and TFLOP/s;
6.  (in the profiles phase) one profiled training step.

The redesign of the forward kernels for Hopper (flash_attention's bf16
route and flash_attention_static on csrc/flash_fwd.cuh: wgmma and TMA)
keeps phases 3c and 3d as they were and adds to the timing phases:

5b. flash_attention at path A's shapes and 5c flash_attention_static (bf16
    core at L = 1280 and 768, and the int8 core at 1280) also timed from a
    CUDA graph of 20 launches captured once, beside the event time, and
    SDPA the same way; the ptxas registers, spills and wgmma notes of each
    instance of the forward kernel (5b: no bias, key bias, full bias; 5c:
    bf16 and int8 cores with and without a key bias) and its SASS, which
    must hold wgmma (HGMMA, IGMMA for the int8 core) and TMA loads
    (UTMALDG) and no mma.sync (the phase fails otherwise);
5d. the forward at the training shape graph-timed too.

The redesign of fused_ln_int8_mlp (its two products on the wgmma s8 + TMA
GEMM of csrc/int8_wgmma.cuh) and of fused_int8_diffusion_block (one
persistent launch with grid barriers) keeps phases 3, 3b and 3d (3d adds
the diffusion block at 20 rows, too few for two row parts, and with f32 x
and zc) and adds:

5.  fused_ln_int8_mlp also timed from a CUDA graph, beside torch._int_mm's
    time for its two products at the same shapes (a yardstick of the GEMM
    part only; the port never calls it), and the ptxas report and SASS of
    each instance of its GEMM, which must hold s8 wgmma (IGMMA) and TMA
    loads (UTMALDG), no mma.sync (IMMA), no spills and no C7514 note (the
    phase fails otherwise); 5b the same at path B's width;
5c. fused_int8_mlp_postln, fused_int8_diffusion_block and int8_linear also
    timed from a CUDA graph;
6.  (first in the profiles phase) the device kernels of 10 calls of
    fused_int8_diffusion_block, which must be 10.

The redesign of fused_attention_block (its bf16 core's QKV product and
attention in one wgmma + TMA kernel, the other products on the wgmma GEMM)
and of fused_int8_mlp_postln (fc1 on the wgmma GEMM, fc2 with the post-LN
and the residual in its epilogue, over thread-block clusters of D / 256
blocks) keeps phases 3 and 3d and widens them: phase 3 holds every
attention variant at the 1x batch too, phase 3d the post-LN MLP at 8 x 768
and a ragged 8 x 300 rows too. It adds:

5.  fused_attention_block also timed from a CUDA graph, with its byte floor
    (what the design moves through device memory) beside the first
    design's, which also wrote and read the bf16 qkv rows; the ptxas and
    SASS gate over the three int8 libraries (rows 2, 1 and 5): every wgmma
    instance issues IGMMA and UTMALDG, row 1's core HGMMA too, with no
    spills and no C7514 note, and no function of them issues mma.sync or
    is the mma.sync GEMM;
5c. fused_int8_mlp_postln with its byte floor beside the first design's
    (which also wrote and read the f32 product) and its fc2 plan's waves;
6.  (first in the profiles phase) the device kernels of 10 static calls of
    fused_attention_block (the LN pass, the QKV + core kernel, the
    out-projection) and of fused_int8_mlp_postln (the quant pass, fc1, fc2
    + post-LN), which must be 30 each.

The move of int8_linear and fused_ln_int8_matmul off the mma.sync GEMM
onto the wgmma GEMM (a bf16 output stored by TMA from shared memory; the
plan taking 128 x 128 tiles where they fill the last wave of a few waves
better) and the row pass without LayerNorm as one warp a row keeps the
phases and widens them:

3d. int8_linear at every (M, N) of the t2i int8 call: M = 8 x 288 (the
    video encoder), 8 x (256 + 128, 256, 512 and 1024 tokens) (the image
    encoder's bucket phases and its decoder), qkv (f32 x) and the
    out-projection (bf16 x);
5.  the ptxas and SASS gate also over int8_linear's and
    fused_ln_int8_matmul's libraries (both tile widths, the bf16 output
    stored by TMA or an f32 one by the threads): IGMMA and UTMALDG, UTMASTG
    in the TMA-store instances, no IMMA, no mma.sync GEMM, no spills, no
    C7514;
5b. fused_ln_int8_matmul and int8_matmul_residual also timed from a CUDA
    graph, and torch._int_mm on codes of fused_ln_int8_matmul's product
    (a yardstick of its GEMM alone);
5c. int8_linear at the out-projection's shape too (8 x 1280 and 8 x 768
    rows, 1024 -> 1024, bf16 x), both with torch._int_mm's time for the
    product alone;
6.  (first in the profiles phase) the device kernels of 10 calls of
    int8_linear and of fused_ln_int8_matmul, which must be 20 each (the
    row pass and the wgmma GEMM).

The move of int8_matmul_residual (row 4) off the mma.sync GEMM onto the
wgmma GEMM (the residual epilogue rows 1 and 2 run, a bf16 residual loaded
into shared memory and the sum stored by TMA, tiles 128 x 256 or 128 x 128
as fused_block.store_plan chooses; the first design's mma.sync GEMM is
gone) and the f32 flash backward as one register-tiled SIMT pass
(flash_attention_bwd_f32 in place of the dK/dV and dQ kernels) keep the
phases and widen them:

3e. the f32 route's dk and dv of two runs bitwise equal too (a gate), max
    |dq1 - dq2| printed;
4f. the f32 step's exact launches: 16 prep, 16 flash_attention_bwd_f32, 32
    flash_attention;
5.  the ptxas and SASS gate also over int8_matmul_residual's library (both
    tile widths, a bf16 residual loaded and the sum stored by TMA or an f32
    one by the threads: IGMMA, UTMALDG, UTMASTG in the TMA instances, no
    IMMA, no mma.sync GEMM, no spills, no C7514);
5b. int8_matmul_residual with the plan's tile width and waves and
    torch._int_mm on codes of its product (a yardstick of its GEMM alone);
5d. the f32 kernel timed by events, the f32 route's launches from a CUDA
    graph, beside the whole f32 backward through autograd, SDPA's f32
    backward and its bound (10 BH Lq Lk d FLOPs at 67 TFLOP/s), with both
    instances' ptxas registers and spills; the f32 forward at (8, 16, 1280, 64) by events and from a
    graph, beside SDPA's f32 forward and its bound (4 BH Lq Lk d);
6.  (first in the profiles phase) the device kernels of 10 calls of
    int8_matmul_residual, which must be 20 (the row pass and the wgmma
    GEMM).

The t2pc training slice (composite loss, the pc model's training mode,
gradient tools, checkpoints, data, evaluator) writes no kernel; its
default step runs the plain attention core (attention dropout 0.1, as the
JAX model sends live dropout to flax's core), its dropout-0 step the f32
flash forward and backward. It adds, run after phase 5d so that its models
stay out of the earlier phases' peak-memory readings:

4g. t2pc training at nova_pointcloud_tpu_torch.scripts.train_pointcloud's
    defaults: pc_d8w768, 1024 points at patch 1, f32 (TF32 off), remat,
    dropout 0.1, batch 16 of make_synthetic_clouds normalized by a fitted
    GlobalNormalizer and clipped to [-1, 1], DummyTextEncoder(256, 16)
    prompts with cond-dropout 0.1, the composite loss (Sinkhorn 30
    iterations at eps 0.05, 16 subsets), per_layer_clip(50, output_proj
    x0.5, time_ x0.3) -> adaptive_lr_on_spike(50) -> AdamW (cosine 1e-4,
    warmup 200, floor 1e-5, wd 0.01 on every parameter), EMA 0.99 every 10
    steps. First the script's main itself (2 steps, validation, a
    sampled-CD eval of 4 shapes at 5 steps; exact launches: 80
    flash_attention of the bf16 eval, none in training). Gates: (a) 20
    steps of one fixed batch with fixed draws: every metric finite,
    nonfinite_loss 0, no kernel launched, the loss falling; (b) at
    dropout 0 one step's gradient through attn_impl="auto" (exact
    launches: 16 flash_attention f32, 8 flash_attention_bwd_prep, 8
    flash_attention_bwd_f32 at (16, 12, 1024, 64)) against "xla", relative
    L2 within 2 x floor + 1e-6 (floor: the "xla" step with the noise moved
    by 1e-6); (c) a checkpoint saved after step 19, a fresh trainer resumed
    from it: step 20 (an EMA update) bitwise the uninterrupted trainer's
    (parameters, Adam moments, the adaptive multiplier, EMA); (d)
    PointCloudEvaluator over the bf16 generation pipeline, 4 prompts at
    1024 points, 25 steps, guidance (1.0, 3.0): finite CD, density-weighted
    CD and EMD (400 flash_attention);
5e. the default step's p50 of 5 after 2 warm-ups, samples/s and its peak
    memory above what was allocated before it; the loss terms' time
    (chamfer, Sinkhorn, AR, forward and backward, CUDA events) and their
    share of the step; the same step at dropout 0 and its flash kernels'
    share (the f32 forward and backward timed at (16, 12, 1024, 64) beside
    their bounds);
6.  (in the profiles phase) one profiled step of each, with the device's
    idle share.

The point-cloud AR modes (the masked-AR model and its sampler, the
dynamic-partition refinement mode, the masked-AR training script) write
no kernel; their int8 path runs rows 5 and 6 and int8_linear at D = 768,
where no earlier path ran them. They add:

3f. those three kernels against their plain versions at the masked-AR
    shapes (after 3e): fused_int8_mlp_postln at 2 x 32 x (32 + 128) =
    10240 rows of 768 -> 3072 -> 768 (fc2 over clusters of 3 blocks) and
    a ragged 7 x 149, fused_int8_diffusion_block at the head's 2 x 32 x 13
    = 832 rows (a 96-block grid), 77 and 20 rows, int8_linear at K = 768
    (768 -> 2304 with an f32 x, 768 -> 768 with a bf16 x) at 10240 and
    1043 rows; static and per-row (the path's route), f32 and bf16
    residual streams; phase 3d's tolerances;

and, after phase 5e, so that their models stay out of the earlier
phases' peak-memory readings:

4h. masked-AR t2pc serving at the model class's defaults:
    NOVAPointCloudARTransformer(pc_d32w768, 2048 points at patch 16, text
    32 x 256), DummyTextEncoder(256, 32), bf16, DDPM squaredcos_cap_v2 at
    16 AR x 25 steps, CFG 5.0, batch 32. int8 (quantize=True, per-row: the
    pipeline never calibrates): exact launches (512
    fused_int8_mlp_postln, 1024 int8_linear, 2400
    fused_int8_diffusion_block, 0 of every other kernel), a finite cloud
    in [-1, 1] with a spread; a call at 4 AR steps against the same call
    with the plain versions (2 x floor + 1e-3; floor: the AR noise moved
    by 1e-6); one encoder pass + one head eval against plain. The float
    twin: no launch;
4i. the refinement mode: phase 4's flagship pipeline with
    use_autoregressive=True, num_subsets=16 and ARRefiner() at its
    defaults (non-zero head): 1200 + 1200 launches of rows 1 and 2, none
    from the refiner, a finite cloud, the call's peak memory, the first
    subset step finite, 4 clouds' refinement on the card against the same
    refiner on the CPU (mean |diff| <= 1e-4 mean |refined|);
4j. masked-AR training: scripts/train_eval_pc_ar.py's main at its
    defaults cut to 2 steps (--stats: a GlobalNormalizer fitted on
    make_synthetic_clouds; --stats and --out under build/pc_ar), no
    launch, finite CD / EMD over the guidance sweep; then 20 steps of one
    fixed batch with fixed draws on the script's model and optimizer:
    every metric finite, the loss falling, no launch;
5f. rows 5, 6 and int8_linear per launch at the AR shapes (per row),
    their plain versions and bounds; SDPA's f32 forward and backward at
    the t2pc step's (16, 12, 1024, 64) beside the f32 route's; p50 samples/s of the masked-AR int8
    and float calls, the refinement call and the flagship without it (the
    float and refinement calls over 2 calls since row 1's hd-96 slice); the
    masked-AR training step's p50 and peak memory;
6.  (in the profiles phase) one profiled masked-AR int8 call (8 AR steps
    since row 1's hd-96 slice).

NOVA text-to-video serving (RoPE, the motion tokens, the KV-cached frame
decode, the AdaLN mixer, the latents= prefill) writes no kernel; its int8
path runs rows 5, 6, 8 and int8_linear at shapes no earlier path gives
them (batch 1 x CFG 2: 540 to 1800 keys or rows a sample, most not a
multiple of 64), its float twin flash_attention with a key bias. It adds:

3g. those kernels against their plain versions at the t2v shapes (after
    3f; check_t2v_kernels), phase 3d's tolerances;

and, after phase 5f:

4k. t2v int8 serving as bench.py --mode t2v: NOVATransformer(vit_d16w1024,
    vit_d32w1024, mlp_d6w1024) with RoPE and mixer rank 24, 30 x 48 image
    and 15 x 24 video patches, DummyTextEncoder(2560, 256), bf16, flow
    shift 5, calibrated (16 AR steps, max_latent_length=2, margin 1.05),
    one call of 9 frames x 64 AR x 25 steps, CFG 5.0, batch 1: exact
    launches (derived from the model: 18144 flash_attention_static, 18288
    fused_int8_mlp_postln, 85050 fused_int8_diffusion_block, 36576
    int8_linear, 0 of every other kernel), finite latents (1, 9, 60, 96, 4)
    with a spread; 2 frames x 8 AR steps against plain (2 x floor + 1e-3);
    the step check (frames 0 and 1 through the caches, the mixer, one
    image-encoder pass, one head eval against plain); an i2v call whose
    frame 0 is bitwise the given latents;
4l. the float twin at 2 frames x 64 AR steps: 1552 flash_attention
    launches a frame (the dispatcher's rule), the step check;
5g. the kernels at each t2v shape, their plain versions, bounds and SDPA's
    time; one more full int8 call (videos/s, ms per frame, peak memory) and
    the float twin's s per frame;
6.  (in the profiles phase) one profiled int8 call of 2 frames x 16 AR
    steps.

The VAEs and the decode (AutoencoderKL, AutoencoderKLOpenSora,
AutoencoderKLCogVideoX, AutoencoderKLLTXVideo, the image processor, the i2v
image encode) write no kernel and launch none: convolutions, GroupNorm and
resizes are PyTorch's, the attention plain. They add, after phase 4l:

4m. each VAE class at a small size in f32 (VAE_SMALL: the 3D VAEs' widths
    cut, inputs cropped, each tiling two windows each way): encode and
    decode on the card against the CPU with the same seeded weights, max
    |diff| <= 1e-3 x max |CPU|; AutoencoderKL's and OpenSora's decode at
    their default widths in bf16 against their own f32 decode on the card
    (mean / max relative 3e-2 / 6e-2); 0 launches of the repo's kernels;
4n. bench.py --e2e's calls: the calibrated int8 t2i pipeline of 4d with
    AutoencoderKL(latent_channels=4) (default widths, bf16), one call of
    64 AR x 25 steps at batch 4 with output_type="np" -> (4, 512, 512, 3)
    uint8; the int8 t2v pipeline of 4k with AutoencoderKLOpenSora, one
    9-frame call -> (1, 33, 480, 768, 3) uint8 from exactly 2 decode
    windows; each call's launches equal its latent call's, the pixels are
    not constant; encode_image of a seeded 480 x 768 uint8 image -> (1,
    60, 96, 4) latents, returned bitwise as frame 0 by a prefilled call;
5g. (changed) no extra full int8 call: the latent call's time is 4k's,
    the e2e call's (and its peak memory) 4n's;
5h. the decodes by CUDA events (p50 of 3): t2i a batch of 4, t2v a video
    and one window; each one's peak memory above what is held, FLOPs
    (FlopCounterMode) and TFLOP/s against 989 bf16 dense, its share of the
    e2e call; encode_image's ms;
6.  (last in the profiles phase) one profiled t2v decode, with the share
    of its device time in channels-last convolution kernels and in layout
    conversions.

The Phi text encoder, c2i serving and reference-checkpoint loading write no
kernel. They add, after phase 5h, each freeing what it built (their time
together is printed beside its budget of 120 s):

4o. the Phi-2 prompt encoder at full size (PhiConfig(): 32 layers, 2560
    wide, 32 heads, 51200 tokens), f32 with TF32 off, seeded: one encode of
    4 x 256 token ids (a full, a half-padded, an all-padding and a short
    prompt): finite output; the all-padding row against its recomputation
    without an attention core (PHI_PAD_TOL); ms per encode, TFLOP/s and
    peak memory; its first 2 layers at full width on the card against the
    CPU (PHI_CPU_TOL);
4p. the released NOVA-0.6B 1024px config (nova_d48w1024_sdxl1024.yaml)
    through from_pretrained over a reference checkpoint directory written
    and removed by the phase (bf16 transformer in 2 shards, FlowMatch, the
    SDXL AutoencoderKL, Phi at 2 layers, no tokenizer/ so no text
    encoder): load time and rate; flash_attention at the call's (2, 16,
    5120, 64) against its plain version, timed beside SDPA and its bound;
    one prompt with 4o's embeddings, 64 AR x 25 steps, CFG 5.0 ->
    (1, 1024, 1024, 3) uint8, the flash launches exactly the dispatcher's
    count for the model, the transformer's and the VAE's weights bitwise
    those written, the pixels bitwise those of build_pipeline's pipeline on
    the written weights with the same VAE and generator;
4q. NOVAC2IPipeline over bench.py --mode t2i's model with 1000 classes and
    no text, calibrated as 4d, one call of 4 labels at 64 x 25 steps, CFG
    5.0 against the null class, decoded by 4n's AutoencoderKL: rows 5, 6,
    8 and int8_linear exactly the t2i int8 call's counts, samples/s, and
    4d's one-step check against plain.

Head dim 96 (the *w1536 models: flash_attention's bf16 forward and
backward and flash_attention_static's bf16 core at head dim 96, the
backward as one pass, flash_attention_bwd_dkvq96, between the prep and
cast kernels) adds to 3c-3e and, after 4q, three phases (the additions'
time together is printed beside its budget of 180 s):

3c. the forward at (2, 16, 5120, 96) and (2, 16, 1280, 96) with no bias, a
    key bias and a full bias, at Lq 1000 / Lk 1531 with a key bias and a
    fully masked sample, against its plain version; both shapes timed
    (events and a graph) beside SDPA and the bound; 5b prints and gates the
    ptxas / SASS of its three hd-96 instances (and 5c the static's two);
3d. the NOVA-1.4B int8 call's shapes: the static attention's bf16 core at
    head dim 96 over 1280, 1536, 3072 and 5120 keys with and without a
    visibility bias, rows 5 and 6 at D = 1536 (fc2 over clusters of 6, the
    diffusion block at 2 column groups a block) and int8_linear at K =
    1536, against their plain versions; the static kernel timed at (2, 16,
    5120, 96);
3e. the hd-96 backward (prep, dkvq96, cast) at the 1.4B training step's
    attentions (5120 keys; 1024 + 1229 with a visibility bias and a fully
    masked sample; 32 + 1024), a full bias and a ragged Lq != Lk, against
    the plain backward; prep and cast exactly their plain versions; dq, dk
    and dv of two runs bitwise equal (the dQ sums take a fixed order); a
    backward at (1, 16, 32768, 96), more key tiles than the card holds
    blocks, finishing within its own time limit, finite and repeatable;
    each kernel timed at (2, 16, 5120, 96) by events and from a graph
    beside the plain backward, SDPA's backward and the bounds; dkvq96's
    ptxas / SASS (wgmma, TMA loads and reduce-adds, no spill) as gates;
4r. the released NOVA-1.4B 1024px config (nova_d48w1536_sdxl1024.yaml)
    through from_pretrained over a reference directory written as 4p's:
    the weights loaded bitwise those written, load time and rate; one
    prompt with 4o's embeddings at 64 AR x 25 steps, CFG 5.0 -> (1, 1024,
    1024, 3) uint8, exactly the dispatcher's 2064 flash_attention launches
    at head dim 96, time and peak memory;
4s. the same weights with quantize=True, attn_core="bf16", calibrated as
    4d, one prompt's call: rows 8 / 5 / 6 / int8_linear exactly the
    model's counts (2064 / 2064 / 9600 / 4128), samples/s, peak memory,
    4d's one-step check against plain;
4t. bench.py --mode train --train-arch t2i-1.4b's step (batch 2, f32
    master, bf16 compute, remat, AdamW 1e-4 / 0.02 / 0.9, 0.95): exactly
    the derived launches (48 layers: 96 forward, 48 each of prep, dkvq96
    and cast), every backward call of a step against the plain backward on its
    own tensors (the gate), the step's gradients against the plain core
    as a reading, p50 of 3 timed steps, samples/s, peak memory.

Row 1 (fused_attention_block) at head dim 96 and at every T the fused rule
admits (the one kernel at T = 128 templated on the head dim; the split
route at any other T: the QKV product to a bf16 qkv, attn_core_bf16_kernel,
the out-projection; the f32 and int8 cores at any T and both head dims)
adds, after 4t:

3h. row 1 in every variant at (256 / 128, 128, 1536), 16 heads of 96, and
    (256 / 128, 256, 1024), 16 heads of 64; its bf16 core's four variants
    at batch 8 at T = 1, 64, 100, 161 (D = 1536), 1, 64, 100, 435 (D =
    1024) and 607 (D = 768); row 2 at 32768 x 1536 -> 6144 and 65536 x
    1024 -> 4096; against their plain versions at phase 3's tolerances;
4u. bench.py --arch pc_d48w1536: phase 4's flagship call on pc_d48w1536
    (48 x 1536, 16 heads of 96, T = 128), calibrated on 16 prompts:
    exactly 1200 launches of rows 1 and 2 and 0 of the others, the output,
    one forward of the stack against plain (phase 4's gate; no whole plain
    call), p50 samples/s over 3 calls, peak memory;
4v. bench.py --points 4096: the same on pc_d48w1024 at 4096 points (T =
    256, the split route; row 2 at 65536 rows);
5i. row 1 at 4u's and 4v's shapes at both batches timed (events, a graph,
    plain, the bound), the split route's qkv round trip in bytes, the ptxas
    report of every new instance (phase 5's ptxas / SASS gate covers the
    wgmma ones: the hd-96 kernel and the split route's TMA-store QKV
    GEMM; attn_core_bf16_kernel, on mma.sync, is the one function of the
    int8 libraries that may issue HMMA);
6.  one profiled 4u call (device activity, idle share) and 10 calls of the
    split route by kernel (the bf16 qkv written by the GEMM, read by the
    core).
The sum of 3h, 4u, 4v and 5i is printed (budget 90 s). 5i also times row
2 (fused_ln_int8_mlp) at 4u's and 4v's rows (32768 x 1536 -> 6144, 65536
x 1024 -> 4096) beside its bound and torch._int_mm's two products.

Head dim 96 in the f32 routes of flash_attention (the forward
flash_fwd_f32_kernel<96>: 64 query rows a block; the backward
as one pass, flash_attention_bwd_f32_96, after the prep kernel) and
in flash_attention_static's int8 score core (96-byte code rows as three
32-byte panels in the 32B swizzle, three s8 k-steps) adds to 3c-3e and,
after 4t, three phases (their time and the 3c-3e additions' together is
printed beside its budget of 150 s):

3c. the f32 forward at (2, 16, 5120, 96) with no bias and a key bias, at
    the 1.4B step's 1024 + 1229 keys with a fully masked sample and 32 +
    1024 at batch 1, a full bias at 1280, Lq 1000 / Lk 1531 and under one
    tile, against its plain version (1e-4 / 1e-5 relative); timed at (2,
    16, 5120, 96) beside SDPA's f32 forward and its bound (4 B H L^2 d at
    67 TFLOP/s); 5d gates its three hd-96 instances' ptxas / SASS (no
    spill, UTMALDG, no tensor-core instruction);
3d. the int8 score core at head dim 96 at the 1.4B int8 call's shapes
    (1280, 1536, 3072, 5120 keys, no bias and a visibility bias with a
    fully masked sample; q, k bf16 and once f32), against its plain
    version (2^-6 / 2^-10); timed at (2, 16, 5120, 96) beside its bound (2
    B H L^2 d int8 operations at 1979 TOP/s plus p v's at 989 TFLOP/s; no
    library call computes it); 5c gates its two instances (IGMMA, HGMMA,
    UTMALDG, no spill);
3e. the f32 backward at head dim 96 (prep, f32_96) at the 1.4B shapes in
    every bias form (a fully masked sample's gradients exactly 0), prep
    exactly its plain version, dq, dk and dv of two runs bitwise equal, the
    many-tile case at (1, 16, 32768, 96); each kernel timed at (2, 16,
    5120, 96) by events and from a graph beside the plain backward, SDPA's
    f32 backward and the bounds (10 B H L^2 d); f32_96's ptxas / SASS gated
    (no spill, UTMALDG and UTMAREDG, no tensor-core instruction);
4w. 4r's directory through from_pretrained(dir) at its default dtype,
    float32: the weights exactly the written bf16 values upcast; one
    prompt at W_AR AR x 25 steps, CFG 5.0, latent output: flash_attention
    exactly the model's count for that call, every launch f32 at head dim
    96; the wall time and peak; one encoder pass and one head eval
    against plain at the f32 tolerance (2 x floor + 1e-5);
4x. the t2i-1.4b step in f32 compute, loss and gradients at batch 2 (no
    optimizer step): 96 flash_attention, 48 each of prep and f32_96; the
    gradient within 2 x floor + 1e-6 of the f32 plain step;
    its time and peak;
4y. 4s's weights with attn_core="int8", calibrated as 4s, one call at 64
    AR x 25 steps: rows 8 / 5 / 6 / int8_linear exactly 2064 / 2064 / 9600
    / 4128, every row-8 launch on the int8 core at head dim 96, 4d's
    one-step check, samples/s and peak; then bench.py --mode t2i
    --attn-core int8 (4d's model, the int8 core at head dim 64) at
    T2I_CMP_AR AR steps: its exact launches and 4d's gate against plain.
The kernels line lists each kernel's timed instances (dtype, head dim,
score core) with their launches on the driven paths.

The script prints its total time before the result lines.

    python3 chip_smoke.py --profile released_1024px

runs, after phases 1 and 2, only where the released 1024px call's time
goes (released_profile): the model of 4p with seeded random bf16 weights
behind NOVAPipeline, one prompt of random embeddings at 64 AR x 25 steps,
CFG 5.0, latent output; two calls' walls, one masking-phase image-encoder
pass and one head eval by CUDA events, 25 head evals by the host clock,
and one call under torch.profiler (the device's busy time and idle share,
the kernels by device time). It prints the profile as its last line.

The line before the last is a JSON object with one entry per kernel; the
last line is the result object. Details go to build/chip_smoke.json.
"""

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

try:
    from nova_pointcloud_tpu_torch.models.nova import NOVATransformer
    from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer
    from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder
    from nova_pointcloud_tpu_torch.ops.kernels import _build
    from nova_pointcloud_tpu_torch.ops.kernels import flash_attention as fa
    from nova_pointcloud_tpu_torch.ops.kernels import fused_block as fb
    from nova_pointcloud_tpu_torch.ops.quantization import quantize_weight_kmajor
    from nova_pointcloud_tpu_torch.pipelines.builder import build_pipeline
    from nova_pointcloud_tpu_torch.pipelines.nova import NOVAPipeline
    from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (
        NOVAPointCloudGenerationPipeline)
    from nova_pointcloud_tpu_torch.engine.lr_schedules import constant_lr
    from nova_pointcloud_tpu_torch.engine.optim import build_optimizer
    from nova_pointcloud_tpu_torch.ops import masking
    from nova_pointcloud_tpu_torch.pipelines.train_nova import NOVATrainT2IPipeline
    from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
    from nova_pointcloud_tpu_torch.schedulers.flow_match import FlowMatchEulerScheduler
    from nova_pointcloud_tpu_torch.data.shapenet import GlobalNormalizer, make_synthetic_clouds
    from nova_pointcloud_tpu_torch.evaluation.pointcloud_eval import PointCloudEvaluator
    from nova_pointcloud_tpu_torch.ops import losses as pc_losses
    from nova_pointcloud_tpu_torch.ops.pointops import dynamic_partition
    from nova_pointcloud_tpu_torch.pipelines.pointcloud_train import (
        NOVATrainPointCloudPipeline, PointCloudLossConfig, make_pc_loss_fn)
    from nova_pointcloud_tpu_torch.scripts import train_pointcloud
    from nova_pointcloud_tpu_torch.engine.trainer import Trainer
    from nova_pointcloud_tpu_torch.models.guidance import GuidanceConfig
    from nova_pointcloud_tpu_torch.models.pointcloud import ARRefiner
    from nova_pointcloud_tpu_torch.models.pointcloud_ar import NOVAPointCloudARTransformer
    from nova_pointcloud_tpu_torch.pipelines.pointcloud_ar import NOVAPointCloudARPipeline
    from nova_pointcloud_tpu_torch.scripts import train_eval_pc_ar
    from nova_pointcloud_tpu_torch.models.autoencoders import (AutoencoderKL,
                                                               AutoencoderKLOpenSora)
    from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_cogvideox import (
        AutoencoderKLCogVideoX)
    from nova_pointcloud_tpu_torch.models.autoencoders.autoencoder_kl_ltx import (
        AutoencoderKLLTXVideo)
    from nova_pointcloud_tpu_torch.utils.image_processor import VaeImageProcessor
    from nova_pointcloud_tpu_torch.models.autoencoders.torch_loading import (
        load_torch_vae_weights)
    from nova_pointcloud_tpu_torch.models.layers import dense, layer_norm
    from nova_pointcloud_tpu_torch.models.text_encoders.phi import PhiConfig, PhiEncoderModel
    from nova_pointcloud_tpu_torch.models.torch_loading import reference_state_dict
    from nova_pointcloud_tpu_torch.pipelines.builder import build_transformer
    from nova_pointcloud_tpu_torch.pipelines.nova_c2i import NOVAC2IPipeline
    from nova_pointcloud_tpu_torch.pipelines.pretrained import from_pretrained
    from nova_pointcloud_tpu_torch.utils import safetensors_io
    _PORT_IMPORT_ERROR = None
except ImportError as e:  # reported by main(): the script needs the checkout
    _PORT_IMPORT_ERROR = e


def _fail(msg: str, code: int) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(code)


ARCH, POINTS, PATCH, STEPS, BATCH = "pc_d48w1024", 2048, 16, 25, 128
GUIDANCE, TRUNC = 7.5, 800.0
DEPTH, D, HEADS, F = 48, 1024, 16, 4096
T = POINTS // PATCH
# H100 SXM dense peaks (NVIDIA data sheet) at the full 700 W power limit
PEAK_INT8_OPS, PEAK_BF16_FLOPS, PEAK_BYTES = 1979e12, 989e12, 3.35e12
PEAK_F32_FLOPS = 67e12  # f32 outside the tensor cores
# the per-point paths: pc_d8w768, every point a token
PP_ARCH, PP_PATCH, PP_BATCH = "pc_d8w768", 1, 8
PP_DEPTH, PP_D, PP_HEADS, PP_F, PP_HD = 8, 768, 12, 3072, 64
PP_T = POINTS // PP_PATCH
# NOVA t2i serving (bench.py --mode t2i): batch 4 x CFG 2, 64 AR steps (63
# non-empty) x 25 diffusion steps, 32 x 32 latent patches
T2I_ARCH = ("vit_d16w1024", "vit_d32w1024", "mlp_d6w1024")
T2I_BATCH, T2I_AR, T2I_DIFF, T2I_CAL_AR, T2I_GUIDANCE = 4, 64, 25, 16, 5.0
T2I_CMP_AR = 16  # AR steps of the plain / floor comparisons (the plain run is slow)
# the t2i paths' p50 over 2 calls (5c), the profiled int8 call of 16 AR
# steps (6): time freed for the slice of row 1 at head dim 96 and T = 256
T2I_TIMED_CALLS, T2I_PROFILE_AR = 2, 16
T2I_BASE, T2I_VIDEO_BASE = (32, 32), (1, 16, 16)
T2I_VIT_LAYERS, T2I_V_LAYERS, T2I_DIFF_BLOCKS = 32, 16, 6
T2I_PROMPTS = [f"a scene {i}" for i in range(T2I_BATCH)]
# t2i training (bench.py --mode train --train-arch t2i): batch 8, 1024 image
# tokens, remat; the decoder half's 16 layers see 256 + 1024 keys
TRAIN_BATCH, TRAIN_LR, TRAIN_FALL_STEPS = 8, 1e-4, 10
TRAIN_FLASH_LAYERS = T2I_VIT_LAYERS // 2
TRAIN_LAUNCHES = {"flash_attention_bwd_prep": TRAIN_FLASH_LAYERS,
                  "flash_attention_bwd_dkvq": TRAIN_FLASH_LAYERS,
                  "flash_attention_bwd_dq_cast": TRAIN_FLASH_LAYERS,
                  "flash_attention": 2 * TRAIN_FLASH_LAYERS}  # remat runs each forward twice
# the f32 step of the same model (phase 4f's exactness check): the f32 route
TRAIN_F32_LAUNCHES = {"flash_attention_bwd_prep": TRAIN_FLASH_LAYERS,
                      "flash_attention_bwd_f32": TRAIN_FLASH_LAYERS,
                      "flash_attention": 2 * TRAIN_FLASH_LAYERS}
# t2pc training (scripts/train_pointcloud's defaults): pc_d8w768, 1024 points
# at patch 1 (1024 tokens), batch 16, f32, remat, dropout 0.1
PC_TRAIN_ARCH, PC_TRAIN_POINTS, PC_TRAIN_BATCH, PC_TRAIN_LR = "pc_d8w768", 1024, 16, 1e-4
PC_TRAIN_FALL_STEPS, PC_TRAIN_SAVE_AT = 20, 19  # gate (c): step 20 updates the EMA
PC_EVAL_PROMPTS, PC_EVAL_GUIDANCE = 4, (1.0, 3.0)
# the dropout-0 step through the dispatcher: the f32 route at 1024 keys,
# each forward twice (remat)
PC_TRAIN_F32_LAUNCHES = {"flash_attention": 2 * PP_DEPTH, "flash_attention_bwd_prep": PP_DEPTH,
                         "flash_attention_bwd_f32": PP_DEPTH}
# the script's run: its sampled-CD eval (2 guidance scales x 5 steps x 8
# layers, bf16); its training and validation run the plain core
PC_SCRIPT_ARGS = ["--max-steps", "2", "--val-every", "2", "--eval-shapes", "4", "--eval-steps", "5"]
PC_SCRIPT_LAUNCHES = {"flash_attention": 2 * 5 * PP_DEPTH}
PC_EVAL_LAUNCHES = {"flash_attention": len(PC_EVAL_GUIDANCE) * STEPS * PP_DEPTH}
# masked-AR t2pc serving (models/pointcloud_ar.py's defaults): pc_d32w768,
# 2048 points at patch 16 (128 tokens), text 32 x 256, DDPM 16 AR x 25
# steps, CFG 5 (the pipeline's defaults), batch 32, bf16
AR_ARCH, AR_POINTS, AR_PATCH, AR_TEXT, AR_BATCH = "pc_d32w768", 2048, 16, 32, 32
AR_STEPS, AR_DIFF, AR_GUIDANCE, AR_CMP_STEPS = 16, 25, 5.0, 4
# 5f: the masked-AR float and refinement calls' p50 over 2 calls; 6: the
# profiled masked-AR int8 call of 8 AR steps (time freed as T2I_TIMED_CALLS)
AR_SLOW_TIMED_CALLS, AR_PROFILE_STEPS = 2, 8
AR_DEPTH, AR_D, AR_F, AR_HEAD_BLOCKS = 32, 768, 3072, 6
AR_T = AR_POINTS // AR_PATCH
AR_ROWS = 2 * AR_BATCH  # CFG
AR_PAD_P = 13  # the largest count of cosine_pred_counts(16, 128), checked in 4h
AR_VIT_M, AR_HEAD_M = AR_ROWS * (AR_TEXT + AR_T), AR_ROWS * AR_PAD_P  # 10240, 832 rows
AR_INT8_LAUNCHES = {"fused_int8_mlp_postln": AR_STEPS * AR_DEPTH,
                    "int8_linear": 2 * AR_STEPS * AR_DEPTH,
                    "fused_int8_diffusion_block": AR_STEPS * AR_DIFF * AR_HEAD_BLOCKS}
AR_PROMPTS = [f"a chair {i}" for i in range(AR_BATCH)]
# the refinement mode on the flagship: ARRefiner() at its defaults
REFINE_SUBSETS, REFINE_CPU_SAMPLES = 16, 4
# masked-AR training (scripts/train_eval_pc_ar.py's defaults: pc_d8w768,
# 1024 points at patch 16, batch 32, f32, remat); the script's main cut to
# 2 steps, then a fixed batch for 20
AR_SCRIPT_ARGS = ["--max-steps", "2"]
AR_TRAIN_FALL_STEPS = 20
# NOVA t2v serving (bench.py --mode t2v, nova_d48w1024_osp480.yaml's shapes):
# NOVATransformer(vit_d16w1024, vit_d32w1024, mlp_d6w1024), RoPE, mixer rank
# 24, 30 x 48 image / 15 x 24 video patches, text 256 x 2560 plus 2 motion
# tokens, batch 1 x CFG 2, 9 latent frames, 64 AR (63 non-empty) x 25 steps,
# flow shift 5
T2V_BASE, T2V_VIDEO_BASE, T2V_TEXT, T2V_TEXT_DIM, T2V_RANK = (30, 48), (9, 15, 24), 256, 2560, 24
T2V_BATCH, T2V_FRAMES, T2V_AR, T2V_DIFF, T2V_CAL_AR, T2V_SHIFT = 1, 9, 64, 25, 16, 5.0
T2V_ROWS = 2 * T2V_BATCH  # CFG
T2V_NI, T2V_NV = T2V_BASE[0] * T2V_BASE[1], T2V_VIDEO_BASE[1] * T2V_VIDEO_BASE[2]  # 1440, 360
T2V_PREFIX = T2V_TEXT + 2  # the motion tokens (flow, fps) follow the prompt
T2V_S, T2V_PAD_P = 63, 36  # non-empty AR steps and their largest count, checked in 4k
T2V_FLASH_PER_FRAME = 1552  # the float twin's flash_attention launches a frame, checked in 4l
# the image encoder's keys: its encoder half at 360 + the bucket (180, 360,
# 720) in the gather phases, 360 + 1440 in the masking phase and the decoder
T2V_L = (540, 720, 1080, 1800)
T2V_VIDEO_L = (T2V_PREFIX + T2V_NV, T2V_NV)  # the video encoder's rows: frame 0, later frames
T2V_CMP_FRAMES, T2V_CMP_AR, T2V_FLOAT_FRAMES = 2, 8, 2
# the profiled int8 call: 2 frames of 16 AR steps (a 64-step call's events
# took the profiler 300 s to process)
T2V_PROFILE_FRAMES, T2V_PROFILE_AR = 2, 16
T2V_PROMPTS = [f"a drone shot {i}" for i in range(T2V_BATCH)]
# the VAEs of bench.py --mode t2i --e2e and --mode t2v --e2e: AutoencoderKL
# and AutoencoderKLOpenSora at their default widths, 4 latent channels,
# seeded random bf16 weights (the bench initialises them from seed 7)
VAE_SEED, T2V_DECODE_WINDOWS = 7, 2
T2I_IMAGE_SHAPE = (T2I_BATCH, 16 * T2I_BASE[0], 16 * T2I_BASE[1], 3)  # (4, 512, 512, 3)
T2V_LATENT_SHAPE = (T2V_BATCH, T2V_FRAMES, 2 * T2V_BASE[0], 2 * T2V_BASE[1], 4)
T2V_VIDEO_SHAPE = (T2V_BATCH, 4 * T2V_FRAMES - 3, 16 * T2V_BASE[0], 16 * T2V_BASE[1], 3)
# phase 4m: each VAE class at a small size, f32, on the card against the CPU
# (widths of the 3D VAEs cut, inputs cropped, windows shortened so each
# tiling runs two windows each way): name -> (class, config, input, latents)
VAE_SMALL = {
    "AutoencoderKL": ("AutoencoderKL", dict(latent_channels=4), (1, 128, 128, 3),
                      (2, 16, 16, 4)),
    "AutoencoderKLOpenSora": ("AutoencoderKLOpenSora",
                              dict(latent_channels=4, block_out_channels=(64, 64, 128, 128),
                                   sample_min_t=9, latent_min_t=3),
                              (1, 17, 64, 64, 3), (1, 5, 16, 16, 4)),
    "AutoencoderKLCogVideoX": ("AutoencoderKLCogVideoX",
                               dict(latent_channels=4, block_out_channels=(64, 64, 64, 128),
                                    layers_per_block=1, sample_min_t=9, latent_min_t=3),
                               (1, 17, 64, 64, 3), (1, 6, 16, 16, 4)),
    "AutoencoderKLLTXVideo": ("AutoencoderKLLTXVideo",
                              dict(block_out_channels=(32, 64, 64, 128, 128),
                                   layers_per_block=(1,) * 5,
                                   decoder_block_out_channels=(32, 64, 128, 256),
                                   decoder_layers_per_block=(1,) * 4, latent_channels=16,
                                   sample_min_t=17, latent_min_t=2),
                              (1, 33, 128, 128, 3), (1, 4, 4, 4, 16)),
}
# max |card - CPU| / max |CPU|, f32 (TF32 off): ~12x the worst reading,
# 8.3e-6, of the four VAEs' encode and decode on an H100 (PERF.md)
VAE_CPU_TOL = 1e-4
# bf16 against f32 on the card, the bench's two VAEs at their widths: mean
# and max |diff| relative to the f32 output's mean and max, 2x and ~3x what
# the same models give on the CPU (1.46-1.48% mean, 1.6-2.2% max)
VAE_BF16_TOL = (3e-2, 6e-2)
# the Phi-2 prompt encoder at full size (PhiConfig()), f32, TF32 off (4o): a
# batch of PHI_BATCH prompts of the released t2i config's PHI_TOKENS tokens;
# the card against the CPU on its first PHI_CMP_LAYERS layers
PHI_BATCH, PHI_TOKENS, PHI_CMP_LAYERS = 4, 256, 2
# ~9x / ~12x the readings of 3.25e-6 and 1.63e-6 on an H100 (PERF.md)
PHI_PAD_TOL = 3e-5  # the all-padding row vs its plain recomputation, x max
PHI_CPU_TOL = 2e-5  # max |card - CPU| / max |CPU| at PHI_CMP_LAYERS layers
# the released NOVA-0.6B 1024px t2i config (4p): the model: block of
# nova_pointcloud_tpu/configs/nova_d48w1024_sdxl1024.yaml, one prompt, 64 AR
# x 25 steps, CFG 5, the SDXL VAE (4 latents, scaling 0.13025)
RELEASED_MODEL = {"image_dim": 4, "image_size": [1024, 1024], "image_stride": 8,
                  "text_token_dim": 2560, "text_token_len": 256, "rotary_pos_embed": False,
                  "video_base_size": [1, 32, 32], "image_base_size": [64, 64],
                  "arch": ["vit_d16w1024", "vit_d32w1024", "mlp_d6w1024"],
                  "gradient_checkpointing": 0, "loss_repeat": 4}
RELEASED_TEXT, RELEASED_NV, RELEASED_NI = 256, 32 * 32, 64 * 64
RELEASED_AR, RELEASED_DIFF, RELEASED_GUIDANCE = 64, 25, 5.0
RELEASED_IMAGE_SHAPE = (1, 1024, 1024, 3)
SDXL_VAE = {"block_out_channels": [128, 256, 512, 512], "latent_channels": 4,
            "scaling_factor": 0.13025}
# c2i serving (4q): bench.py --mode t2i's model with an ImageNet-sized label
# table and no text, a batch of 4 class ids
C2I_CLASSES, C2I_LABELS = 1000, [1, 207, 388, 980]
# the released NOVA-1.4B 1024px t2i config (4r, 4s): the model: block of
# nova_pointcloud_tpu/configs/nova_d48w1536_sdxl1024.yaml, width 1536 over
# 16 heads: head dim 96; the image encoder sees 1024 video states + 4096
# image tokens as keys
XL_MODEL = dict(RELEASED_MODEL, arch=["vit_d16w1536", "vit_d32w1536", "mlp_d6w1536"])
XL_D, XL_F, XL_HD, XL_KEYS = 1536, 4 * 1536, 96, RELEASED_NV + RELEASED_NI
XL_ROWS = 2  # one prompt x CFG 2
# bench.py --mode train --train-arch t2i-1.4b's step (4t): batch 2, text 32 x
# 256, 64 x 64 patches, f32 master weights, bf16 compute, remat
XL_TRAIN_BATCH, XL_TRAIN_TEXT, XL_TRAIN_STEPS = 2, 32, 3
KERNELS = ("fused_attention_block", "fused_ln_int8_mlp", "fused_ln_int8_matmul",
           "int8_matmul_residual", "flash_attention", "fused_int8_mlp_postln",
           "fused_int8_diffusion_block", "flash_attention_static", "int8_linear",
           "flash_attention_bwd_f32", "flash_attention_bwd_prep",
           "flash_attention_bwd_dkvq", "flash_attention_bwd_dq_cast",
           "flash_attention_bwd_dkvq96", "flash_attention_bwd_f32_96")
SOURCES = {n: f"nova_pointcloud_tpu_torch/csrc/{n}.cu" for n in KERNELS}
BWD_SOURCE_KERNELS = ("flash_attention_bwd_f32", "flash_attention_bwd_prep",
                      "flash_attention_bwd_dkvq", "flash_attention_bwd_dq_cast",
                      "flash_attention_bwd_dkvq96", "flash_attention_bwd_f32_96")
SOURCES.update(dict.fromkeys(BWD_SOURCE_KERNELS,
                             "nova_pointcloud_tpu_torch/csrc/flash_attention_bwd.cu"))
REPLACES = {"fused_attention_block": "nova_pointcloud_tpu/ops/pallas/fused_block.py:412",
            "fused_ln_int8_mlp": "nova_pointcloud_tpu/ops/pallas/fused_block.py:133",
            "fused_ln_int8_matmul": "nova_pointcloud_tpu/ops/pallas/fused_block.py:204",
            "int8_matmul_residual": "nova_pointcloud_tpu/ops/pallas/fused_block.py:264",
            "flash_attention": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:525",
            "fused_int8_mlp_postln": "nova_pointcloud_tpu/ops/pallas/fused_block.py:555",
            "fused_int8_diffusion_block": "nova_pointcloud_tpu/ops/pallas/fused_block.py:665",
            "flash_attention_static": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:424",
            # no TPU kernel: the JAX model's int8 projections are plain XLA
            "int8_linear": "nova_pointcloud_tpu/models/vit.py:83",
            # the f32 route: the dK/dV kernel and the dQ kernel's products
            # (line 346) in one pass
            "flash_attention_bwd_f32": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:297",
            # _flash_bwd's delta (XLA, line 261) and lse rows
            "flash_attention_bwd_prep": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:254",
            # the bf16 dK/dV kernel, and the dQ kernel's products (one pass)
            "flash_attention_bwd_dkvq": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:297",
            # the dQ kernel's output
            "flash_attention_bwd_dq_cast":
                "nova_pointcloud_tpu/ops/pallas/flash_attention.py:346",
            # head dim 96: the dK/dV kernel and the dQ kernel's products in
            # one pass, the dQ sums in a fixed order (bf16; its output in the
            # cast kernel)
            "flash_attention_bwd_dkvq96": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:297",
            # the same one pass in f32 at head dim 96
            "flash_attention_bwd_f32_96": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:297"}
OUT_DIR = "build"
PC_TRAIN_DIR = os.path.join(OUT_DIR, "pc_train")  # checkpoints of phase 4g, removed after it
AR_TRAIN_DIR = os.path.join(OUT_DIR, "pc_ar")  # phase 4j's stats and results, removed after it
RELEASED_DIR = os.path.join(OUT_DIR, "released_1024px")  # 4p's checkpoint, removed after it
XL_DIR = os.path.join(OUT_DIR, "released_1p4b")  # 4r's checkpoint, removed after it
DEV = "cuda"

failures = []
report = {"kernels": {}, "checks": [], "pipeline": {}}


def phase(name):
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            print(f"## {name}", flush=True)
            try:
                out = fn(*a, **kw)
                print(f"## {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
                return out
            except Exception:  # a failed phase is reported; the others still run
                traceback.print_exc()
                failures.append(name)
                print(f"## {name}: FAILED", flush=True)
                return None
        return run
    return wrap


def sync_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls after one warm-up (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Mean ms per call of ``fn`` replayed from a CUDA graph of ``n`` calls
    captured once (CUDA events around ``reps`` replays): the device time of
    back-to-back launches without the host's time per call (a wrapper's
    checks, allocations and ctypes call), which ``sync_ms`` takes in where
    the kernel is shorter. Warmed up on a side stream first, as capture
    needs."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (n * reps)


@phase("1 device")
def device_info():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{nvcc[-1] if nvcc else 'nvcc ?'}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    report["device"] = {"smi": smi[0] if smi else None, "torch": torch.__version__,
                        "cuda": torch.version.cuda}


@phase("2 build")
def build():
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    report["build_s"] = time.perf_counter() - t0


def _kernel_operands(gen, rows_or_batch, kind, t=T, d=D, f=F):
    """Random operands at flagship widths (or T = t, D = d, F = f): bf16
    activations, int8 weights quantized per channel from N(0, 1/fan_in) in
    the K-major layout the serving path pre-quantizes to, bf16 LN params and
    biases."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * std

    if kind == "attention":
        x = randn(rows_or_batch, t, d).to(torch.bfloat16)
        w1, s1 = quantize_weight_kmajor(randn(3 * d, d, std=d ** -0.5))
        w2, s2 = quantize_weight_kmajor(randn(d, d, std=d ** -0.5))
        b1, b2 = randn(3 * d, std=0.02), randn(d, std=0.02)
    else:
        x = randn(rows_or_batch, d).to(torch.bfloat16)
        w1, s1 = quantize_weight_kmajor(randn(f, d, std=d ** -0.5))
        w2, s2 = quantize_weight_kmajor(randn(d, f, std=f ** -0.5))
        b1, b2 = randn(f, std=0.02), randn(d, std=0.02)
    lns = (1.0 + randn(d, std=0.1)).to(torch.bfloat16)
    lnb = randn(d, std=0.1).to(torch.bfloat16)
    return [x, lns, lnb, w1, s1, b1.to(torch.bfloat16), w2, s2, b2.to(torch.bfloat16)]


def _variants(kind, heads=HEADS):
    s = lambda v: torch.tensor(v, device=DEV)  # noqa: E731
    if kind == "attention":
        out = []
        for core in ("bf16", "f32", "int8"):
            for static in (True, False):
                for smax in (True, False):
                    kw = dict(num_heads=heads, core=core)
                    if static:
                        kw.update(a_in=s(5.0), a_av=s(3.0))
                    if smax:
                        kw["a_smax"] = s(8.0)
                    out.append((f"core={core} static={static} smax={smax}", kw))
        return out
    return [("static=True", dict(a_in=s(5.0), a_mid=s(8.0))), ("static=False", {})]


def _kernels():
    """name -> (kind, CUDA wrapper, plain version)"""
    return {"fused_attention_block": ("attention", fb.fused_attention_block,
                                      fb.fused_attention_block_plain),
            "fused_ln_int8_mlp": ("mlp", fb.fused_ln_int8_mlp, fb.fused_ln_int8_mlp_plain)}


FLAGSHIP_SHAPE = {"attention": 2 * BATCH, "mlp": 2 * BATCH * T}  # the CFG steps' 2x batch


def _tol_check(name, label, y, ref, tol_max_rel=2.0 ** -6, tol_mean_rel=2.0 ** -10,
               like=None, quiet=False):
    """One comparison under the max / mean gates; records it and, unless
    ``quiet``, prints it."""
    ref = ref.float()
    err = (y.float() - ref).abs()
    tol_max = tol_max_rel * ref.abs().max().item()
    tol_mean = tol_mean_rel * ref.abs().mean().item()
    e_max, e_mean = err.max().item(), err.mean().item()
    ok = bool(torch.isfinite(y).all()) and e_max <= tol_max and e_mean <= tol_mean
    if like is not None:
        ok = ok and y.dtype == like.dtype and y.shape == like.shape
    if not quiet:
        print(f"  {name} {label} {tuple(y.shape)}: max_abs_err {e_max:.3e} (tol {tol_max:.3e}) "
              f"mean {e_mean:.3e} (tol {tol_mean:.3e}) {'ok' if ok else 'FAIL'}")
    report["checks"].append(dict(kernel=name, variant=label, max_abs_err=e_max,
                                 tol_max=tol_max, mean_abs_err=e_mean, tol_mean=tol_mean,
                                 ok=ok))
    k = report["kernels"].setdefault(name, {})
    k["max_abs_err"] = max(k.get("max_abs_err", 0.0), e_max)
    return ok


@phase("3 kernels vs plain")
def check_kernels():
    """Tolerance: kernel and plain version compute the same int8 codes and
    the same f32 math in another summation order; an f32 difference of one
    ulp can flip an int8 code (moving one row by ~1e-3) or a bf16 output by
    one ulp. Max error <= 4 bf16 ulps of max|y| (2^-6 max|y|) and mean error
    <= 2^-10 mean|y| pass; a wrong fragment, scale or bias fails both.
    Every attention variant at both flagship batches, the MLP's at the 2x
    batch and its flagship variant at the 1x."""
    gen = torch.Generator(device=DEV).manual_seed(1234)
    bad = []
    for name, (kind, kernel, plain) in _kernels().items():
        # every variant at the CFG steps' 2x batch; at the 1x batch of the
        # steps after truncation every attention variant and the MLP's
        # flagship variant (the first)
        cases = [(FLAGSHIP_SHAPE[kind], v) for v in _variants(kind)]
        cases += [(FLAGSHIP_SHAPE[kind] // 2, v)
                  for v in (_variants(kind) if kind == "attention" else _variants(kind)[:1])]
        for n, (label, kw) in cases:
            ops = _kernel_operands(gen, n, kind)
            y = kernel(*ops, **kw)
            torch.cuda.synchronize()
            if not _tol_check(name, label, y, plain(*ops, **kw), like=ops[0]):
                bad.append(f"{name} {label}")
            del y, ops
            torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    fb.reset_launch_counts()  # these launches were comparisons, not the main path


def _proj_operands(gen, lead, k, n, x_dtype=torch.bfloat16, res_dtype=torch.bfloat16):
    """Operands of the split path's two projections: x (*lead, k), LN
    params, K-major int8 weight (k, n) with scales, bias, residual (*lead, n)."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * std

    x = randn(*lead, k).to(x_dtype)
    lns = (1.0 + randn(k, std=0.1)).to(torch.bfloat16)
    lnb = randn(k, std=0.1).to(torch.bfloat16)
    wq, ws = quantize_weight_kmajor(randn(n, k, std=k ** -0.5))
    b = randn(n, std=0.02).to(torch.bfloat16)
    res = randn(*lead, n).to(res_dtype)
    return x, lns, lnb, wq, ws, b, res


def _pp_mlp_operands(gen, m):
    """Operands of fused_ln_int8_mlp at the per-point width: x (m, 768),
    W1 (768, 3072), W2 (3072, 768)."""
    xm, lns, lnb, w1, s1, b1, _ = _proj_operands(gen, (m,), PP_D, PP_F)
    _, _, _, w2, s2, b2, _ = _proj_operands(gen, (1,), PP_F, PP_D)
    return xm, lns, lnb, w1, s1, b1, w2, s2, b2


@phase("3b split-path kernels vs plain")
def check_split_kernels():
    """fused_ln_int8_matmul and int8_matmul_residual at the per-point path's
    shapes (batch 16 and 8 of 2048 tokens, D=768), a row count that is no
    multiple of any tile, D=1024, D=1536 (pc_d48w1536's width: rows staged in
    shared memory), and x / residual of differing dtypes; then
    fused_ln_int8_mlp at that path's width (D=768, F=3072) at both batch
    sizes and a ragged row count, with static and per-row activation scales.
    Tolerance as phase 3: the same int8 codes, f32 sums in another order."""
    gen = torch.Generator(device=DEV).manual_seed(4321)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [((2 * PP_BATCH, PP_T), PP_D, bf16, bf16), ((PP_BATCH, PP_T), PP_D, bf16, bf16),
             ((16461,), PP_D, bf16, bf16), ((PP_BATCH, PP_T), 1024, bf16, bf16),
             ((PP_BATCH, PP_T), 1536, bf16, bf16),  # wider than one register-held row
             ((3, 1000), PP_D, bf16, f32), ((3, 1000), PP_D, f32, bf16)]
    bad = []
    for lead, d, xdt, rdt in cases:
        x, lns, lnb, wq, ws, b, _ = _proj_operands(gen, lead, d, 3 * d, xdt)
        y = fb.fused_ln_int8_matmul(x, lns, lnb, wq, ws, b)
        torch.cuda.synchronize()
        ref = fb.fused_ln_int8_matmul_plain(x, lns, lnb, wq, ws, b)
        if not _tol_check("fused_ln_int8_matmul", f"x={xdt} {d}->{3 * d}", y, ref, like=ref):
            bad.append(f"fused_ln_int8_matmul {lead} {d}")
        del x, y, ref
        x, _, _, wq, ws, b, res = _proj_operands(gen, lead, d, d, xdt, rdt)
        y = fb.int8_matmul_residual(x, res, wq, ws, b)
        torch.cuda.synchronize()
        ref = fb.int8_matmul_residual_plain(x, res, wq, ws, b)
        if not _tol_check("int8_matmul_residual", f"x={xdt} res={rdt} {d}->{d}", y, ref,
                          like=res):
            bad.append(f"int8_matmul_residual {lead} {d}")
        del x, y, ref, res
        torch.cuda.empty_cache()
    for m in (2 * PP_BATCH * PP_T, PP_BATCH * PP_T, 16461):
        ops = _pp_mlp_operands(gen, m)
        for label, kw in _variants("mlp"):
            y = fb.fused_ln_int8_mlp(*ops, **kw)
            torch.cuda.synchronize()
            ref = fb.fused_ln_int8_mlp_plain(*ops, **kw)
            if not _tol_check("fused_ln_int8_mlp", f"{label} {PP_D}->{PP_F}->{PP_D}", y, ref,
                              like=ops[0]):
                bad.append(f"fused_ln_int8_mlp {m} {label}")
            del y, ref
        del ops
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    fb.reset_launch_counts()


def _flash_operands(gen, b, h, lq, lk, d, dtype=torch.bfloat16):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEV).to(dtype)
    return randn(b, h, lq, d), randn(b, h, lk, d), randn(b, h, lk, d)


def _flash_bias(gen, kind, b, lq, lk):
    """The bias forms of the kernel: "key" masks ~40% of the keys and the
    whole first 96 (leading key tiles dead before any live key), "dead"
    masks every key of sample 0, "full" is block-causal in blocks of 100."""
    if kind == "none":
        return None
    ninf = float("-inf")
    if kind in ("key", "dead"):
        m = torch.rand((b, 1, 1, lk), generator=gen, device=DEV) > 0.4
        m[..., :96] = False
        m[..., 100] = True
        bias = torch.where(m, 0.0, ninf) + 0.1 * torch.randn((b, 1, 1, lk), generator=gen,
                                                             device=DEV)
        if kind == "dead":
            bias[0] = ninf
        return bias
    pos_q = torch.arange(lq, device=DEV)[:, None] // 100
    pos_k = torch.arange(lk, device=DEV)[None, :] // 100
    return torch.where(pos_q >= pos_k, 0.0, ninf)[None, None]


@phase("3c flash attention vs plain")
def check_flash():
    """Tolerances. bf16: the kernel rounds the unnormalised probabilities
    to bf16 for the second product (relative 2^-9 each, averaging out over
    the keys) and the output to bf16, the plain version rounds the output
    only: max error <= 2^-6 max|o| (4 bf16 ulps at the largest output), mean
    <= 2^-8 mean|o|. f32: f32 sums in another order, max <= 1e-4 max|o|,
    mean <= 1e-5 mean|o|. lse is f32 on both sides (sums of f32
    probabilities): max <= 1e-4 absolute, and exactly 1e30 on dead rows."""
    gen = torch.Generator(device=DEV).manual_seed(777)
    B, H, L = 2 * PP_BATCH, PP_HEADS, PP_T
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("none", B, H, L, L, 64, bf16), ("key", B, H, L, L, 64, bf16),
             ("full", B, H, L, L, 64, bf16), ("dead", B, H, L, L, 64, bf16),
             ("none", PP_BATCH, H, L, L, 64, bf16),
             ("key", 2, H, 1000, 1531, 64, bf16), ("full", 2, H, 333, 1531, 64, bf16),
             ("none", 2, H, 1000, 1531, 64, f32), ("key", 2, H, 1000, 1531, 64, f32),
             ("dead", 2, H, 515, 1000, 64, f32), ("full", 2, H, 515, 1000, 64, f32),
             ("none", 2, H, 37, 45, 64, f32)]  # Lq and Lk under one tile
    bad = []
    for kind, b, h, lq, lk, d, dt in cases:
        q, k, v = _flash_operands(gen, b, h, lq, lk, d, dt)
        bias = _flash_bias(gen, kind, b, lq, lk)
        o, lse = fa.flash_attention_with_lse(q, k, v, bias)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_attention_plain(q, k, v, bias)
        label = f"bias={kind} {str(dt)[6:]} Lk={lk}"
        rel = (2.0 ** -6, 2.0 ** -8) if dt == bf16 else (1e-4, 1e-5)
        ok = _tol_check("flash_attention", label, o, ref_o, *rel, like=ref_o)
        e_lse = (lse - ref_lse).abs().max().item()
        ok_lse = (bool(torch.isfinite(lse).all()) and e_lse <= 1e-4
                  and lse.shape == (b, h, lq) and lse.dtype == f32)
        if kind == "dead":
            ok_lse = ok_lse and bool((lse[0] == 1e30).all()) and bool((o[0] == 0).all())
        print(f"    lse max_abs_err {e_lse:.3e} (tol 1e-4) {'ok' if ok_lse else 'FAIL'}")
        report["checks"].append(dict(kernel="flash_attention", variant=label + " lse",
                                     max_abs_err=e_lse, ok=ok_lse))
        if not (ok and ok_lse):
            bad.append(label)
        del q, k, v, o, lse, ref_o, ref_lse, bias
        torch.cuda.empty_cache()
    # the model's layout: (B, L, H, D) projections read and written in place
    q, k, v = (t.transpose(1, 2) for t in _flash_operands(gen, 2, L, H, H, 64))
    o, _ = fa.flash_attention_with_lse(q, k, v)
    ref_o, _ = fa.flash_attention_plain(q, k, v)
    if not (_tol_check("flash_attention", "strided (B, L, H, D) view", o, ref_o, 2.0 ** -6,
                       2.0 ** -8, like=ref_o) and o.stride() == q.stride()):
        bad.append("strided view")
    # its backward in that layout: do arrives as a (B, L, H, D) view too
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*ins)
    do = torch.randn((2, L, H, 64), generator=gen, device=DEV).to(torch.bfloat16).transpose(1, 2)
    grads = torch.autograd.grad(o, ins, do)
    ref = fa.flash_attention_bwd_plain(q, k, v, None, None, o.detach(), lse, do)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        if not _tol_check(_bwd_kernel(torch.bfloat16),
                          f"{name} strided (B, L, H, D) view", g, r, 2.0 ** -6,
                          2.0 ** -8, like=r):
            bad.append(f"strided backward {name}")
    # the f32 route in that layout, and its backward through autograd on the
    # f32 kernel's lse
    q, k, v = (t.transpose(1, 2) for t in _flash_operands(gen, 2, L, H, H, 64, f32))
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*ins)
    ref_o, ref_lse = fa.flash_attention_plain(q, k, v)
    e_lse = (lse - ref_lse).abs().max().item()
    print(f"    f32 strided lse max_abs_err {e_lse:.3e} (tol 1e-4)")
    if not (_tol_check("flash_attention", "f32 strided (B, L, H, D) view", o, ref_o, 1e-4,
                       1e-5, like=ref_o) and o.stride() == q.stride() and e_lse <= 1e-4):
        bad.append("f32 strided view")
    do = torch.randn((2, L, H, 64), generator=gen, device=DEV).transpose(1, 2)
    grads = torch.autograd.grad(o, ins, do)
    ref = fa.flash_attention_bwd_plain(q, k, v, None, None, o.detach(), lse, do)
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        if not _tol_check(_bwd_kernel(f32), f"{name} f32 strided (B, L, H, D) view", g, r,
                          1e-4, 1e-5, like=r):
            bad.append(f"f32 strided backward {name}")
    bad += _hd96_forward_checks(gen)
    bad += _f32_hd96_forward_checks(gen)
    if bad:
        raise AssertionError(f"flash_attention disagrees with its plain version: {bad}")
    fb.reset_launch_counts()


def _record_launches(name, path, n):
    """A kernel's ``launches`` is its count on the first path that runs it
    (the flagship for the two kernels of the first slice); every path's
    count goes under ``launches_by_path``."""
    k = report["kernels"].setdefault(name, {})
    k.setdefault("launches", n)
    k.setdefault("launches_by_path", {})[path] = n


def _budget_timed(key):
    """A decorator adding each call's seconds to report[key]."""
    def wrap(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                report[key] = report.get(key, 0.0) + time.perf_counter() - t0
        return run
    return wrap


def _instance(name, label, row):
    """Record a timed instance of kernel ``name`` (the kernels line lists
    each kernel's instances beside its main entry)."""
    report["kernels"].setdefault(name, {}).setdefault("instances", {}).setdefault(
        label, {}).update(row)


def _instance_launches(name, label, path, n):
    """An instance's launches on a driven path."""
    inst = report["kernels"].setdefault(name, {}).setdefault("instances", {}).setdefault(label, {})
    inst.setdefault("launches", n)
    inst.setdefault("launches_by_path", {})[path] = n


def _make_pipeline(arch=ARCH, points=POINTS):
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = NOVAPointCloudTransformer(
        arch=arch, point_cloud_size=points, patch_size=PATCH, text_token_dim=256,
        quantize=True, attn_core="bf16", dtype=torch.bfloat16, device=DEV)
    model.init_weights(gen)
    with torch.no_grad():  # a non-zero head, so the cloud depends on every block
        model.output_proj.weight.copy_(
            torch.randn(model.output_proj.weight.shape, generator=gen, device=DEV) * 0.02)
    model = model.to(torch.bfloat16)  # serving: bf16 weights, as the JAX bench
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{arch}: {n_params / 1e6:.1f}M parameters, T={points // PATCH} tokens, batch {BATCH}")
    pipe = NOVAPointCloudGenerationPipeline(
        model, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
        text_encoder=DummyTextEncoder(256, 32))
    return pipe


PROMPTS = [f"a chair {i}" for i in range(BATCH)]


PP_PROMPTS = PROMPTS[:PP_BATCH]


def _sample(pipe, seed=1, prompts=None, num_points=POINTS, **kw):
    out = pipe(prompts or PROMPTS, num_points=num_points, num_diffusion_steps=STEPS,
               guidance_scale=GUIDANCE, guidance_trunc=TRUNC,
               generator=torch.Generator(device=DEV).manual_seed(seed),
               output_type="pt", **kw)
    torch.cuda.synchronize()
    return out


@phase("4 main path")
def main_path():
    pipe = _make_pipeline()
    t0 = time.perf_counter()
    pipe.calibrate(prompt_embeds=pipe.encode_prompt(PROMPTS), num_points=POINTS,
                   num_diffusion_steps=STEPS,
                   generator=torch.Generator(device=DEV).manual_seed(2))
    print(f"calibrate: {time.perf_counter() - t0:.1f} s (plain mirror, float64 int8 products)")
    _sample(pipe, seed=9)  # warm-up: kernel loads, allocator
    gen = torch.Generator(device=DEV).manual_seed(1)
    latents = torch.randn((BATCH, POINTS, 3), generator=gen, device=DEV)
    fb.reset_launch_counts()
    out = _sample(pipe, latents=latents)
    launches = dict(fb.LAUNCHES)
    expected = DEPTH * STEPS
    counts_ok = launches == {n: expected if n in _kernels() else 0 for n in KERNELS}
    print(f"launches in one pipeline call: {launches} (expected {expected} of each flagship "
          f"kernel, 0 of the others): {'ok' if counts_ok else 'FAIL'}")
    for name in _kernels():
        _record_launches(name, "flagship", launches[name])
    pts, cols = out.point_clouds.float(), out.colors.float()
    ok = (tuple(pts.shape) == (BATCH, POINTS, 3) and bool(torch.isfinite(pts).all())
          and pts.abs().max().item() <= 1.0 and 0.0 <= cols.min().item()
          and cols.max().item() <= 1.0 and pts.std().item() > 0.05)
    print(f"output {tuple(pts.shape)} finite, in [-1, 1], std {pts.std().item():.4f}: "
          f"{'ok' if ok else 'FAIL'}")

    fb.reset_launch_counts()
    with fb.use_plain_kernels():
        plain = _sample(pipe, latents=latents)
    plain_launches = dict(fb.LAUNCHES)
    print(f"launches in the plain run: {plain_launches} (expected 0)")
    vs_plain = (pts - plain.point_clouds.float()).abs().mean().item()
    # the int8 path is discontinuous: an f32 ulp (a sum taken in another
    # order) can flip an int8 code, and 48 layers x 25 steps carry each flip
    # on. The floor is the kernel path against itself with the latents
    # moved by 1e-6; a faulty kernel lands far above it.
    shifted = latents + 1e-6 * torch.randn(latents.shape, generator=gen, device=DEV)
    floor = (pts - _sample(pipe, latents=shifted).point_clouds.float()).abs().mean().item()
    pipe.model.quantize = False
    int8_vs_float = (pts - _sample(pipe, latents=latents).point_clouds.float()).abs().mean().item()
    pipe.model.quantize = True
    tol = 2 * floor + 1e-3
    agree = vs_plain <= tol
    print(f"kernels vs plain run: mean |diff| {vs_plain:.3e} (tol 2 x floor + 1e-3 = {tol:.3e}; "
          f"floor {floor:.3e}); for scale, int8 vs float {int8_vs_float:.3e}: "
          f"{'ok' if agree else 'FAIL'}")

    fwd_ok, rel, rel_floor = _forward_vs_plain(pipe, latents, gen, DEPTH)
    report["pipeline"].update(launches=launches, plain_launches=plain_launches,
                              mean_abs_vs_plain=vs_plain, floor_mean_abs=floor,
                              mean_abs_int8_vs_float=int8_vs_float,
                              forward_rel_err=rel, forward_rel_floor=rel_floor,
                              output_ok=ok)
    if not (ok and agree and fwd_ok and counts_ok and not any(plain_launches.values())):
        raise AssertionError("main path check failed")
    return pipe


def _forward_vs_plain(pipe, latents, gen, depth):
    """One forward of the whole stack at the first (CFG) step, kernels vs
    plain on the same inputs, gated at 2 x floor + 1e-3 (floor: kernels vs
    kernels with the inputs moved by 1e-6, ``gen``'s next draw): (ok, mean
    |diff| / mean |pred|, floor)."""
    qp = pipe.serving_qparams()
    text = torch.as_tensor(pipe.encode_prompt(PROMPTS), device=DEV)
    x_in = torch.cat([latents, latents])
    t = torch.full((2 * BATCH,), int(pipe.scheduler.set_timesteps(STEPS).timesteps[0]),
                   device=DEV)
    pred = pipe.model(x_in, t, text, qp)
    with fb.use_plain_kernels():
        pred_plain = pipe.model(x_in, t, text, qp)
    x_shift = x_in + 1e-6 * torch.randn(x_in.shape, generator=gen, device=DEV)
    scale = pred_plain.abs().mean()
    rel = ((pred - pred_plain).abs().mean() / scale).item()
    rel_floor = ((pred - pipe.model(x_shift, t, text, qp)).abs().mean() / scale).item()
    fwd_tol = 2 * rel_floor + 1e-3
    fwd_ok = rel <= fwd_tol
    print(f"one forward ({depth} layers, batch {2 * BATCH}), kernels vs plain: mean |diff| / "
          f"mean |pred| {rel:.3e} (tol 2 x floor + 1e-3 = {fwd_tol:.3e}; floor, kernels vs "
          f"kernels with inputs moved by 1e-6: {rel_floor:.3e}): {'ok' if fwd_ok else 'FAIL'}")
    return fwd_ok, rel, rel_floor


def _nonzero_head(model, gen):
    with torch.no_grad():  # a non-zero head, so the cloud depends on every block
        model.output_proj.weight.copy_(
            torch.randn(model.output_proj.weight.shape, generator=gen, device=DEV) * 0.02)


def _make_per_point_pipeline(quantize):
    """Path A (float): the port's build_pipeline with its defaults
    (pc_d8w768, 2048 points, patch 1, text dim 256). Path B (int8): the same
    model built with quantize=True, which build_pipeline has no switch for."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    if quantize:
        model = NOVAPointCloudTransformer(
            arch=PP_ARCH, point_cloud_size=POINTS, patch_size=PP_PATCH, text_token_dim=256,
            quantize=True, dtype=torch.bfloat16, device=DEV)
        model.init_weights(gen)
        pipe = NOVAPointCloudGenerationPipeline(
            model, DDPMScheduler(beta_schedule="squaredcos_cap_v2"))
    else:
        config = {"pipeline": {"name": "NOVAPointCloudGenerationPipeline"}, "model": {},
                  "scheduler": {"class_name": "DDPMScheduler",
                                "beta_schedule": "squaredcos_cap_v2"}}
        pipe, _ = build_pipeline(config, seed=0, dtype=torch.bfloat16, device=DEV)
        assert (pipe.model.arch, pipe.model.patch_size, pipe.model.num_tokens) == \
            (PP_ARCH, PP_PATCH, PP_T), "build_pipeline's defaults are not the per-point model"
    _nonzero_head(pipe.model, gen)
    pipe.model.to(torch.bfloat16)  # serving: bf16 weights
    pipe.text_encoder = DummyTextEncoder(256, 32)  # build_pipeline leaves it to the caller
    n_params = sum(p.numel() for p in pipe.model.parameters())
    print(f"{PP_ARCH} ({'int8' if quantize else 'float'}): {n_params / 1e6:.1f}M parameters, "
          f"T={PP_T} tokens, batch {PP_BATCH}")
    return pipe


def _per_point_path(label, quantize, expected, tol_fn):
    """One per-point pipeline call with the counts at 0 just before and read
    just after; output checks; the same call under use_plain_kernels(); the
    1e-6-shift floor of the kernel path against itself."""
    pipe = _make_per_point_pipeline(quantize)
    if quantize:
        t0 = time.perf_counter()
        pipe.calibrate(prompt_embeds=pipe.encode_prompt(PP_PROMPTS), num_points=POINTS,
                       num_diffusion_steps=STEPS,
                       generator=torch.Generator(device=DEV).manual_seed(2))
        print(f"calibrate (batch {PP_BATCH}, T={PP_T}): {time.perf_counter() - t0:.1f} s")
    _sample(pipe, seed=9, prompts=PP_PROMPTS)  # warm-up
    gen = torch.Generator(device=DEV).manual_seed(1)
    latents = torch.randn((PP_BATCH, POINTS, 3), generator=gen, device=DEV)
    fb.reset_launch_counts()
    out = _sample(pipe, prompts=PP_PROMPTS, latents=latents)
    launches = dict(fb.LAUNCHES)
    counts_ok = launches == {n: expected.get(n, 0) for n in KERNELS}
    print(f"launches in one {label} call: {launches} (expected {expected}, else 0): "
          f"{'ok' if counts_ok else 'FAIL'}")
    pts, cols = out.point_clouds.float(), out.colors.float()
    ok = (tuple(pts.shape) == (PP_BATCH, POINTS, 3) and bool(torch.isfinite(pts).all())
          and pts.abs().max().item() <= 1.0 and 0.0 <= cols.min().item()
          and cols.max().item() <= 1.0 and pts.std().item() > 0.05)
    print(f"output {tuple(pts.shape)} finite, in [-1, 1], std {pts.std().item():.4f}: "
          f"{'ok' if ok else 'FAIL'}")
    fb.reset_launch_counts()
    with fb.use_plain_kernels():
        plain = _sample(pipe, prompts=PP_PROMPTS, latents=latents)
    plain_launches = dict(fb.LAUNCHES)
    vs_plain = (pts - plain.point_clouds.float()).abs().mean().item()
    shifted = latents + 1e-6 * torch.randn(latents.shape, generator=gen, device=DEV)
    floor = (pts - _sample(pipe, prompts=PP_PROMPTS, latents=shifted).point_clouds.float()
             ).abs().mean().item()
    tol, why = tol_fn(floor)
    agree = vs_plain <= tol
    print(f"{label}: kernels vs plain run: mean |diff| {vs_plain:.3e} (tol {why} = {tol:.3e}; "
          f"floor, kernels vs kernels with latents moved by 1e-6: {floor:.3e}); plain run "
          f"launched {plain_launches}: {'ok' if agree else 'FAIL'}")
    report[label] = dict(launches=launches, plain_launches=plain_launches,
                         mean_abs_vs_plain=vs_plain, floor_mean_abs=floor, tol=tol,
                         output_ok=ok, output_std=pts.std().item())
    for name in expected:
        _record_launches(name, label, launches[name])
    if not (ok and agree and counts_ok and not any(plain_launches.values())):
        raise AssertionError(f"{label} check failed")
    return pipe


PATH_A_LAUNCHES = {"flash_attention": PP_DEPTH * STEPS}
PATH_B_LAUNCHES = {n: PP_DEPTH * STEPS for n in
                   ("fused_ln_int8_matmul", "int8_matmul_residual", "fused_ln_int8_mlp")}
PATH_A_TOL = 6e-3


@phase("4b per-point float path (A)")
def path_a():
    """bf16 float serving is continuous up to bf16 roundings: kernel and
    plain run differ in where P and the output are rounded. Gate: mean
    |diff| of the clouds <= PATH_A_TOL = 6e-3, which is 1e-2 of the output's
    scale (std 0.61 on these weights); measured 1.8e-3, the same as the
    kernel path against itself with the latents moved by 1e-6."""
    return _per_point_path("path_a", False, PATH_A_LAUNCHES,
                           lambda floor: (PATH_A_TOL, "fixed"))


@phase("4c per-point int8 path (B)")
def path_b():
    """int8 is discontinuous (phase 4): gated against its own measured floor."""
    return _per_point_path("path_b", True, PATH_B_LAUNCHES,
                           lambda floor: (2 * floor + 1e-3, "2 x floor + 1e-3"))


T2I_L = {"video": 32 + T2I_VIDEO_BASE[1] * T2I_VIDEO_BASE[2],  # text + video tokens
         "full": 256 + T2I_BASE[0] * T2I_BASE[1]}             # video states + image
T2I_ROWS = 2 * T2I_BATCH  # CFG
T2I_PAD_P = 25  # predicted tokens per AR step (the cosine schedule's largest count)
# int8_linear's rows in the t2i int8 call and its launches at each, qkv and
# out-projection alike: the video encoder's 16 layers at 8 x 288 rows; the
# image encoder's 16 layers at 8 x (256 + the bucket) over the sampler's
# bucket phases (20, 9, 13 and 21 of the 63 AR steps at 128, 256, 512 and
# all 1024 tokens); its decoder's 16 layers at 8 x 1280 in every AR step
T2I_LINEAR_M = {T2I_ROWS * T2I_L["video"]: 16, T2I_ROWS * 384: 320, T2I_ROWS * 512: 144,
                T2I_ROWS * 768: 208, T2I_ROWS * T2I_L["full"]: 1344}


def _linear_operands(gen, m, n, k=D):
    """int8_linear at the ViT's width k (1024 in t2i, 768 in the masked-AR
    model): x (m, k), f32 for the qkv projection (n = 3k, the residual
    stream) and bf16 for the out-projection (n = k, the attention's output);
    the K-major int8 weight (k, n) and its scales, a bf16 bias."""
    x = torch.randn((m, k), generator=gen, device=DEV)
    if n == k:
        x = x.to(torch.bfloat16)
    w, ws = quantize_weight_kmajor(torch.randn((n, k), generator=gen, device=DEV) * k ** -0.5)
    b = (torch.randn((n,), generator=gen, device=DEV) * 0.1).to(torch.bfloat16)
    return x, w, ws, b


def _t2i_mlp_operands(gen, lead, x_dtype=torch.float32, d=D, f=F):
    """fused_int8_mlp_postln at the ViT's width: x (*lead, d) (the image
    encoder's residual stream is f32: flax promotes the bf16 weights' output
    against the f32 canvas), W1 (d, f), W2 (f, d), bf16 vectors; d = 1024,
    f = 4096 in t2i, 768 / 3072 in the masked-AR model."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * std

    bf16 = torch.bfloat16
    x = randn(*lead, d).to(x_dtype)
    w1, s1 = quantize_weight_kmajor(randn(f, d, std=d ** -0.5))
    w2, s2 = quantize_weight_kmajor(randn(d, f, std=f ** -0.5))
    return [x, w1, s1, randn(f, std=0.02).to(bf16), w2, s2, randn(d, std=0.02).to(bf16),
            (1.0 + randn(d, std=0.1)).to(bf16), randn(d, std=0.1).to(bf16)]


def _diffusion_operands(gen, m, d=D):
    """fused_int8_diffusion_block at the head's width d (1024 in t2i, 768
    in the masked-AR model): x, zc (m, d) bf16, Ws (d, 3d), W1, W2 (d, d),
    bf16 vectors; the stats bias is wide enough that scale / shift / gate
    are far from 0 / 0 / 0."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * std

    bf16 = torch.bfloat16
    ws, ss = quantize_weight_kmajor(randn(3 * d, d, std=d ** -0.5))
    w1, s1 = quantize_weight_kmajor(randn(d, d, std=d ** -0.5))
    w2, s2 = quantize_weight_kmajor(randn(d, d, std=d ** -0.5))
    return [randn(m, d).to(bf16), randn(m, d).to(bf16), ws, ss, randn(3 * d, std=0.3).to(bf16),
            w1, s1, randn(d, std=0.02).to(bf16), w2, s2, randn(d, std=0.02).to(bf16),
            (1.0 + randn(d, std=0.1)).to(bf16), randn(d, std=0.1).to(bf16)]


def _static_attention_operands(gen, L, bias_kind, rows=T2I_ROWS, d=64):
    """q, k, v as the ViT hands them over: (B, H, L, d) views of one (B, L,
    3, H, d) bf16 projection; a visibility bias masks ~40% of the keys
    after a 256-key prefix, and every key of sample 1 (a fully masked row)."""
    qkv = torch.randn((rows, L, 3, HEADS, d), generator=gen, device=DEV).to(torch.bfloat16)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = None
    if bias_kind == "visibility":
        keep = torch.rand((rows, 1, 1, L), generator=gen, device=DEV) > 0.4
        keep[..., :256] = True
        bias = torch.where(keep, 0.0, float("-inf"))
        bias[1] = float("-inf")
    return q, k, v, bias


def _t2i_variants(kind):
    s = lambda v: torch.tensor(v, device=DEV)  # noqa: E731
    if kind == "mlp":
        return [("static", dict(a_x=s(4.0), a_gelu=s(3.0))), ("per-row", {})]
    return [("static", dict(a_z=s(4.0), a_h=s(6.0), a_silu=s(3.0))), ("per-row", {})]


@phase("3d t2i kernels vs plain")
def check_nova_kernels():
    """Each NOVA kernel against its plain version at the t2i path's shapes,
    every variant, and the PR 2 flash kernel at the t2i float path's
    (8, 16, 1280, 64) with and without its visibility bias. Tolerances: the
    int8 kernels' (phase 3: max <= 2^-6 max|y|, mean <= 2^-10 mean|y|); for
    both attentions flash bf16's (phase 3c: max <= 2^-6 max|o|, mean <= 2^-8
    mean|o|), and exactly 0 on the fully masked sample."""
    gen = torch.Generator(device=DEV).manual_seed(4242)
    bad = []
    for L in (T2I_L["video"], 300, 768, T2I_L["full"]):  # 300: ragged rows
        for x_dtype in (torch.float32, torch.bfloat16):
            ops = _t2i_mlp_operands(gen, (T2I_ROWS, L), x_dtype)
            for label, kw in _t2i_variants("mlp"):
                y = fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw)
                torch.cuda.synchronize()
                ref = fb.fused_int8_mlp_postln_plain(*ops, ln_eps=1e-5, **kw)
                if not _tol_check("fused_int8_mlp_postln", f"{label} L={L} x={x_dtype}", y, ref,
                                  like=ops[0]):
                    bad.append(f"mlp_postln {label} {L} {x_dtype}")
                del y, ref
            del ops
    for m, x_dtype in ((T2I_ROWS * T2I_PAD_P, torch.bfloat16), (77, torch.bfloat16),
                       (20, torch.bfloat16), (T2I_ROWS * T2I_PAD_P, torch.float32)):
        ops = _diffusion_operands(gen, m)
        ops[0], ops[1] = ops[0].to(x_dtype), ops[1].to(x_dtype)
        for label, kw in _t2i_variants("diffusion"):
            y = fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw)
            torch.cuda.synchronize()
            ref = fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5, **kw)
            if not _tol_check("fused_int8_diffusion_block", f"{label} rows={m} x={x_dtype}", y,
                              ref, like=ops[0]):
                bad.append(f"diffusion {label} {m} {x_dtype}")
    smax = torch.tensor(9.0, device=DEV)
    for L in (T2I_L["video"], 768, T2I_L["full"]):
        for core in ("bf16", "int8"):
            for bias_kind in ("none", "visibility"):
                q, k, v, bias = _static_attention_operands(gen, L, bias_kind)
                kw = (dict(a_q=torch.tensor(4.5, device=DEV), a_k=torch.tensor(4.5, device=DEV))
                      if core == "int8" else {})
                o = fa.flash_attention_static(q, k, v, smax, bias, **kw)
                torch.cuda.synchronize()
                ref = fa.flash_attention_static_plain(q, k, v, smax, bias, **kw)
                label = f"core={core} bias={bias_kind} L={L}"
                ok = _tol_check("flash_attention_static", label, o, ref, 2.0 ** -6, 2.0 ** -8,
                                like=ref)
                if bias is not None:
                    dead_ok = bool((o[1] == 0).all())
                    print(f"    fully masked sample gives 0: {dead_ok}")
                    ok = ok and dead_ok
                if not ok:
                    bad.append(f"static attention {label}")
                del q, k, v, o, ref
    for bias_kind in ("none", "visibility"):  # the t2i float path's flash calls
        q, k, v, bias = _static_attention_operands(gen, T2I_L["full"], bias_kind)
        o = fa.flash_attention(q, k, v, bias)
        torch.cuda.synchronize()
        ref, _ = fa.flash_attention_plain(q, k, v, bias)
        label = f"bias={bias_kind} L={T2I_L['full']}"
        ok = _tol_check("flash_attention", label, o, ref, 2.0 ** -6, 2.0 ** -8, like=ref)
        if bias is not None:
            dead_ok = bool((o[1] == 0).all())
            print(f"    fully masked sample gives 0: {dead_ok}")
            ok = ok and dead_ok
        if not ok:
            bad.append(f"flash_attention {label}")
        del q, k, v, o, ref
    for m in T2I_LINEAR_M:  # the qkv (f32 x) and out (bf16 x) projections, bf16 out
        for n in (3 * D, D):
            x, w, ws, b = _linear_operands(gen, m, n)
            y = fb.int8_linear(x, w, ws, b, torch.bfloat16)
            torch.cuda.synchronize()
            if not _tol_check("int8_linear", f"{m}x{D}->{n} x={x.dtype}", y,
                              fb.int8_linear_plain(x, w, ws, b, torch.bfloat16)):
                bad.append(f"int8_linear {m} {n}")
    torch.cuda.empty_cache()
    bad += _hd96_int8_checks(gen)
    bad += _int8_core_hd96_checks(gen)
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    fb.reset_launch_counts()


def _make_t2i_pipeline(quantize, state_dict=None, attn_core="bf16"):
    """bench.py --mode t2i's model at full width and depth, seeded random
    weights with the zero-initialised AdaLN projections (and the biases)
    filled, so every diffusion block's gate and modulation depend on its
    inputs; bf16 weights and compute dtype, as the bench serves; the static
    attention's score core ``attn_core`` (bench.py --attn-core)."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = NOVATransformer(arch=T2I_ARCH, image_dim=4, image_base_size=T2I_BASE,
                            video_base_size=T2I_VIDEO_BASE, patch_size=2, text_token_dim=256,
                            text_token_len=32, quantize=quantize, attn_core=attn_core,
                            dtype=torch.bfloat16, device=DEV)
    if state_dict is None:
        model.init_weights(gen)
        model.fill_zero_init(gen)
    else:
        model.load_state_dict(state_dict)
    model.to(torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"NOVA t2i {'int8' if quantize else 'float'} {T2I_ARCH}: {n_params / 1e6:.1f}M "
          f"parameters, {model.num_image_tokens} image tokens, batch {T2I_BATCH}")
    return NOVAPipeline(model, FlowMatchEulerScheduler(),
                        text_encoder=DummyTextEncoder(256, 32))


def _t2i_noise(pipe, seed, ar_steps=T2I_AR):
    """The prediction order and every AR step's initial noise, drawn up front
    (the pipeline draws the same from its generator when not given), so the
    comparisons can replay a call with one input moved."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    _, counts, _, pad_p = pipe._schedule(ar_steps, T2I_DIFF)
    ni, pd = pipe.model.num_image_tokens, pipe.model.patch_dim
    order = torch.argsort(torch.rand((T2I_BATCH, ni), generator=gen, device=DEV), dim=1)
    noise = torch.randn((len(counts), T2I_BATCH, pad_p, pd), generator=gen, device=DEV)
    return order, noise


def _t2i_sample(pipe, ar_steps=T2I_AR, seed=1, order=None, noise=None):
    out = pipe(T2I_PROMPTS, num_inference_steps=ar_steps, num_diffusion_steps=T2I_DIFF,
               guidance_scale=T2I_GUIDANCE, guidance_trunc=0.0,
               generator=torch.Generator(device=DEV).manual_seed(seed), order=order,
               noise=noise, output_type="latent")
    torch.cuda.synchronize()
    return out.latents.float()


def _t2i_compare(pipe, label, ar_steps):
    """The call under use_plain_kernels() and the kernel path with every AR
    step's noise moved by 1e-6 (the floor), against the kernel call; gate
    2 x floor + 1e-3."""
    order, noise = _t2i_noise(pipe, seed=3, ar_steps=ar_steps)
    lat = _t2i_sample(pipe, ar_steps, order=order, noise=noise)
    fb.reset_launch_counts()
    with fb.use_plain_kernels():
        plain = _t2i_sample(pipe, ar_steps, order=order, noise=noise)
    plain_launches = dict(fb.LAUNCHES)
    moved = noise + 1e-6 * torch.randn(noise.shape, device=DEV,
                                       generator=torch.Generator(device=DEV).manual_seed(4))
    floor = (lat - _t2i_sample(pipe, ar_steps, order=order, noise=moved)).abs().mean().item()
    vs_plain = (lat - plain).abs().mean().item()
    scale = lat.abs().mean().item()
    tol = 2 * floor + 1e-3
    ok = vs_plain <= tol and not any(plain_launches.values())
    print(f"{label} ({ar_steps} AR steps): kernels vs plain run mean |diff| {vs_plain:.3e} "
          f"(tol 2 x floor + 1e-3 = {tol:.3e}; floor, kernels vs kernels with the AR noise "
          f"moved by 1e-6: {floor:.3e}; "
          f"mean |latent| {scale:.3e}); plain run launched {plain_launches}: "
          f"{'ok' if ok else 'FAIL'}")
    return ok, dict(mean_abs_vs_plain=vs_plain, floor_mean_abs=floor, tol=tol,
                    mean_abs_latent=scale, compare_ar_steps=ar_steps,
                    plain_launches=plain_launches)


def _t2i_step_check(pipe, label, kernel, expected, prompts=T2I_PROMPTS, prompt_embeds=None,
                    batch=T2I_BATCH, pad_p=T2I_PAD_P, tol=1e-3):
    """One image-encoder pass of the masking phase (half the tokens visible,
    256 + 1024 keys: every layer on the path's attention kernel) and one
    diffusion-head eval, kernels against plain, relative mean error gated at
    2 x floor + ``tol`` (floor: kernels against kernels with the canvas and
    x_t moved by 1e-6; ``tol`` 1e-3 for the int8 and bf16 paths, 1e-5 for
    f32); ``expected`` launches of ``kernel`` in the pass.
    ``prompts``: the pipeline's prompts (class ids for c2i), or
    ``prompt_embeds``; ``batch`` prompts, ``pad_p`` tokens a head eval."""
    from nova_pointcloud_tpu_torch.models.guidance import GuidanceConfig

    model, qp = pipe.model, pipe.serving_qparams()
    gen = torch.Generator(device=DEV).manual_seed(11)
    ni, pd, rows = model.num_image_tokens, model.patch_dim, 2 * batch
    with torch.no_grad():
        c = pipe.encode_prompt(prompts, guidance=GuidanceConfig(guidance_scale=T2I_GUIDANCE),
                               prompt_embeds=prompt_embeds)
        cond = model.encode_video(model.bos_frame(rows), c, 1, qparams=qp)
        canvas = torch.randn((batch, ni, pd), generator=gen, device=DEV)
        mask = (torch.rand((batch, ni, 1), generator=gen, device=DEV) < 0.5).float()
        x_t = torch.randn((rows, pad_p, pd), generator=gen, device=DEV)
        t = torch.full((rows,), 500.0, device=DEV)

        def step(cv, xt):
            z = model.encode_image_step(model.tokens_from_patches(cv).repeat(2, 1, 1),
                                        mask.repeat(2, 1, 1), cond, qparams=qp)
            zs = z[:, :pad_p]
            return z.float(), model.denoise_step(xt, t, zs, qparams=qp).float()

        fb.reset_launch_counts()
        z, pred = step(canvas, x_t)
        launches = fb.LAUNCHES[kernel]
        with fb.use_plain_kernels():
            z_p, pred_p = step(canvas, x_t)
        z_m, pred_m = step(canvas + 1e-6 * torch.randn(canvas.shape, generator=gen, device=DEV),
                           x_t + 1e-6 * torch.randn(x_t.shape, generator=gen, device=DEV))
    torch.cuda.synchronize()
    res, ok = {}, launches == expected
    for name, a, p, m in (("encode_image_step", z, z_p, z_m), ("denoise_step", pred, pred_p,
                                                                 pred_m)):
        scale = p.abs().mean()
        rel = ((a - p).abs().mean() / scale).item()
        floor = ((a - m).abs().mean() / scale).item()
        good = bool(torch.isfinite(a).all()) and rel <= 2 * floor + tol
        ok = ok and good
        print(f"{label} one {name}, kernels vs plain: mean |diff| / mean |plain| {rel:.3e} "
              f"(tol 2 x floor + {tol:g} = {2 * floor + tol:.3e}; floor, inputs moved by 1e-6: "
              f"{floor:.3e}): {'ok' if good else 'FAIL'}")
        res[name] = dict(rel_err=rel, rel_floor=floor)
    print(f"{label} one step: {launches} {kernel} launches (expected {expected}): "
          f"{'ok' if launches == expected else 'FAIL'}")
    return ok, res


def _t2i_call_counted(pipe, label, expected):
    """One call at the bench shape with the counts at 0 just before and read
    just after; output checks."""
    fb.reset_launch_counts()
    lat = _t2i_sample(pipe, seed=1)
    launches = dict(fb.LAUNCHES)
    counts_ok = launches == {n: expected.get(n, 0) for n in KERNELS}
    print(f"launches in one {label} call: {launches} (expected {expected}, else 0): "
          f"{'ok' if counts_ok else 'FAIL'}")
    shape = (T2I_BATCH, 2 * T2I_BASE[0], 2 * T2I_BASE[1], 4)
    ok = (tuple(lat.shape) == shape and bool(torch.isfinite(lat).all())
          and lat.std().item() > 0.05)
    print(f"latents {tuple(lat.shape)} finite, std {lat.std().item():.4f}: "
          f"{'ok' if ok else 'FAIL'}")
    for name in expected:
        _record_launches(name, label, launches[name])
    return counts_ok and ok, dict(launches=launches, output_ok=ok,
                                  output_std=lat.std().item())


S_T2I = 63  # non-empty AR steps of 64 over 1024 tokens
T2I_INT8_LAUNCHES = {
    "flash_attention_static": T2I_V_LAYERS + T2I_VIT_LAYERS * S_T2I,
    "fused_int8_mlp_postln": T2I_V_LAYERS + T2I_VIT_LAYERS * S_T2I,
    "fused_int8_diffusion_block": T2I_DIFF_BLOCKS * T2I_DIFF * S_T2I,
    "int8_linear": 2 * (T2I_V_LAYERS + T2I_VIT_LAYERS * S_T2I)}


def _flash_route_launches(pipe, ar_steps=T2I_AR, text_len=32):
    """flash_attention launches of one float image call (T = 1) by the
    dispatcher's rule (ops/attention.flash_route), from the model's sizes:
    the video encoder's layers see the text prefix + the video tokens once;
    per AR step the image encoder's decoder half sees the video states + all
    image tokens, its encoder half the video states + its visible bucket in
    the gather phases and + all image tokens in the masking phase. Each
    layer with >= 1024 keys (and its K / V under the byte cap) launches once.
    bench.py --mode t2i: 288 video keys, 256 + 128 / 256 / 512 / 1024 image
    keys."""
    from nova_pointcloud_tpu_torch.ops.attention import flash_route
    from nova_pointcloud_tpu_torch.pipelines.nova import bucket_plan

    model = pipe.model
    _, counts, starts, _ = pipe._schedule(ar_steps, T2I_DIFF)
    ni, nv = model.num_image_tokens, model.num_video_tokens
    vit_v, vit_i = model.video_encoder, model.image_encoder
    lv, full = text_len + nv, nv + ni
    n = (len(vit_v.enc_layers) + len(vit_v.dec_layers)) * flash_route(
        lv, lv, model.head_dim_v, None, "auto", True)
    for s_b, s_e, bucket in bucket_plan(starts, ni) or [(0, len(counts), None)]:
        lk = nv + (ni if bucket is None else bucket)
        enc = flash_route(lk, lk, model.head_dim_i, (2, 1, 1, lk), "auto", True)
        dec = flash_route(full, full, model.head_dim_i, None, "auto", True)
        n += (s_e - s_b) * (len(vit_i.enc_layers) * enc + len(vit_i.dec_layers) * dec)
    return n


@phase("4d t2i int8 path")
def t2i_int8():
    pipe = _make_t2i_pipeline(quantize=True)
    t0 = time.perf_counter()
    fb.reset_launch_counts()
    pipe.calibrate(T2I_PROMPTS, num_inference_steps=T2I_CAL_AR, num_diffusion_steps=T2I_DIFF,
                   guidance_scale=T2I_GUIDANCE,
                   generator=torch.Generator(device=DEV).manual_seed(2), margin=1.05)
    torch.cuda.synchronize()
    cal_launches = {k: v for k, v in fb.LAUNCHES.items() if v}
    print(f"calibrate ({T2I_CAL_AR} AR steps, plain mirrors, the dispatcher's attention): "
          f"{time.perf_counter() - t0:.1f} s, launches {cal_launches}")
    _t2i_sample(pipe, ar_steps=4, seed=9)  # warm-up: kernel loads, allocator
    ok, rec = _t2i_call_counted(pipe, "t2i_int8", T2I_INT8_LAUNCHES)
    agree, cmp = _t2i_compare(pipe, "t2i_int8", T2I_CMP_AR)
    step_ok, step = _t2i_step_check(pipe, "t2i_int8", "flash_attention_static",
                                    T2I_VIT_LAYERS)
    report["t2i_int8"] = dict(rec, calibration_launches=cal_launches, one_step=step, **cmp)
    if not (ok and agree and step_ok):
        raise AssertionError("t2i int8 check failed")
    return pipe


@phase("4e t2i float path")
def t2i_float(pipe_int8):
    """quantize=False on the same weights: the dispatcher's attention, the
    flash kernel from 1024 keys. The whole bf16 float call is chaotic on
    these random weights (CFG 5, 63 AR steps): the kernel path against
    itself with the noise moved by 1e-6 differs by about the latents' own
    size (PERF.md), so no whole-call comparison with the plain run can
    gate it. The flash kernel is held at this path's shapes in phase 3d;
    here the one-step check (one encoder pass, every layer on the flash
    kernel, and one head eval) holds the path against plain, as phase 4's
    one forward."""
    if pipe_int8 is None:
        raise AssertionError("no t2i weights: the int8 path failed")
    pipe = _make_t2i_pipeline(quantize=False, state_dict=pipe_int8.model.state_dict())
    expected = _flash_route_launches(pipe)
    print(f"flash_attention launches by the dispatcher's >= {1024}-key rule: {expected}")
    _t2i_sample(pipe, ar_steps=4, seed=9)  # warm-up
    ok, rec = _t2i_call_counted(pipe, "t2i_float", {"flash_attention": expected})
    step_ok, step = _t2i_step_check(pipe, "t2i_float", "flash_attention", T2I_VIT_LAYERS)
    report["t2i_float"] = dict(rec, expected_flash=expected, one_step=step)
    if not (ok and step_ok and expected == 1344):
        raise AssertionError("t2i float check failed")
    return pipe


def _bwd_kernel(dt, d=64):
    """The kernel a gradient of the backward is held against: the bf16 or
    the f32 route's one-pass kernel at head dim 64 or 96."""
    name = "flash_attention_bwd_dkvq" if dt == torch.bfloat16 else "flash_attention_bwd_f32"
    return name + "96" if d == XL_HD and dt == torch.bfloat16 else (
        name + "_96" if d == XL_HD else name)


def _bwd_check(label, q, k, v, bias, dt, gen, dead=None):
    """One flash forward + backward through the kernels against the plain
    backward on the kernels' own (o, lse) and the same do; ``dead``: a
    sample whose keys are all masked, its gradients exactly 0."""
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o, lse = fa.flash_attention_with_lse(*ins, bias)
    do = torch.randn(o.shape, generator=gen, device=DEV).to(dt)
    grads = torch.autograd.grad(o, ins, do)
    torch.cuda.synchronize()
    kb, fbias = fa._normalize_bias(bias, q.shape[0], q.shape[2], k.shape[2])
    ref = fa.flash_attention_bwd_plain(q, k, v, kb, fbias, o.detach(), lse, do)
    rel = (2.0 ** -6, 2.0 ** -8) if dt == torch.bfloat16 else (1e-4, 1e-5)
    ok = True
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        ok = _tol_check(_bwd_kernel(dt, q.shape[-1]), f"{name} {label}", g, r, *rel,
                        like=r) and ok
        if dead is not None:
            zero = bool((g[dead] == 0).all())
            print(f"    {name} of the fully masked sample exactly 0: {zero}")
            ok = ok and zero
    return ok


def _prep_cast_check(q, k, v, dt, gen):
    """The prep kernel against its plain version (delta in XLA's order, lse
    rows; exact: the same f32 operations in the same order) and, in bf16,
    the cast kernel against its plain version on the dkvq kernel's own
    workspace (exact: one rounding)."""
    b, h, lq, _ = q.shape
    o, lse = fa.flash_attention_with_lse(q, k, v)
    do = torch.randn(o.shape, generator=gen, device=DEV).to(dt)
    launches, grads = fa._bwd_operands(q, k, v, None, None, o, lse, do)
    fa.run_bwd(launches, ("flash_attention_bwd_prep",))
    lse_rows, delta = launches[0][3][3:5]
    ref_lse, ref_delta = fa.bwd_prep_plain(o, do, lse, fa.bwd_plan(b, h, lq, lq)["lqp"],
                                           dt == torch.bfloat16)
    tag = f"{str(dt)[6:]} {tuple(q.shape)}, exact"
    ok = _tol_check("flash_attention_bwd_prep", f"delta {tag}", delta, ref_delta, 0.0, 0.0)
    ok = _tol_check("flash_attention_bwd_prep", f"lse rows {tag}", lse_rows, ref_lse,
                    0.0, 0.0) and ok
    if dt == torch.bfloat16:
        fa.run_bwd(launches, ("flash_attention_bwd_dkvq",))
        ws = launches[1][3][8].clone()
        fa.run_bwd(launches, ("flash_attention_bwd_dq_cast",))
        ok = _tol_check("flash_attention_bwd_dq_cast", f"dq {tag}", grads[0],
                        fa.bwd_dq_cast_plain(ws, b, h, lq, q.shape[-1] ** -0.5), 0.0, 0.0,
                        like=grads[0]) and ok
    return ok


def _bwd_repeatability(q, k, v, gen):
    """Two backward runs on the same tensors (bf16 or f32): dk and dv bitwise
    equal (a gate: each block sums them in a fixed order and writes them
    once); dq's largest difference printed (a reading: the f32 reduce-adds
    of the dQ parts run in no fixed order)."""
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*ins)
    do = torch.randn(o.shape, generator=gen, device=DEV).to(q.dtype)
    g1 = torch.autograd.grad(o, ins, do, retain_graph=True)
    g2 = torch.autograd.grad(o, ins, do)
    torch.cuda.synchronize()
    dq_diff = (g1[0].float() - g2[0].float()).abs().max().item()
    same = all(torch.equal(a, b) for a, b in zip(g1[1:], g2[1:]))
    tag = str(q.dtype)[6:]
    print(f"  repeatability, two {tag} backward runs on the same tensors {tuple(q.shape)}: max "
          f"|dq1 - dq2| {dq_diff:.3e} (dq max {g1[0].float().abs().max().item():.3e}; reading); "
          f"dk and dv bitwise equal: {same}")
    report.setdefault("bwd_repeatability", {})[tag] = dict(dq_max_abs_diff=dq_diff,
                                                           dk_dv_equal=same)
    return same


@phase("3e flash backward vs plain")
def check_flash_backward():
    """The backward kernels at the training shape (8, 16, 1280, 64), bf16
    (prep, dkvq, cast) and f32 (prep, dK/dV, dQ), every bias form, and a
    ragged Lq != Lk off the tiles. The plain version gets the kernels' own
    forward output and lse. Tolerances: bf16 as the flash forward's (max <=
    2^-6 max|g|, mean <= 2^-8 mean|g|: the kernels round p and ds to bf16
    as wgmma operands, the plain version only its outputs); f32 1e-4 / 1e-5
    relative (f32 sums in another order); a fully masked sample's gradients
    exactly 0; the prep and cast kernels exact against their plain versions;
    dk and dv of two runs bitwise equal."""
    gen = torch.Generator(device=DEV).manual_seed(31)
    L, bad = T2I_L["full"], []
    for dt in (torch.bfloat16, torch.float32):
        for kind in ("none", "visibility", "full"):
            q, k, v, bias = _static_attention_operands(
                gen, L, "visibility" if kind == "visibility" else "none")
            q, k, v = q.to(dt), k.to(dt), v.to(dt)
            if kind == "full":
                bias = _flash_bias(gen, "full", T2I_ROWS, L, L)
            label = f"bias={kind} {str(dt)[6:]} (8, 16, {L}, 64)"
            if not _bwd_check(label, q, k, v, bias, dt, gen,
                              dead=1 if kind == "visibility" else None):
                bad.append(label)
            if kind == "none":
                if not _prep_cast_check(q, k, v, dt, gen):
                    bad.append(f"prep / cast {str(dt)[6:]}")
                if not _bwd_repeatability(q, k, v, gen):
                    bad.append(f"dk, dv repeatability {str(dt)[6:]}")
            del q, k, v, bias
        q, k, v = _flash_operands(gen, 2, HEADS, 1000, 1531, 64, dt)
        bias = _flash_bias(gen, "key", 2, 1000, 1531)
        label = f"bias=key {str(dt)[6:]} Lq=1000 Lk=1531"
        if not _bwd_check(label, q, k, v, bias, dt, gen):
            bad.append(label)
        torch.cuda.empty_cache()
    bad += _hd96_backward_checks(gen)
    bad += _f32_hd96_backward_checks(gen)
    if bad:
        raise AssertionError(f"the flash backward disagrees with its plain version: {bad}")
    fb.reset_launch_counts()


def _train_model(dtype=torch.bfloat16, state_dict=None):
    """bench.py --mode train --train-arch t2i's model at full width and
    depth: f32 master weights, ``dtype`` compute, remat on; seeded
    init_weights (the JAX initialisers' zero AdaLN) unless a state dict is
    given."""
    model = NOVATransformer(arch=T2I_ARCH, image_dim=4, image_base_size=T2I_BASE,
                            video_base_size=T2I_VIDEO_BASE, patch_size=2, text_token_dim=256,
                            text_token_len=32, noise_scheduler=FlowMatchEulerScheduler(),
                            remat=True, dtype=dtype, device=DEV)
    if state_dict is None:
        model.init_weights(torch.Generator(device=DEV).manual_seed(0))
    else:
        model.load_state_dict(state_dict)
    return model


def _train_pipe(model):
    opt = build_optimizer(model, constant_lr(TRAIN_LR), weight_decay=0.02, betas=(0.9, 0.95))
    return NOVATrainT2IPipeline(model, optimizer=opt, ema_decay=None, log_every=1)


def _train_batch(seed):
    """Batch 8 in the records layout: fp16 VAE moments (mean N(0, 0.8^2),
    logvar -6) and f32 caption embeddings N(0, 1)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lat = (TRAIN_BATCH, 2 * T2I_BASE[0], 2 * T2I_BASE[1], 4)
    return {"moments": torch.cat([torch.randn(lat, generator=gen, device=DEV) * 0.8,
                                  torch.full(lat, -6.0, device=DEV)], -1).half(),
            "text_embeds": torch.randn((TRAIN_BATCH, 32, 256), generator=gen, device=DEV)}


def _train_draws(model, seed):
    """Every random draw of one step, fixed: latent eps, prompt drop, mask,
    timesteps, noise."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    ni, rows = model.num_image_tokens, model.loss_repeat * TRAIN_BATCH
    lat = (TRAIN_BATCH, 2 * T2I_BASE[0], 2 * T2I_BASE[1], 4)
    mask, _ = masking.sample_train_mask(gen, TRAIN_BATCH, ni, device=DEV)
    return {"latent_eps": torch.randn(lat, generator=gen, device=DEV),
            "drop": torch.rand((TRAIN_BATCH,), generator=gen, device=DEV) < 0.1, "mask": mask,
            "timesteps": model.noise_scheduler.sample_timesteps(gen, (rows, ni), device=DEV),
            "noise": torch.randn((rows, ni, model.patch_dim), generator=gen, device=DEV)}


def _step_grads(pipe, batch, draws):
    """Loss and gradients (f32, name -> tensor) of one step; no update."""
    pipe.trainer.optimizer.zero_grad()
    loss, _ = pipe.loss_fn(batch, None, draws=draws)
    loss.backward()
    grads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.detach().float())
             for n, p in pipe.model.named_parameters()}
    pipe.trainer.optimizer.zero_grad()
    return float(loss.detach()), grads


def _rel_l2(a, b, label=None):
    """Relative L2 distance of two gradient dicts as one vector; with a
    ``label``, prints the three tensors that hold most of the difference."""
    diff = {n: float(torch.sum(torch.square(a[n] - b[n]))) for n in b}
    num, den = sum(diff.values()), sum(float(torch.sum(torch.square(b[n]))) for n in b)
    if label is not None:
        top = sorted(diff, key=diff.get, reverse=True)[:3]
        print(f"  {label}: most of the difference in " + ", ".join(
            f"{n} ({diff[n] / max(num, 1e-30):.0%})" for n in top))
    return (num / max(den, 1e-30)) ** 0.5


def _checked_step_grads(pipe, batch, draws, expected_calls):
    """``_step_grads`` with every backward call of the step also run by the
    plain backward on the call's own tensors and held to it at the flash
    bf16 tolerance (quietly recorded); prints the worst error / tolerance
    of dq, dk and dv over the calls. Returns (loss, grads, ok: exactly
    ``expected_calls`` calls, each within tolerance; the worst error /
    tolerance of dq, dk and dv)."""
    calls = []  # per backward call: (ok, worst err / tol of dq, dk, dv, q's shape)
    launch_bwd = fa._launch_bwd

    def check(*args):
        grads = launch_bwd(*args)
        ref = fa.flash_attention_bwd_plain(*args)
        ok, worst = True, []
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            ok = _tol_check(_bwd_kernel(g.dtype, g.shape[-1]),
                            f"{name} of the step's backward call {len(calls) + 1} (do strides "
                            f"{tuple(args[-1].stride())})", g, r, 2.0 ** -6, 2.0 ** -8, like=r,
                            quiet=True) and ok
            c = report["checks"][-1]
            worst.append(max(c["max_abs_err"] / max(c["tol_max"], 1e-30),
                             c["mean_abs_err"] / max(c["tol_mean"], 1e-30)))
        calls.append((ok, worst, tuple(args[0].shape)))
        return grads

    fa._launch_bwd = check
    try:
        loss, grads = _step_grads(pipe, batch, draws)
    finally:
        fa._launch_bwd = launch_bwd
    ok = len(calls) == expected_calls and all(c[0] for c in calls)
    worst = [max((c[1][i] for c in calls), default=float("nan")) for i in range(3)]
    print(f"  every backward call of the step ({len(calls)}, expected {expected_calls}; shapes "
          f"{sorted(set(c[2] for c in calls))}) vs the plain backward on its own tensors, flash "
          f"bf16 tolerance: worst error / tolerance dq {worst[0]:.3f}, dk {worst[1]:.3f}, dv "
          f"{worst[2]:.3f}; failing calls {[i + 1 for i, c in enumerate(calls) if not c[0]]}: "
          f"{'ok' if ok else 'FAIL'}")
    return loss, grads, ok, worst


@phase("4f t2i training")
def t2i_train():
    model = _train_model()
    n_params = sum(p.numel() for p in model.parameters())
    pipe = _train_pipe(model)
    print(f"NOVA t2i training {T2I_ARCH}: {n_params / 1e6:.1f}M parameters (f32 master, bf16 "
          f"compute, remat), batch {TRAIN_BATCH}, {model.num_image_tokens} image tokens")
    batch = _train_batch(1)
    pipe.train(iter([batch]), 1)  # warm-up: kernel loads, allocator, Adam state
    fb.reset_launch_counts()
    out = pipe.train(iter([_train_batch(2)]), pipe.trainer.step + 1)
    torch.cuda.synchronize()
    launches = dict(fb.LAUNCHES)
    counts_ok = launches == {n: TRAIN_LAUNCHES.get(n, 0) for n in KERNELS}
    print(f"launches in one training step: {launches} (expected {TRAIN_LAUNCHES}, else 0): "
          f"{'ok' if counts_ok else 'FAIL'}")
    for name, n in TRAIN_LAUNCHES.items():
        _record_launches(name, "t2i_train", launches[name])
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    print(f"step loss {out['loss']:.4f}, parameters finite after the steps: {finite}")

    # one step's gradients on fixed draws. (a) Every backward call of the
    # step: the kernels on the step's own tensors against the plain backward
    # at the flash bf16 tolerance; this holds the bf16 kernels on the path.
    # (b) f32 kernels vs f32 plain, floor the f32 plain step against itself
    # with the latents moved by 1e-6. (c) A reading, not a gate: bf16 kernels
    # vs bf16 plain beside the plain bf16 step's distance from the plain f32
    # step, which exceeds 1 on these random weights (the 32-layer post-LN
    # ViT's bf16 gradient is chaotic), so no tolerance built on it can fail.
    draws = _train_draws(model, 3)
    loss_k, g_k, in_path, worst = _checked_step_grads(pipe, batch, draws, TRAIN_FLASH_LAYERS)
    grads_finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    with fb.use_plain_kernels():
        loss_p, g_p = _step_grads(pipe, batch, draws)
    twin = _train_pipe(_train_model(None, model.state_dict()))
    fb.reset_launch_counts()
    loss_32k, g_32k = _step_grads(twin, batch, draws)
    torch.cuda.synchronize()
    launches32 = dict(fb.LAUNCHES)
    counts32_ok = launches32 == {n: TRAIN_F32_LAUNCHES.get(n, 0) for n in KERNELS}
    print(f"launches in the f32 step's loss and gradients: {launches32} (expected "
          f"{TRAIN_F32_LAUNCHES}, else 0): {'ok' if counts32_ok else 'FAIL'}")
    _record_launches("flash_attention_bwd_f32", "t2i_train_f32",
                     launches32["flash_attention_bwd_f32"])
    _instance_launches("flash_attention", "f32 hd 64", "t2i_train_f32",
                       launches32["flash_attention"])
    moved = dict(draws, latent_eps=draws["latent_eps"] + 1e-6 * torch.randn(
        draws["latent_eps"].shape, generator=torch.Generator(device=DEV).manual_seed(4),
        device=DEV))
    with fb.use_plain_kernels():
        loss_32, g_32 = _step_grads(twin, batch, draws)
        _, g_32m = _step_grads(twin, batch, moved)
    del twin
    vs_plain, floor = _rel_l2(g_k, g_p, "kernels vs plain"), _rel_l2(g_p, g_32, "bf16 vs f32")
    vs_plain32, floor32 = _rel_l2(g_32k, g_32), _rel_l2(g_32m, g_32)
    del g_p, g_32, g_32k, g_32m
    torch.cuda.empty_cache()
    tol32 = 2 * floor32 + 1e-6
    grad_ok = grads_finite and np.isfinite(loss_k) and in_path and vs_plain32 <= tol32
    print(f"one step's gradients (relative L2 of the whole vector): f32 kernels vs plain "
          f"{vs_plain32:.3e} (tol 2 x floor + 1e-6 = {tol32:.3e}; floor, f32 plain vs itself "
          f"with the latents moved by 1e-6: {floor32:.3e}); finite: {grads_finite}: "
          f"{'ok' if grad_ok else 'FAIL'}")
    print(f"  reading, no gate: bf16 kernels vs plain {vs_plain:.3e} beside the plain bf16 "
          f"step's distance from the plain f32 step {floor:.3e} (over 1: the bf16 gradient "
          f"is chaotic on these weights); losses {loss_k:.6f} / plain {loss_p:.6f} / f32 "
          f"{loss_32k:.6f} / f32 plain {loss_32:.6f}")

    # the loss of one fixed batch with fixed draws falls
    losses = [float(pipe.trainer.train_step(batch, draws=draws)["loss"])
              for _ in range(TRAIN_FALL_STEPS)]
    fall_ok = all(np.isfinite(losses)) and losses[-1] < losses[0]
    print(f"fixed batch and draws, {TRAIN_FALL_STEPS} steps: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f} ({[round(x, 5) for x in losses]}): {'ok' if fall_ok else 'FAIL'}")
    report["t2i_train"] = dict(params_m=n_params / 1e6, launches=launches,
                               launches_f32_step=launches32,
                               in_path_worst_err_over_tol=worst,
                               grad_bf16_reading_vs_plain=vs_plain,
                               grad_bf16_reading_plain_vs_f32=floor,
                               grad_f32_rel_l2_vs_plain=vs_plain32, grad_f32_floor=floor32,
                               losses=losses, step_loss=out["loss"])
    if not (counts_ok and counts32_ok and finite and grad_ok and fall_ok):
        raise AssertionError("t2i training check failed")
    return pipe


def _pc_model(dropout=0.1, attn_impl="auto", state_dict=None, seed=0):
    """The training script's model on the card: f32, remat; seeded
    init_weights (zero output head) unless a state dict is given."""
    model = NOVAPointCloudTransformer(arch=PC_TRAIN_ARCH, point_cloud_size=PC_TRAIN_POINTS,
                                      patch_size=1, text_token_dim=256, dropout=dropout,
                                      remat=True, attn_impl=attn_impl, device=DEV)
    if state_dict is None:
        model.init_weights(torch.Generator(device=DEV).manual_seed(seed))
    else:
        model.load_state_dict(state_dict)
    return model


def _pc_normalizer():
    """Fitted on 64 synthetic clouds, as the script fits it without a
    dataset."""
    return GlobalNormalizer().fit(
        [s["points"] for s in make_synthetic_clouds(64, PC_TRAIN_POINTS, 0)])


def _pc_batch(norm, seed):
    """The script's first fresh batch from ``seed``: 16 synthetic clouds
    normalized and clipped to [-1, 1], prompts dropped with probability 0.1."""
    return next(train_pointcloud.fresh_batches(norm, PC_TRAIN_BATCH, PC_TRAIN_POINTS, seed, 0.1,
                                               np.random.RandomState(seed + 1234)))


def _pc_pipe(model, norm, output_dir=None):
    """The script's pipeline: its optimizer chain, loss, EMA and schedule."""
    opt, schedule = train_pointcloud.build_optimizer(model, PC_TRAIN_LR)
    return NOVATrainPointCloudPipeline(
        model, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
        text_encoder=DummyTextEncoder(256, 16), normalizer=norm, output_dir=output_dir,
        optimizer=opt, loss_config=PointCloudLossConfig(num_subsets=16), max_steps=10000,
        log_every=20, save_every=0, ema_decay=0.99, ema_every=10, lr_schedule=schedule, seed=0)


def _pc_draws(model, seed):
    """Every draw of one step, fixed: timesteps, noise, dropout (the
    ClusterBlock's mask and one seed a block), the partition."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    shape = (PC_TRAIN_BATCH, PC_TRAIN_POINTS, 3)
    draws = {"t": DDPMScheduler().sample_timesteps(gen, (PC_TRAIN_BATCH,)),
             "noise": torch.randn(shape, generator=gen, device=DEV),
             "dropout_masks": model.draw_dropout(gen, PC_TRAIN_BATCH)}
    draws["subset_ids"] = dynamic_partition(gen, PC_TRAIN_POINTS, 16)[1]
    return draws


def _pc_step_grads(model, batch, draws):
    """Loss and gradients (name -> tensor) of one step; no update."""
    loss_fn = make_pc_loss_fn(model, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
                              PointCloudLossConfig(num_subsets=16))
    for p in model.parameters():
        p.grad = None
    loss, _ = loss_fn(batch, None, **draws)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return float(loss.detach()), grads


def _pc_state_equal(a, b):
    """Names of the trainer state that differ bitwise: parameters, Adam
    moments, the adaptive multiplier, EMA, step count."""
    bad = [n for (n, p), (_, q) in zip(a.model.named_parameters(), b.model.named_parameters())
           if not torch.equal(p, q)]
    sa, sb = a.trainer.optimizer.state_dict(), b.trainer.optimizer.state_dict()
    bad += [f"adam {i} {k}" for i, st in sa["adam"]["state"].items()
            for k in ("exp_avg", "exp_avg_sq") if not torch.equal(st[k], sb["adam"]["state"][i][k])]
    if not torch.equal(sa["transforms"][1]["multiplier"], sb["transforms"][1]["multiplier"]):
        bad.append("multiplier")
    bad += [f"ema {n}" for n, e in a.trainer.ema.params.items()
            if not torch.equal(e, b.trainer.ema.params[n])]
    if (sa["count"], a.trainer.step) != (sb["count"], b.trainer.step):
        bad.append("step")
    return bad


@phase("4g t2pc training")
def pc_train():
    import shutil

    shutil.rmtree(PC_TRAIN_DIR, ignore_errors=True)
    norm = _pc_normalizer()
    # the script's main at its defaults, cut to 2 steps and a small eval
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_pointcloud.main(["--output-dir", os.path.join(PC_TRAIN_DIR, "script")]
                                + PC_SCRIPT_ARGS, device=DEV)
    torch.cuda.synchronize()
    script_launches = dict(fb.LAUNCHES)
    script_ok = (out["step"] == 2 and np.isfinite(out["best_metric"])
                 and script_launches == {n: PC_SCRIPT_LAUNCHES.get(n, 0) for n in KERNELS})
    print(f"train_pointcloud.main (2 steps, validation, sampled CD of 4 shapes at 5 steps): "
          f"{out} in {time.perf_counter() - t0:.1f} s; launches {script_launches} (expected "
          f"{PC_SCRIPT_LAUNCHES}, else 0): {'ok' if script_ok else 'FAIL'}")
    _record_launches("flash_attention", "t2pc_train_script", script_launches["flash_attention"])

    # (a) one fixed batch with fixed draws, the default step (plain core)
    model = _pc_model()
    n_params = sum(p.numel() for p in model.parameters())
    ckpt_dir = os.path.join(PC_TRAIN_DIR, "ckpt")
    pipe = _pc_pipe(model, norm, ckpt_dir)
    batch = pipe.encode_batch(_pc_batch(norm, 1))
    draws = _pc_draws(model, 2)
    print(f"t2pc training {PC_TRAIN_ARCH}: {n_params / 1e6:.1f}M parameters (f32, remat, dropout "
          f"0.1), batch {PC_TRAIN_BATCH}, {PC_TRAIN_POINTS} points")
    fb.reset_launch_counts()
    metrics = [pipe.trainer.train_step(batch, **draws) for _ in range(PC_TRAIN_SAVE_AT)]
    torch.cuda.synchronize()
    launches = dict(fb.LAUNCHES)
    # (c) save after step 19; a fresh trainer (another init) resumes from it
    t0 = time.perf_counter()
    pipe.trainer.save()
    twin = _pc_pipe(_pc_model(seed=1), norm, ckpt_dir)
    ckpt_s = time.perf_counter() - t0
    metrics.append(pipe.trainer.train_step(batch, **draws))
    twin_out = twin.trainer.train_step(batch, **draws)
    torch.cuda.synchronize()
    differ = _pc_state_equal(pipe, twin)
    resume_ok = twin.trainer.step == pipe.trainer.step == PC_TRAIN_FALL_STEPS and not differ \
        and float(twin_out["loss"]) == float(metrics[-1]["loss"])
    print(f"(c) checkpoint after step {PC_TRAIN_SAVE_AT}, saved and resumed in {ckpt_s:.1f} s: "
          f"step {PC_TRAIN_FALL_STEPS} of the resumed trainer bitwise the uninterrupted one's "
          f"(parameters, Adam moments, multiplier, EMA): differing {differ[:5]}: "
          f"{'ok' if resume_ok else 'FAIL'}")
    del twin
    losses = [float(m["loss"]) for m in metrics]
    finite = all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values())
    nonfinite = sum(float(m["nonfinite_loss"]) for m in metrics)
    fall_ok = finite and nonfinite == 0 and losses[-1] < losses[0] \
        and launches == dict.fromkeys(KERNELS, 0)
    print(f"(a) fixed batch and draws, {PC_TRAIN_FALL_STEPS} steps: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, every metric finite: {finite}, nonfinite_loss {nonfinite}, "
          f"launches {launches} (plain core: none): {'ok' if fall_ok else 'FAIL'}")
    print("  last step's metrics: " + ", ".join(f"{k} {float(v):.5f}"
                                                for k, v in metrics[-1].items()))

    # (b) dropout 0: the dispatcher's flash route against the plain core
    gen = torch.Generator(device=DEV).manual_seed(5)
    m_auto = _pc_model(dropout=0.0, state_dict=model.state_dict())
    _nonzero_head(m_auto, gen)  # so every block's gradient is non-zero
    m_xla = _pc_model(dropout=0.0, attn_impl="xla", state_dict=m_auto.state_dict())
    d0 = _pc_draws(m_auto, 3)
    fb.reset_launch_counts()
    loss_k, g_k = _pc_step_grads(m_auto, batch, d0)
    torch.cuda.synchronize()
    launches0 = dict(fb.LAUNCHES)
    counts_ok = launches0 == {n: PC_TRAIN_F32_LAUNCHES.get(n, 0) for n in KERNELS}
    print(f"(b) launches in the dropout-0 step's loss and gradients: {launches0} (expected "
          f"{PC_TRAIN_F32_LAUNCHES}, else 0): {'ok' if counts_ok else 'FAIL'}")
    for name, n in PC_TRAIN_F32_LAUNCHES.items():
        _record_launches(name, "t2pc_train_dropout0", launches0[name])
    loss_p, g_p = _pc_step_grads(m_xla, batch, d0)
    moved = dict(d0, noise=d0["noise"] + 1e-6 * torch.randn(
        d0["noise"].shape, generator=gen, device=DEV))
    _, g_m = _pc_step_grads(m_xla, batch, moved)
    vs, floor = _rel_l2(g_k, g_p, "flash vs plain core"), _rel_l2(g_m, g_p)
    tol = 2 * floor + 1e-6
    grads_finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    grad_ok = counts_ok and grads_finite and vs <= tol
    print(f"(b) one dropout-0 step's gradient (relative L2 of the whole vector): "
          f"attn_impl='auto' (f32 flash) vs 'xla' {vs:.3e} (tol 2 x floor + 1e-6 = {tol:.3e}; "
          f"floor, 'xla' vs itself with the noise moved by 1e-6: {floor:.3e}); losses "
          f"{loss_k:.6f} / {loss_p:.6f}; finite: {grads_finite}: {'ok' if grad_ok else 'FAIL'}")
    del m_xla, g_k, g_p, g_m

    # (d) the evaluator over the bf16 generation pipeline, EMA weights
    eval_model = NOVAPointCloudTransformer(
        arch=PC_TRAIN_ARCH, point_cloud_size=PC_TRAIN_POINTS, patch_size=1, text_token_dim=256,
        dropout=0.0, dtype=torch.bfloat16, device=DEV).to(torch.bfloat16)
    eval_model.load_state_dict(pipe.trainer.ema.params)
    eval_pipe = NOVAPointCloudGenerationPipeline(
        eval_model, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
        text_encoder=DummyTextEncoder(256, 16))
    shapes = make_synthetic_clouds(PC_EVAL_PROMPTS, PC_TRAIN_POINTS, 7)
    refs = np.clip(norm.normalize(np.stack([s["points"] for s in shapes])), -1.0, 1.0)
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    res = PointCloudEvaluator(eval_pipe).run(
        [s["prompt"] for s in shapes], refs, guidance_scales=PC_EVAL_GUIDANCE,
        num_points=PC_TRAIN_POINTS, num_diffusion_steps=STEPS,
        generator=torch.Generator(device=DEV).manual_seed(7))
    eval_s = time.perf_counter() - t0
    eval_launches = dict(fb.LAUNCHES)
    sweep = res["sweep"]
    eval_ok = (len(sweep) == len(PC_EVAL_GUIDANCE)
               and all(np.isfinite([r["chamfer"], r["chamfer_weighted"], r["emd"]]).all()
                       for r in sweep)
               and eval_launches == {n: PC_EVAL_LAUNCHES.get(n, 0) for n in KERNELS})
    print(f"(d) PointCloudEvaluator, {PC_EVAL_PROMPTS} prompts x {PC_TRAIN_POINTS} points, "
          f"{STEPS} steps, guidance {PC_EVAL_GUIDANCE}, in {eval_s:.1f} s: " + "; ".join(
              f"gs {r['guidance_scale']}: CD {r['chamfer']:.4f}, weighted "
              f"{r['chamfer_weighted']:.4f}, EMD {r['emd']:.4f}" for r in sweep)
          + f"; launches {eval_launches}: {'ok' if eval_ok else 'FAIL'}")
    _record_launches("flash_attention", "t2pc_eval", eval_launches["flash_attention"])
    del eval_pipe, eval_model
    shutil.rmtree(PC_TRAIN_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    report["pc_train"] = dict(params_m=n_params / 1e6, script=out, script_launches=script_launches,
                              losses=losses, launches_default=launches, launches_dropout0=launches0,
                              grad_rel_l2_auto_vs_xla=vs, grad_floor=floor, resume_differ=differ,
                              checkpoint_s=ckpt_s, eval=res, eval_launches=eval_launches)
    if not (script_ok and fall_ok and resume_ok and grad_ok and eval_ok):
        raise AssertionError("t2pc training check failed")
    return {"pipe": pipe, "norm": norm, "m_auto": m_auto}


@phase("5e timing of the t2pc training step")
def timing_pc_train(st):
    """The default step (p50 of 5 after 2 warm-ups, fresh batches), its
    samples/s and peak memory; the loss terms alone (chamfer, Sinkhorn, AR,
    forward and backward on the step's shapes) and their share of it; the
    dropout-0 step, and its flash kernels (the f32 forward and backward at
    (16, 12, 1024, 64)) beside their bounds and their share."""
    if st is None:
        raise AssertionError("no t2pc training pipeline: phase 4g failed")
    pipe, norm = st["pipe"], st["norm"]
    data = itertools.cycle([pipe.encode_batch(_pc_batch(norm, 10 + i)) for i in range(4)])

    def p50_of(trainer):
        """p50 and times of 5 steps after 2 warm-ups, and the steps' peak
        memory above what was allocated before them (the pipelines of the
        earlier phases, the other training state), which is also returned."""
        trainer.train(data, trainer.step + 2)  # warm-ups
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            trainer.train(data, trainer.step + 1)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return (float(np.percentile(times, 50)), times,
                torch.cuda.max_memory_allocated() - held, held)

    p50, times, peak, held = p50_of(pipe.trainer)
    print(f"t2pc training step (dropout 0.1, plain core): batch {PC_TRAIN_BATCH}, p50 {p50:.3f} s, "
          f"{PC_TRAIN_BATCH / p50:.2f} samples/s (times {[round(t, 3) for t in times]}); peak "
          f"memory of the step {peak / 2 ** 30:.2f} GiB above the {held / 2 ** 30:.2f} GiB "
          f"allocated before it")
    # the geometric loss terms on the step's shapes, forward and backward
    gen = torch.Generator(device=DEV).manual_seed(9)
    pts = next(data)["points"]
    x0 = torch.clamp(pts + 0.1 * torch.randn(pts.shape, generator=gen, device=DEV), -1, 1)
    x0.requires_grad_()
    ids = dynamic_partition(gen, PC_TRAIN_POINTS, 16)[1]
    terms = {"chamfer": lambda: torch.mean(pc_losses.chamfer_distance(x0, pts)),
             "sinkhorn": lambda: torch.mean(pc_losses.sinkhorn_emd(x0, pts, 0.05, 30)),
             "ar": lambda: pc_losses.ar_consistency_loss(x0, ids)}
    term_ms = {k: sync_ms(lambda f=f: f().backward(), 5) for k, f in terms.items()}
    share = sum(term_ms.values()) / (p50 * 1e3)
    print("  loss terms, forward + backward (CUDA events): " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in term_ms.items())
        + f"; together {sum(term_ms.values()):.2f} ms, {share:.1%} of the step")
    # the dropout-0 step through the dispatcher (the f32 flash route)
    pipe0 = _pc_pipe(st["m_auto"], norm)
    p50_0, times0, peak0, _ = p50_of(pipe0.trainer)
    bh, L = PC_TRAIN_BATCH * PP_HEADS, PC_TRAIN_POINTS
    q, k, v = (torch.randn((PC_TRAIN_BATCH, PP_HEADS, L, 64), generator=gen, device=DEV)
               for _ in range(3))
    fwd = _time_kernel("flash_attention", (PC_TRAIN_BATCH, PP_HEADS, L, 64, "f32"),
                       lambda: fa.flash_attention_with_lse(q, k, v),
                       lambda: fa.flash_attention_plain(q, k, v),
                       _bound(4 * bh * L * L * 64 / PEAK_F32_FLOPS, 4 * bh * L * 64 * 4 + bh * L * 4),
                       iters=5)
    o, lse = fa.flash_attention_with_lse(q, k, v)
    do = torch.randn(o.shape, generator=gen, device=DEV)
    launches, _ = fa._bwd_operands(q, k, v, None, None, o, lse, do)
    bwd_ms = sync_ms(lambda: fa.run_bwd(launches), 5)  # prep and the one-pass kernel
    bwd_bound = _bound(10 * bh * L * L * 64 / PEAK_F32_FLOPS, 7 * bh * L * 64 * 4 + 2 * bh * L * 4)
    bwd_plain = sync_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, None, None, o, lse, do), 3)
    del q, k, v, o, lse, do, launches
    flash_s = (PC_TRAIN_F32_LAUNCHES["flash_attention"] * fwd["ms"]
               + PC_TRAIN_F32_LAUNCHES["flash_attention_bwd_f32"] * bwd_ms) / 1e3
    print(f"  flash_attention_bwd_f32 + prep {(PC_TRAIN_BATCH, PP_HEADS, L, 64)} f32: "
          f"{bwd_ms:.3f} ms, plain backward {bwd_plain:.3f} ms, bound {bwd_bound[0]:.3f} ms "
          f"({bwd_bound[1]}), {bwd_bound[0] / bwd_ms:.1%} of bound")
    print(f"t2pc training step at dropout 0 (the f32 flash route): p50 {p50_0:.3f} s, "
          f"{PC_TRAIN_BATCH / p50_0:.2f} samples/s (times {[round(t, 3) for t in times0]}); peak "
          f"memory of the step {peak0 / 2 ** 30:.2f} GiB; its flash kernels ({PC_TRAIN_F32_LAUNCHES}) "
          f"{flash_s * 1e3:.1f} ms by their event times, {flash_s / p50_0:.1%} of the step")
    report["pc_train"].update(
        batch=PC_TRAIN_BATCH, p50_s=p50, samples_per_s=PC_TRAIN_BATCH / p50, times_s=times,
        step_peak_bytes=peak, held_bytes=held, loss_terms_ms=term_ms, loss_terms_share=share, dropout0_p50_s=p50_0,
        dropout0_samples_per_s=PC_TRAIN_BATCH / p50_0, dropout0_times_s=times0,
        dropout0_step_peak_bytes=peak0, flash_fwd_f32_ms=fwd["ms"], flash_fwd_f32_bound_ms=fwd["bound_ms"],
        flash_bwd_f32_ms=bwd_ms, flash_bwd_f32_bound_ms=bwd_bound[0],
        flash_bwd_f32_plain_ms=bwd_plain, flash_share_dropout0=flash_s / p50_0)
    return pipe, pipe0


@phase("3f AR-shape kernels vs plain")
def check_ar_kernels():
    """The three kernels of the masked-AR int8 path against their plain
    versions at its width (D = 768, F = 3072) and rows, every variant (the
    path's per-row route and the static one), f32 and bf16 residual
    streams, at phase 3d's tolerances (max <= 2^-6 max|y|, mean <= 2^-10
    mean|y|): fused_int8_mlp_postln at the ViT's 2 x 32 x (32 + 128) =
    10240 rows, its fc2 over clusters of 768 / 256 = 3 blocks, and a
    ragged 7 x 149; fused_int8_diffusion_block at the head's 2 x 32 x 13
    = 832 rows (96 column groups: a 96-block grid) and 77 and 20 rows;
    int8_linear at K = 768 (qkv 768 -> 2304 with an f32 x, the
    out-projection 768 -> 768 with a bf16 x) at 10240 and 1043 rows."""
    gen = torch.Generator(device=DEV).manual_seed(4343)
    dev = torch.device(DEV)
    bad = []
    size = AR_D // 256
    plan = fb.mlp_postln_plan(AR_VIT_M, AR_D, AR_F, fb._sms(dev), fb._clusters(dev, size))
    fc2 = plan["fc2"]
    print(f"  fused_int8_mlp_postln at {AR_VIT_M} x {AR_D}: fc2 clusters of {fc2['cluster']} "
          f"blocks, {fb._clusters(dev, size)} active clusters (cudaOccupancyMaxActiveClusters), "
          f"{fc2['m_tiles']} m-tiles, {fc2['waves']:.2f} waves")
    dplan = fb.diffusion_plan(AR_HEAD_M, AR_D, fb._sms(dev), static=False)
    print(f"  fused_int8_diffusion_block at {AR_HEAD_M} x {AR_D}: grid {dplan['grid'][0]}, "
          f"{dplan['groups']} column groups, {dplan['groups_per_block']} a block, "
          f"{dplan['row_parts']} row parts, {dplan['smem_bytes']} bytes of shared memory")
    for lead in ((AR_ROWS, AR_TEXT + AR_T), (7, 149)):
        for x_dtype in (torch.float32, torch.bfloat16):
            ops = _t2i_mlp_operands(gen, lead, x_dtype, AR_D, AR_F)
            for label, kw in _t2i_variants("mlp"):
                y = fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw)
                torch.cuda.synchronize()
                ref = fb.fused_int8_mlp_postln_plain(*ops, ln_eps=1e-5, **kw)
                if not _tol_check("fused_int8_mlp_postln",
                                  f"AR {label} rows={lead[0] * lead[1]} D={AR_D} x={x_dtype}",
                                  y, ref, like=ops[0]):
                    bad.append(f"mlp_postln {label} {lead} {x_dtype}")
                del y, ref
            del ops
    for m in (AR_HEAD_M, 77, 20):
        for x_dtype in (torch.bfloat16, torch.float32):
            ops = _diffusion_operands(gen, m, AR_D)
            ops[0], ops[1] = ops[0].to(x_dtype), ops[1].to(x_dtype)
            for label, kw in _t2i_variants("diffusion"):
                y = fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw)
                torch.cuda.synchronize()
                ref = fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5, **kw)
                if not _tol_check("fused_int8_diffusion_block",
                                  f"AR {label} rows={m} D={AR_D} x={x_dtype}", y, ref,
                                  like=ops[0]):
                    bad.append(f"diffusion {label} {m} {x_dtype}")
    for m in (AR_VIT_M, 1043):
        for n in (3 * AR_D, AR_D):
            x, w, ws, b = _linear_operands(gen, m, n, AR_D)
            y = fb.int8_linear(x, w, ws, b, torch.bfloat16)
            torch.cuda.synchronize()
            if not _tol_check("int8_linear", f"AR {m}x{AR_D}->{n} x={x.dtype}", y,
                              fb.int8_linear_plain(x, w, ws, b, torch.bfloat16)):
                bad.append(f"int8_linear {m} {n}")
    torch.cuda.empty_cache()
    report["ar_kernels"] = dict(fc2_cluster=fc2["cluster"], fc2_clusters=fc2["clusters"],
                                fc2_waves=fc2["waves"], diffusion_grid=dplan["grid"][0],
                                diffusion_row_parts=dplan["row_parts"])
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    fb.reset_launch_counts()


def _make_ar_pipeline(quantize, state_dict=None):
    """The masked-AR model at the class's defaults (pc_d32w768, 2048 points
    at patch 16, text 32 x 256), seeded random weights with the head's
    zero-initialised AdaLN projections (and the biases) filled, so every
    diffusion block's gate and modulation depend on its inputs; bf16
    weights and compute dtype; DDPM squaredcos_cap_v2."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = NOVAPointCloudARTransformer(
        arch=AR_ARCH, point_cloud_size=AR_POINTS, patch_size=AR_PATCH, text_token_dim=256,
        text_token_len=AR_TEXT, quantize=quantize, dtype=torch.bfloat16, device=DEV)
    if state_dict is None:
        model.init_weights(gen).fill_zero_init(gen)
    else:
        model.load_state_dict(state_dict)
    model.to(torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"masked-AR {'int8' if quantize else 'float'} {AR_ARCH}: {n_params / 1e6:.1f}M "
          f"parameters, {AR_T} tokens, batch {AR_BATCH}")
    return NOVAPointCloudARPipeline(model, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
                                    text_encoder=DummyTextEncoder(256, AR_TEXT))


def _ar_draws(pipe, seed, ar_steps):
    """The prediction order and every AR step's initial noise, drawn up
    front, so a comparison can replay a call with one input moved."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    _, _, pad_p = pipe.schedule(ar_steps)
    order = torch.argsort(torch.rand((AR_BATCH, AR_T), generator=gen, device=DEV), dim=1)
    noise = torch.randn((ar_steps, AR_BATCH, pad_p, pipe.model.patch_dim), generator=gen,
                        device=DEV)
    return order, noise


def _ar_sample(pipe, ar_steps=AR_STEPS, seed=1, order=None, noise=None):
    out = pipe(AR_PROMPTS, num_inference_steps=ar_steps, num_diffusion_steps=AR_DIFF,
               guidance_scale=AR_GUIDANCE, generator=torch.Generator(device=DEV).manual_seed(seed),
               order=order, noise=noise, output_type="pt")
    torch.cuda.synchronize()
    return out


def _ar_output_ok(out, label):
    pts, cols = out.point_clouds.float(), out.colors.float()
    ok = (tuple(pts.shape) == (AR_BATCH, AR_POINTS, 3) and bool(torch.isfinite(pts).all())
          and pts.abs().max().item() <= 1.0 and 0.0 <= cols.min().item()
          and cols.max().item() <= 1.0 and pts.std().item() > 0.05)
    print(f"{label} output {tuple(pts.shape)} finite, in [-1, 1], std {pts.std().item():.4f}: "
          f"{'ok' if ok else 'FAIL'}")
    return ok, pts.std().item()


def _ar_step_check(pipe):
    """One encoder pass (half the tokens visible, 32 + 128 keys) and one
    head eval at the padded slice's 13 tokens, kernels against plain,
    relative mean error gated at 2 x floor + 1e-3 (floor: kernels against
    kernels with the canvas and x_t moved by 1e-6); the pass's launches:
    32 fused_int8_mlp_postln, 64 int8_linear, 6 fused_int8_diffusion_block."""
    model, qp = pipe.model, pipe.model.serving_qparams()
    gen = torch.Generator(device=DEV).manual_seed(11)
    pd = model.patch_dim
    expected = {"fused_int8_mlp_postln": AR_DEPTH, "int8_linear": 2 * AR_DEPTH,
                "fused_int8_diffusion_block": AR_HEAD_BLOCKS}
    with torch.no_grad():
        c = pipe.encode_prompt(AR_PROMPTS, guidance=GuidanceConfig(guidance_scale=AR_GUIDANCE))
        canvas = torch.rand((AR_BATCH, AR_T, pd), generator=gen, device=DEV) * 2 - 1
        mask = (torch.rand((AR_BATCH, AR_T, 1), generator=gen, device=DEV) < 0.5).float()
        x_t = torch.randn((AR_ROWS, AR_PAD_P, pd), generator=gen, device=DEV)
        t = torch.full((AR_ROWS,), 500.0, device=DEV)

        def step(cv, xt):
            z = model.encode_step(model.tokens_from_patches(cv).repeat(2, 1, 1),
                                  mask.repeat(2, 1, 1), c,
                                  model.patch_centers(cv * (1 - mask)).repeat(2, 1, 1),
                                  qparams=qp)
            return z.float(), model.denoise_step(xt, t, z[:, :AR_PAD_P], qparams=qp).float()

        fb.reset_launch_counts()
        z, pred = step(canvas, x_t)
        launches = {n: v for n, v in fb.LAUNCHES.items() if v}
        with fb.use_plain_kernels():
            z_p, pred_p = step(canvas, x_t)
        z_m, pred_m = step(canvas + 1e-6 * torch.randn(canvas.shape, generator=gen, device=DEV),
                           x_t + 1e-6 * torch.randn(x_t.shape, generator=gen, device=DEV))
    torch.cuda.synchronize()
    res, ok = {}, launches == expected
    for name, a, p, m in (("encode_step", z, z_p, z_m), ("denoise_step", pred, pred_p, pred_m)):
        scale = p.abs().mean()
        rel = ((a - p).abs().mean() / scale).item()
        floor = ((a - m).abs().mean() / scale).item()
        good = bool(torch.isfinite(a).all()) and rel <= 2 * floor + 1e-3
        ok = ok and good
        print(f"masked-AR int8 one {name}, kernels vs plain: mean |diff| / mean |plain| "
              f"{rel:.3e} (tol 2 x floor + 1e-3 = {2 * floor + 1e-3:.3e}; floor, inputs moved "
              f"by 1e-6: {floor:.3e}): {'ok' if good else 'FAIL'}")
        res[name] = dict(rel_err=rel, rel_floor=floor)
    print(f"masked-AR int8 one step: launches {launches} (expected {expected}): "
          f"{'ok' if launches == expected else 'FAIL'}")
    return ok, res


@phase("4h masked-AR t2pc serving")
def ar_serving():
    """NOVAPointCloudARPipeline at its defaults (16 AR x 25 DDPM steps, CFG
    5.0), batch 32. int8 (quantize=True, per-row activations: the AR
    pipeline never calibrates, so the ViT's attention core stays plain):
    exact launches (512 fused_int8_mlp_postln, 1024 int8_linear, 2400
    fused_int8_diffusion_block, 0 of every other kernel), the output; a
    call at 4 AR steps against the same call with the plain versions (gate
    2 x floor + 1e-3; floor: the kernel path with the AR noise moved by
    1e-6; the DDPM steps' noise comes from the same seed); one encoder pass
    and one head eval against plain. The float twin (quantize=False, the
    same weights): no launch, the output."""
    counts = masking.cosine_pred_counts(AR_STEPS, AR_T)
    if int(counts.max()) != AR_PAD_P or int(counts.sum()) != AR_T:
        raise AssertionError(f"cosine_pred_counts({AR_STEPS}, {AR_T}) = {counts}")
    pipe = _make_ar_pipeline(quantize=True)
    _ar_sample(pipe, ar_steps=2, seed=9)  # warm-up: kernel loads, allocator
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    out = _ar_sample(pipe)
    call_s = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    counts_ok = launches == {n: AR_INT8_LAUNCHES.get(n, 0) for n in KERNELS}
    print(f"launches in one masked-AR int8 call ({AR_STEPS} AR x {AR_DIFF} steps, "
          f"{call_s:.2f} s): {launches} (expected {AR_INT8_LAUNCHES}, else 0): "
          f"{'ok' if counts_ok else 'FAIL'}")
    for name in AR_INT8_LAUNCHES:
        _record_launches(name, "masked_ar_int8", launches[name])
    out_ok, std = _ar_output_ok(out, "masked-AR int8")

    order, noise = _ar_draws(pipe, 3, AR_CMP_STEPS)
    pts = _ar_sample(pipe, AR_CMP_STEPS, order=order, noise=noise).point_clouds.float()
    fb.reset_launch_counts()
    with fb.use_plain_kernels():
        plain = _ar_sample(pipe, AR_CMP_STEPS, order=order, noise=noise).point_clouds.float()
    plain_launches = dict(fb.LAUNCHES)
    moved = noise + 1e-6 * torch.randn(noise.shape, device=DEV,
                                       generator=torch.Generator(device=DEV).manual_seed(4))
    floor = (pts - _ar_sample(pipe, AR_CMP_STEPS, order=order, noise=moved).point_clouds.float()
             ).abs().mean().item()
    vs_plain = (pts - plain).abs().mean().item()
    tol = 2 * floor + 1e-3
    agree = vs_plain <= tol and not any(plain_launches.values())
    print(f"masked-AR int8 ({AR_CMP_STEPS} AR steps): kernels vs plain run mean |diff| "
          f"{vs_plain:.3e} (tol 2 x floor + 1e-3 = {tol:.3e}; floor, kernels vs kernels with the "
          f"AR noise moved by 1e-6: {floor:.3e}; mean |p| {pts.abs().mean().item():.3e}); plain "
          f"run launched {plain_launches}: {'ok' if agree else 'FAIL'}")
    step_ok, step = _ar_step_check(pipe)

    pipe_f = _make_ar_pipeline(quantize=False, state_dict=pipe.model.state_dict())
    _ar_sample(pipe_f, ar_steps=2, seed=9)
    fb.reset_launch_counts()
    out_f = _ar_sample(pipe_f)
    launches_f = dict(fb.LAUNCHES)
    float_ok, std_f = _ar_output_ok(out_f, "masked-AR float")
    float_ok = float_ok and not any(launches_f.values())
    int8_vs_float = (out.point_clouds.float() - out_f.point_clouds.float()).abs().mean().item()
    print(f"masked-AR float launches {launches_f} (expected none); for scale, int8 vs float "
          f"mean |diff| {int8_vs_float:.3e}: {'ok' if float_ok else 'FAIL'}")
    report["masked_ar_int8"] = dict(launches=launches, output_ok=out_ok, output_std=std,
                                    call_s=call_s, mean_abs_vs_plain=vs_plain,
                                    floor_mean_abs=floor, tol=tol, compare_ar_steps=AR_CMP_STEPS,
                                    plain_launches=plain_launches, one_step=step)
    report["masked_ar_float"] = dict(launches=launches_f, output_ok=float_ok, output_std=std_f,
                                     mean_abs_int8_vs_float=int8_vs_float)
    if not (counts_ok and out_ok and agree and step_ok and float_ok):
        raise AssertionError("masked-AR serving check failed")
    return pipe, pipe_f


@phase("4i refinement mode")
def refinement(pipe):
    """The flagship pipeline of phase 4 with use_autoregressive=True,
    num_subsets=16 and ARRefiner() at its defaults (256 wide, 8 heads,
    depth 2, f32) on seeded random weights with a non-zero head: exact
    launches (1200 + 1200 of rows 1 and 2, as the flagship, none from the
    refiner: its attention is flax's plain core, its blocks' 128 keys under
    the dispatcher's 1024), finite output, its peak memory; the first
    subset step (every generated slot invalid) finite; the refinement of
    4 of the call's clouds on the card against the same refiner on the CPU
    (the path the CPU tests hold to JAX), same inputs and partition: mean
    |diff| <= 1e-4 mean |refined| (f32 with TF32 off on both sides, sums in
    another order; a kNN choice that rounding flips moves single points,
    so the max is printed, not gated)."""
    import copy

    if pipe is None:
        raise AssertionError("no flagship pipeline: phase 4 failed")
    gen = torch.Generator(device=DEV).manual_seed(12)
    refiner = ARRefiner(device=DEV).init_weights(gen)
    with torch.no_grad():
        refiner.head.weight.copy_(torch.randn(refiner.head.weight.shape, generator=gen,
                                              device=DEV) * 0.02)
    pipe.ar_refiner = refiner
    n_params = sum(p.numel() for p in refiner.parameters())
    part = dynamic_partition(gen, POINTS, REFINE_SUBSETS)
    kw = dict(use_autoregressive=True, num_subsets=REFINE_SUBSETS, partition=part)
    _sample(pipe, seed=9, **kw)  # warm-up
    latents = torch.randn((BATCH, POINTS, 3), generator=gen, device=DEV)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    out = _sample(pipe, latents=latents, **kw)
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    launches = dict(fb.LAUNCHES)
    expected = DEPTH * STEPS
    counts_ok = launches == {n: expected if n in _kernels() else 0 for n in KERNELS}
    print(f"ARRefiner() {n_params / 1e6:.2f}M parameters; launches in one refinement call "
          f"({call_s:.2f} s): {launches} (expected {expected} of each flagship kernel, 0 of the "
          f"others): {'ok' if counts_ok else 'FAIL'}")
    for name in _kernels():
        _record_launches(name, "refinement", launches[name])
    pts = out.point_clouds.float()
    out_ok = (tuple(pts.shape) == (BATCH, POINTS, 3) and bool(torch.isfinite(pts).all())
              and pts.std().item() > 0.05)
    print(f"output {tuple(pts.shape)} finite, std {pts.std().item():.4f}; peak memory of the "
          f"call {peak / 2 ** 30:.2f} GiB above the {held / 2 ** 30:.2f} GiB allocated before "
          f"it: {'ok' if out_ok else 'FAIL'}")
    # the cloud the refiner takes: the same call's DDPM output, eval postprocess
    x = _sample(pipe, latents=latents, postprocess="eval").point_clouds.float()
    order, ids = (a.long() for a in part)
    with torch.no_grad():
        first = refiner(x[:, ids[order[0]]], torch.zeros_like(x), torch.zeros(x.shape[:2],
                        device=DEV), torch.zeros((BATCH,), device=DEV))
        first_ok = bool(torch.isfinite(first).all())
        refined = pipe._ar_refine(x, REFINE_SUBSETS, None, part)
        pipe.ar_refiner = copy.deepcopy(refiner).cpu()
        cpu_part = tuple(a.cpu() for a in part)
        t0 = time.perf_counter()
        cpu = pipe._ar_refine(x[:REFINE_CPU_SAMPLES].cpu(), REFINE_SUBSETS, None, cpu_part)
        cpu_s = time.perf_counter() - t0
        pipe.ar_refiner = refiner
    diff = (refined[:REFINE_CPU_SAMPLES].cpu() - cpu).abs()
    scale = cpu.abs().mean().item()
    rel = diff.mean().item() / scale
    cpu_ok = bool(torch.isfinite(refined).all()) and rel <= 1e-4
    print(f"first subset step (no generated point) finite: {first_ok}; refinement of "
          f"{REFINE_CPU_SAMPLES} clouds, card vs CPU ({cpu_s:.1f} s): mean |diff| / mean |refined| "
          f"{rel:.3e} (tol 1e-4), max |diff| {diff.max().item():.3e}: "
          f"{'ok' if cpu_ok and first_ok else 'FAIL'}")
    report["refinement"] = dict(launches=launches, output_ok=out_ok, call_s=call_s,
                                peak_bytes=peak, held_bytes=held, first_step_finite=first_ok,
                                card_vs_cpu_rel=rel, card_vs_cpu_max=diff.max().item(),
                                refiner_params_m=n_params / 1e6)
    del x, refined, first, out
    torch.cuda.empty_cache()
    if not (counts_ok and out_ok and first_ok and cpu_ok):
        raise AssertionError("refinement mode check failed")
    return pipe


def _ar_train_draws(model, b, seed):
    """Every draw of one masked-AR training step at batch b, fixed: the
    training mask, the prompt drop, per-token timesteps and the noise of
    the 4 repeats."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    nt = model.num_tokens
    rep = model.loss_repeat
    return {"mask": masking.sample_train_mask(gen, b, nt, device=DEV)[0],
            "drop": torch.rand((b,), generator=gen, device=DEV) < 0.1,
            "timesteps": torch.randint(0, 1000, (rep * b, nt), generator=gen, device=DEV),
            "noise": torch.randn((rep * b, nt, model.patch_dim), generator=gen, device=DEV)}


@phase("4j masked-AR training")
def ar_train():
    """scripts/train_eval_pc_ar.py's main at its defaults (pc_d8w768, 1024
    points at patch 16, batch 32, f32, remat, clip 5.0 -> AdamW, cosine lr
    2e-4 with 200 warm-up steps, Morton-sorted batches, the guidance sweep
    1 / 2 / 3 / 5 at 16 AR x 25 steps over 24 shapes) cut to 2 steps, its
    --stats (a GlobalNormalizer fitted on make_synthetic_clouds and saved)
    and --out in a scratch directory: no launch (f32, 80 keys: the plain
    core), finite CD / EMD at every scale. Then 20 steps of one fixed batch
    with fixed draws on the script's model and optimizer: every metric
    finite, the loss falling, no launch."""
    import shutil

    shutil.rmtree(AR_TRAIN_DIR, ignore_errors=True)
    os.makedirs(AR_TRAIN_DIR)
    norm = _pc_normalizer()  # 64 clouds at 1024 points, the script's size
    stats, out_path = os.path.join(AR_TRAIN_DIR, "stats.json"), os.path.join(AR_TRAIN_DIR,
                                                                             "quality.json")
    norm.save(stats)
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    res = train_eval_pc_ar.main(AR_SCRIPT_ARGS + ["--stats", stats, "--out", out_path],
                                device=DEV)
    torch.cuda.synchronize()
    script_s = time.perf_counter() - t0
    script_launches = dict(fb.LAUNCHES)
    sweep = res["sweep"]
    script_ok = (res["steps"] == 2 and os.path.exists(out_path) and len(sweep) == 4
                 and all(np.isfinite([r["chamfer"], r["chamfer_weighted"], r["emd"]]).all()
                         for r in sweep) and not any(script_launches.values()))
    print(f"train_eval_pc_ar.main (2 steps, the sweep at {train_eval_pc_ar.EVAL_AR_STEPS} AR x "
          f"{train_eval_pc_ar.EVAL_DIFF_STEPS} steps over {train_eval_pc_ar.EVAL_SHAPES} shapes) "
          f"in {script_s:.1f} s: " + "; ".join(
              f"gs {r['guidance_scale']}: CD {r['chamfer']:.4f}, EMD {r['emd']:.4f}"
              for r in sweep) + f"; launches {script_launches}: {'ok' if script_ok else 'FAIL'}")

    args = train_eval_pc_ar.parse_args(AR_SCRIPT_ARGS)
    model = train_eval_pc_ar.build_model(args, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
                                         DEV)
    opt, schedule = train_eval_pc_ar.build_optimizer_and_schedule(model, args.lr, args.max_steps)

    def loss_fn(batch, generator, draws=None):
        losses = model(batch["points"], batch["text_embeds"], generator=generator, draws=draws)
        return losses["loss"], losses

    trainer = Trainer(loss_fn, model, opt, lr_schedule=schedule, max_steps=args.max_steps,
                      log_every=100, save_every=0, ema_decay=None, seed=args.seed)
    shapes = make_synthetic_clouds(64, args.max_points, args.seed)
    batch = next(train_eval_pc_ar.train_batches(shapes, norm, DummyTextEncoder(256, 16),
                                                args.batch_size, args.max_points, args.seed, DEV))
    draws = _ar_train_draws(model, args.batch_size, 2)
    n_params = sum(p.numel() for p in model.parameters())
    fb.reset_launch_counts()
    metrics = [trainer.train_step(batch, draws=draws) for _ in range(AR_TRAIN_FALL_STEPS)]
    torch.cuda.synchronize()
    launches = dict(fb.LAUNCHES)
    losses = [float(m["loss"]) for m in metrics]
    finite = all(bool(torch.isfinite(v).all()) for m in metrics for v in m.values())
    fall_ok = finite and losses[-1] < losses[0] and not any(launches.values())
    print(f"masked-AR training {args.arch}: {n_params / 1e6:.1f}M parameters (f32, remat), batch "
          f"{args.batch_size}, {args.max_points} points at patch {args.patch_size}; fixed batch "
          f"and draws, {AR_TRAIN_FALL_STEPS} steps: loss {losses[0]:.5f} -> {losses[-1]:.5f}, "
          f"every metric finite: {finite}, launches {launches}: {'ok' if fall_ok else 'FAIL'}")
    shutil.rmtree(AR_TRAIN_DIR, ignore_errors=True)
    report["masked_ar_train"] = dict(params_m=n_params / 1e6, script=res, script_s=script_s,
                                     script_launches=script_launches, losses=losses,
                                     launches=launches)
    if not (script_ok and fall_ok):
        raise AssertionError("masked-AR training check failed")
    return {"trainer": trainer, "batch": batch, "draws": draws, "batch_size": args.batch_size}


def _p50_call(fn, n=3):
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(i)
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50)), times


@phase("5f timing of the AR paths")
def timing_ar(pipe_ar, pipe_ar_f, pipe_flagship, ar_train_state):
    """Rows 5, 6 and int8_linear per launch at the masked-AR shapes on their
    per-row route (the path's), their plain versions and bounds (int8
    operations at 1979 TOP/s or bytes at 3.35 TB/s); SDPA's f32 forward and
    backward at the t2pc step's (16, 12, 1024, 64) beside the f32 route's;
    p50 samples/s of 3
    calls of the masked-AR int8 and float calls (batch 32), the refinement
    call and the flagship without it (batch 128); the masked-AR training
    step's p50 of 5 after 2 warm-ups and its peak memory above what was
    allocated before it."""
    gen = torch.Generator(device=DEV).manual_seed(13)
    dev = torch.device(DEV)
    m = AR_VIT_M
    ops = _t2i_mlp_operands(gen, (AR_ROWS, AR_TEXT + AR_T), torch.float32, AR_D, AR_F)
    row = _time_kernel(
        "fused_int8_mlp_postln", (m, AR_D, AR_F, "per-row"),
        lambda: fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5),
        lambda: fb.fused_int8_mlp_postln_plain(*ops, ln_eps=1e-5),
        _bound(4 * m * AR_D * AR_F / PEAK_INT8_OPS,
               2 * m * AR_D * 4 + 2 * AR_D * AR_F + (AR_F + 3 * AR_D) * 2 + (AR_F + AR_D) * 4),
        graph=True)
    fc2 = fb.mlp_postln_plan(m, AR_D, AR_F, fb._sms(dev), fb._clusters(dev, AR_D // 256))["fc2"]
    row["fc2_waves"] = fc2["waves"]
    print(f"    fc2: {fc2['m_tiles']} m-tiles over {fc2['clusters']} clusters of {fc2['cluster']}, "
          f"{fc2['waves']:.2f} waves")
    del ops
    ops = _diffusion_operands(gen, AR_HEAD_M, AR_D)
    _time_kernel(
        "fused_int8_diffusion_block", (AR_HEAD_M, AR_D, "per-row"),
        lambda: fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5),
        lambda: fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5),
        _bound(2 * AR_HEAD_M * AR_D * 5 * AR_D / PEAK_INT8_OPS,
               3 * AR_HEAD_M * AR_D * 2 + 5 * AR_D * AR_D + 7 * AR_D * 2 + 5 * AR_D * 4),
        iters=200, graph=True)
    for n in (3 * AR_D, AR_D):
        x, w, ws, b = _linear_operands(gen, m, n, AR_D)
        _time_kernel("int8_linear", (m, AR_D, n),
                     lambda: fb.int8_linear(x, w, ws, b, torch.bfloat16),
                     lambda: fb.int8_linear_plain(x, w, ws, b, torch.bfloat16),
                     _bound(2 * m * AR_D * n / PEAK_INT8_OPS,
                            m * AR_D * x.element_size() + m * n * 2 + n * AR_D + n * 2 + n * 4),
                     graph=True)
        del x
    # SDPA's f32 forward and backward at the t2pc training step's (16, 12,
    # 1024, 64), beside the f32 route's forward and its backward through
    # autograd (prep and flash_attention_bwd_f32) on the same tensors
    import torch.nn.functional as Fn

    shape = (PC_TRAIN_BATCH, PP_HEADS, PC_TRAIN_POINTS, 64)
    q, k, v, do = (torch.randn(shape, generator=gen, device=DEV) for _ in range(4))
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd32():
        with torch.no_grad():
            Fn.scaled_dot_product_attention(q, k, v)

    att = {"sdpa_fwd_ms": sync_ms(sdpa_fwd32, 5),
           "port_fwd_ms": sync_ms(lambda: fa.flash_attention_with_lse(q, k, v), 5)}
    o_lib = Fn.scaled_dot_product_attention(*ins)
    att["sdpa_bwd_ms"] = sync_ms(lambda: torch.autograd.grad(o_lib, ins, do, retain_graph=True), 5)
    o_port = fa.flash_attention(*ins)
    att["port_bwd_autograd_ms"] = sync_ms(
        lambda: torch.autograd.grad(o_port, ins, do, retain_graph=True), 5)
    print(f"  f32 attention at {shape}: SDPA forward {att['sdpa_fwd_ms']:.3f} ms, the f32 "
          f"route's forward {att['port_fwd_ms']:.3f} ms; SDPA backward {att['sdpa_bwd_ms']:.3f} "
          f"ms, the f32 route's backward through autograd {att['port_bwd_autograd_ms']:.3f} ms")
    report["t2pc_f32_attention"] = att
    del q, k, v, do, ins, o_lib, o_port
    torch.cuda.empty_cache()
    if pipe_ar is None or pipe_flagship is None:
        raise AssertionError("no pipeline: phase 4 or 4h failed")
    fb.reset_launch_counts()
    calls = report["ar_timing"] = {}
    for label, fn, batch, n in (
            ("masked_ar_int8", lambda i: _ar_sample(pipe_ar, seed=20 + i), AR_BATCH, 3),
            ("masked_ar_float", lambda i: _ar_sample(pipe_ar_f, seed=20 + i), AR_BATCH,
             AR_SLOW_TIMED_CALLS),
            ("refinement", lambda i: _sample(pipe_flagship, seed=20 + i, use_autoregressive=True,
                                             num_subsets=REFINE_SUBSETS), BATCH,
             AR_SLOW_TIMED_CALLS),
            ("flagship", lambda i: _sample(pipe_flagship, seed=20 + i), BATCH, 3)):
        p50, times = _p50_call(fn, n)
        print(f"{label}: batch {batch}, p50 {p50:.3f} s per call, {batch / p50:.2f} samples/s "
              f"(times {[round(t, 3) for t in times]})")
        calls[label] = dict(batch=batch, p50_s=p50, samples_per_s=batch / p50, times_s=times)
    if ar_train_state is None:
        raise AssertionError("no masked-AR trainer: phase 4j failed")
    trainer, batch, draws, b = (ar_train_state[k] for k in ("trainer", "batch", "draws",
                                                             "batch_size"))
    for _ in range(2):
        trainer.train_step(batch, draws=draws)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        trainer.train_step(batch, draws=draws)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    p50 = float(np.percentile(times, 50))
    peak = torch.cuda.max_memory_allocated() - held
    print(f"masked-AR training step: batch {b}, p50 {p50:.4f} s, "
          f"{b / p50:.1f} samples/s (times {[round(t, 4) for t in times]}); peak "
          f"memory of the step {peak / 2 ** 30:.2f} GiB above the {held / 2 ** 30:.2f} GiB "
          f"allocated before it")
    report["masked_ar_train"].update(batch=b, p50_s=p50, samples_per_s=b / p50,
                                     times_s=times, step_peak_bytes=peak, held_bytes=held)


@phase("3g t2v kernels vs plain")
def check_t2v_kernels():
    """The t2v int8 path's kernels against their plain versions at its
    shapes (batch 1 x CFG 2), phase 3d's tolerances: fused_int8_mlp_postln
    at 2 x (540, 720, 1080, 1800) rows (the image encoder's encoder half in
    its bucket phases and masking phase, its decoder) and 2 x (618, 360)
    (the video encoder's frame 0 with the 258-token prefix, later frames),
    static and per row, an f32 residual stream (a bf16 one at 2 x 1800 too);
    fused_int8_diffusion_block at the head's 2 x 36 = 72 rows, bf16 and f32
    x; int8_linear at the same rows (qkv 1024 -> 3072 with an f32 x, the
    out-projection 1024 -> 1024 with a bf16 x); flash_attention_static
    (bf16 core) at (2, 16, L, 64) for each image-encoder L with no bias and
    with a visibility bias (-inf keys, a fully masked sample); the float
    twin's flash_attention at (2, 16, 1080 and 1800, 64) with that key bias.
    None of these row counts but 1800 and 360 is a multiple of 64."""
    gen = torch.Generator(device=DEV).manual_seed(4444)
    bad = []
    for L in T2V_L + T2V_VIDEO_L:
        for x_dtype in (torch.float32, torch.bfloat16) if L == T2V_L[-1] else (torch.float32,):
            ops = _t2i_mlp_operands(gen, (T2V_ROWS, L), x_dtype)
            for label, kw in _t2i_variants("mlp"):
                y = fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw)
                torch.cuda.synchronize()
                ref = fb.fused_int8_mlp_postln_plain(*ops, ln_eps=1e-5, **kw)
                if not _tol_check("fused_int8_mlp_postln", f"t2v {label} rows={T2V_ROWS}x{L} "
                                  f"x={x_dtype}", y, ref, like=ops[0]):
                    bad.append(f"mlp_postln {label} {L} {x_dtype}")
        for n in (3 * D, D):
            x, w, ws, b = _linear_operands(gen, T2V_ROWS * L, n)
            y = fb.int8_linear(x, w, ws, b, torch.bfloat16)
            torch.cuda.synchronize()
            if not _tol_check("int8_linear", f"t2v {T2V_ROWS * L}x{D}->{n} x={x.dtype}", y,
                              fb.int8_linear_plain(x, w, ws, b, torch.bfloat16)):
                bad.append(f"int8_linear {L} {n}")
    for x_dtype in (torch.bfloat16, torch.float32):
        ops = _diffusion_operands(gen, T2V_ROWS * T2V_PAD_P)
        ops[0], ops[1] = ops[0].to(x_dtype), ops[1].to(x_dtype)
        for label, kw in _t2i_variants("diffusion"):
            y = fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw)
            torch.cuda.synchronize()
            ref = fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5, **kw)
            if not _tol_check("fused_int8_diffusion_block", f"t2v {label} rows="
                              f"{T2V_ROWS * T2V_PAD_P} x={x_dtype}", y, ref, like=ops[0]):
                bad.append(f"diffusion {label} {x_dtype}")
    smax = torch.tensor(9.0, device=DEV)
    for L in T2V_L:
        kernels = [("flash_attention_static", lambda q, k, v, b: fa.flash_attention_static(
            q, k, v, smax, b), lambda q, k, v, b: fa.flash_attention_static_plain(q, k, v, smax,
                                                                                 b))]
        if L >= 1024:  # the float twin's flash route
            kernels.append(("flash_attention", fa.flash_attention,
                            lambda q, k, v, b: fa.flash_attention_plain(q, k, v, b)[0]))
        for name, kernel, plain in kernels:
            for bias_kind in ("none", "visibility") if name != "flash_attention" else \
                    ("visibility",):
                q, k, v, bias = _static_attention_operands(gen, L, bias_kind, rows=T2V_ROWS)
                o = kernel(q, k, v, bias)
                torch.cuda.synchronize()
                ref = plain(q, k, v, bias)
                label = f"t2v bias={bias_kind} ({T2V_ROWS}, {HEADS}, {L}, 64)"
                ok = _tol_check(name, label, o, ref, 2.0 ** -6, 2.0 ** -8, like=ref)
                if bias is not None:
                    dead_ok = bool((o[1] == 0).all())
                    print(f"    fully masked sample gives 0: {dead_ok}")
                    ok = ok and dead_ok
                if not ok:
                    bad.append(f"{name} {label}")
                del q, k, v, o, ref
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    fb.reset_launch_counts()


def _t2v_schedule():
    counts = masking.cosine_pred_counts(T2V_AR, T2V_NI)
    counts = counts[counts > 0]
    starts, pad_p = masking.pred_boundaries(counts)
    return counts, starts, pad_p


def _t2v_int8_launches(frames):
    """Launches of an int8 call of ``frames`` frames at 64 AR steps, from the
    model's structure: every AR step one image-encoder pass (32 layers: the
    static attention, row 5 and two int8_linear each) and 25 head evals of 6
    blocks (row 6); every frame one video-encoder pass (16 layers: row 5 and
    two int8_linear; its cached attention is the plain core)."""
    S = len(_t2v_schedule()[0])
    img, vid = frames * S * T2I_VIT_LAYERS, frames * T2I_V_LAYERS
    return {"flash_attention_static": img, "fused_int8_mlp_postln": img + vid,
            "fused_int8_diffusion_block": frames * S * T2V_DIFF * T2I_DIFF_BLOCKS,
            "int8_linear": 2 * (img + vid)}


def _t2v_flash_launches(frames):
    """flash_attention launches of a float call by the dispatcher's rule
    (ops/attention.flash_route), per frame: the image encoder's decoder half
    at 360 + 1440 keys every AR step, its encoder half at 360 + the bucket
    (a key bias) in each phase; the video encoder's cached layers take the
    plain core."""
    from nova_pointcloud_tpu_torch.ops.attention import flash_route
    from nova_pointcloud_tpu_torch.pipelines.nova import bucket_plan

    _, starts, _ = _t2v_schedule()
    half, lf = T2I_VIT_LAYERS // 2, T2V_NV + T2V_NI
    n = 0
    for s_b, s_e, bucket in bucket_plan(starts, T2V_NI):
        lk = T2V_NV + (T2V_NI if bucket is None else bucket)
        enc = flash_route(lk, lk, 64, (T2V_ROWS, 1, 1, lk), "auto", True)
        dec = flash_route(lf, lf, 64, None, "auto", True)
        n += (s_e - s_b) * half * (int(enc) + int(dec))
    return frames * n


def _make_t2v_pipeline(quantize, state_dict=None):
    """bench.py --mode t2v's model at full width and depth: seeded random
    weights with the zero-initialised AdaLN projections (the video mixer's
    too) and every bias filled, so the diffusion blocks, the mixer and the
    motion tokens all depend on their inputs; bf16 weights and compute."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = NOVATransformer(arch=T2I_ARCH, image_dim=4, image_base_size=T2V_BASE,
                            video_base_size=T2V_VIDEO_BASE, patch_size=2,
                            text_token_dim=T2V_TEXT_DIM, text_token_len=T2V_TEXT,
                            rotary_pos_embed=True, video_mixer_rank=T2V_RANK, quantize=quantize,
                            attn_core="bf16", dtype=torch.bfloat16, device=DEV)
    if state_dict is None:
        model.init_weights(gen).fill_zero_init(gen)
    else:
        model.load_state_dict(state_dict)
    model.to(torch.bfloat16)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"NOVA t2v {'int8' if quantize else 'float'} {T2I_ARCH}: {n_params / 1e6:.1f}M "
          f"parameters, {T2V_NI} image / {T2V_NV} video tokens a frame, batch {T2V_BATCH}")
    return NOVAPipeline(model, FlowMatchEulerScheduler(),
                        text_encoder=DummyTextEncoder(T2V_TEXT_DIM, T2V_TEXT))


def _t2v_draws(pipe, seed, frames, ar_steps):
    """Every frame's prediction order and every AR step's initial noise, drawn
    up front, so a comparison can replay a call with one input moved."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    _, counts, _, pad_p = pipe._schedule(ar_steps, T2V_DIFF)
    pd = pipe.model.patch_dim
    order = torch.argsort(torch.rand((frames, T2V_BATCH, T2V_NI), generator=gen, device=DEV),
                          dim=-1)
    noise = torch.randn((frames, len(counts), T2V_BATCH, pad_p, pd), generator=gen, device=DEV)
    return order, noise


def _t2v_sample(pipe, frames=T2V_FRAMES, ar_steps=T2V_AR, seed=1, **kw):
    out = pipe(T2V_PROMPTS, num_inference_steps=ar_steps, num_diffusion_steps=T2V_DIFF,
               max_latent_length=frames, guidance_scale=T2I_GUIDANCE, guidance_trunc=0.0,
               flow_shift=T2V_SHIFT, generator=torch.Generator(device=DEV).manual_seed(seed),
               output_type="latent", **kw)
    torch.cuda.synchronize()
    return out.latents.float()


def _t2v_output_ok(lat, frames, label):
    shape = (T2V_BATCH, frames, 2 * T2V_BASE[0], 2 * T2V_BASE[1], 4)
    ok = (tuple(lat.shape) == shape and bool(torch.isfinite(lat).all())
          and lat.std().item() > 0.05)
    print(f"{label} latents {tuple(lat.shape)} (expected {shape}) finite, std "
          f"{lat.std().item():.4f}: {'ok' if ok else 'FAIL'}")
    return ok


def _t2v_call_counted(pipe, label, frames, expected):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    lat = _t2v_sample(pipe, frames)
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    launches = dict(fb.LAUNCHES)
    counts_ok = launches == {n: expected.get(n, 0) for n in KERNELS}
    print(f"launches in one {label} call ({frames} frames x {T2V_AR} AR x {T2V_DIFF} steps, "
          f"{call_s:.2f} s, peak {peak / 2 ** 30:.2f} GiB above {held / 2 ** 30:.2f}): "
          f"{launches} (expected {expected}, else 0): {'ok' if counts_ok else 'FAIL'}")
    for name in expected:
        _record_launches(name, label, launches[name])
    ok = _t2v_output_ok(lat, frames, label)
    return counts_ok and ok, dict(launches=launches, output_ok=ok, output_std=lat.std().item(),
                                  call_s=call_s, frames=frames, peak_bytes=peak,
                                  held_bytes=held)


def _t2v_step_check(pipe, label, kernel):
    """Frame 0 (the BOS frame with the 258-token prefix) and frame 1 (a
    latent frame's patch tokens) through the video encoder's KV caches, the
    mixer, one image-encoder pass of the masking phase on the mixed states
    (half the tokens visible, 360 + 1440 keys: every layer on the path's
    attention kernel, 32 launches of ``kernel``) and one head eval at 72
    rows; kernels against plain, relative mean error gated at 2 x floor +
    1e-3 (floor: kernels against kernels with the frame, the canvas and x_t
    moved by 1e-6)."""
    model, qp = pipe.model, pipe.serving_qparams()
    gen = torch.Generator(device=DEV).manual_seed(12)
    pd = model.patch_dim
    with torch.no_grad():
        c = pipe.encode_prompt(T2V_PROMPTS, guidance=GuidanceConfig(guidance_scale=T2I_GUIDANCE))
        flow = torch.full((T2V_ROWS,), 5.0, device=DEV)
        c = torch.cat([c, model.embed_motion(T2V_ROWS, flow).to(c.dtype)], 1)
        frame = torch.randn((T2V_BATCH, 2 * T2V_BASE[0], 2 * T2V_BASE[1], 4), generator=gen,
                            device=DEV)
        canvas = torch.randn((T2V_BATCH, T2V_NI, pd), generator=gen, device=DEV)
        mask = (torch.rand((T2V_BATCH, T2V_NI, 1), generator=gen, device=DEV) < 0.5).float()
        x_t = torch.randn((T2V_ROWS, T2V_PAD_P, pd), generator=gen, device=DEV)
        t = torch.full((T2V_ROWS,), 500.0, device=DEV)

        def step(fr, cv, xt):
            caches = model.init_video_caches(T2V_ROWS, c.shape[1], 2)
            s0, caches = model.encode_frame(model.bos_frame(T2V_ROWS)[:, 0], c, caches, 0, 0,
                                            qparams=qp)
            s1, _ = model.encode_frame(model.embed_video_frame(fr).repeat(2, 1, 1), None, caches,
                                       c.shape[1] + T2V_NV, 1, qparams=qp)
            cond = model.mix_states(s0, s1)
            z = model.encode_image_step(model.tokens_from_patches(cv).repeat(2, 1, 1),
                                        mask.repeat(2, 1, 1), cond, qparams=qp)
            return (s1.float(), z.float(),
                    model.denoise_step(xt, t, z[:, :T2V_PAD_P], qparams=qp).float())

        def moved(a):
            return a + 1e-6 * torch.randn(a.shape, generator=gen, device=DEV)

        fb.reset_launch_counts()
        got = step(frame, canvas, x_t)
        launches = fb.LAUNCHES[kernel]
        with fb.use_plain_kernels():
            plain = step(frame, canvas, x_t)
        floor_run = step(moved(frame), moved(canvas), moved(x_t))
    torch.cuda.synchronize()
    res, ok = {}, launches == T2I_VIT_LAYERS
    for name, a, p, m in zip(("encode_frame (frame 1, cached)", "encode_image_step",
                              "denoise_step"), got, plain, floor_run):
        scale = p.abs().mean()
        rel = ((a - p).abs().mean() / scale).item()
        floor = ((a - m).abs().mean() / scale).item()
        good = bool(torch.isfinite(a).all()) and rel <= 2 * floor + 1e-3
        ok = ok and good
        print(f"{label} one {name}, kernels vs plain: mean |diff| / mean |plain| {rel:.3e} "
              f"(tol 2 x floor + 1e-3 = {2 * floor + 1e-3:.3e}; floor, inputs moved by 1e-6: "
              f"{floor:.3e}): {'ok' if good else 'FAIL'}")
        res[name] = dict(rel_err=rel, rel_floor=floor)
    print(f"{label} one step: {launches} {kernel} launches (expected {T2I_VIT_LAYERS}): "
          f"{'ok' if launches == T2I_VIT_LAYERS else 'FAIL'}")
    return ok, res


@phase("4k t2v int8 path")
def t2v_int8():
    """NOVAPipeline at bench.py --mode t2v's int8 setting: calibrate (16 AR
    steps, max_latent_length=2, margin 1.05), then one full call (9 frames
    x 64 AR x 25 steps) with exact launches (derived by _t2v_int8_launches:
    18144 flash_attention_static, 18288 fused_int8_mlp_postln, 85050
    fused_int8_diffusion_block, 36576 int8_linear, 0 of every other kernel)
    and finite latents (1, 9, 60, 96, 4) with a spread; a call of 2 frames x
    8 AR steps against the same call with the plain versions (gate 2 x
    floor + 1e-3; floor: the AR noise moved by 1e-6); the step check
    (_t2v_step_check); an i2v call (latents= given, 2 frames x 8 AR steps):
    frame 0 bitwise the given latents."""
    counts, _, pad_p = _t2v_schedule()
    if len(counts) != T2V_S or pad_p != T2V_PAD_P:
        raise AssertionError(f"cosine_pred_counts({T2V_AR}, {T2V_NI}): {len(counts)} steps, "
                             f"pad {pad_p}")
    expected = _t2v_int8_launches(T2V_FRAMES)
    print(f"derived launches of one call: {expected}")
    pipe = _make_t2v_pipeline(quantize=True)
    t0 = time.perf_counter()
    fb.reset_launch_counts()
    pipe.calibrate(T2V_PROMPTS, num_inference_steps=T2V_CAL_AR, num_diffusion_steps=T2V_DIFF,
                   guidance_scale=T2I_GUIDANCE, max_latent_length=2,
                   generator=torch.Generator(device=DEV).manual_seed(2), margin=1.05)
    torch.cuda.synchronize()
    cal_launches = {k: v for k, v in fb.LAUNCHES.items() if v}
    video_sites = sorted(pipe.act_scales["video_encoder"]["enc_layers"]["block"])
    print(f"calibrate ({T2V_CAL_AR} AR steps, then frames 0 and 1 through the caches): "
          f"{time.perf_counter() - t0:.1f} s, launches {cal_launches}; the video encoder's "
          f"sites {video_sites}")
    _t2v_sample(pipe, frames=2, ar_steps=2, seed=9)  # warm-up: kernel loads, allocator
    ok, rec = _t2v_call_counted(pipe, "t2v_int8", T2V_FRAMES, expected)

    order, noise = _t2v_draws(pipe, 3, T2V_CMP_FRAMES, T2V_CMP_AR)
    cmp_kw = dict(frames=T2V_CMP_FRAMES, ar_steps=T2V_CMP_AR, order=order)
    lat = _t2v_sample(pipe, noise=noise, **cmp_kw)
    fb.reset_launch_counts()
    with fb.use_plain_kernels():
        plain = _t2v_sample(pipe, noise=noise, **cmp_kw)
    plain_launches = dict(fb.LAUNCHES)
    moved = noise + 1e-6 * torch.randn(noise.shape, device=DEV,
                                       generator=torch.Generator(device=DEV).manual_seed(4))
    floor = (lat - _t2v_sample(pipe, noise=moved, **cmp_kw)).abs().mean().item()
    vs_plain = (lat - plain).abs().mean().item()
    tol = 2 * floor + 1e-3
    agree = vs_plain <= tol and not any(plain_launches.values())
    print(f"t2v_int8 ({T2V_CMP_FRAMES} frames x {T2V_CMP_AR} AR steps): kernels vs plain run "
          f"mean |diff| {vs_plain:.3e} (tol 2 x floor + 1e-3 = {tol:.3e}; floor, kernels vs "
          f"kernels with the AR noise moved by 1e-6: {floor:.3e}; mean |latent| "
          f"{lat.abs().mean().item():.3e}); plain run launched {plain_launches}: "
          f"{'ok' if agree else 'FAIL'}")
    step_ok, step = _t2v_step_check(pipe, "t2v_int8", "flash_attention_static")

    given = torch.randn((T2V_BATCH, 2 * T2V_BASE[0], 2 * T2V_BASE[1], 4), device=DEV,
                        generator=torch.Generator(device=DEV).manual_seed(5))
    i2v = _t2v_sample(pipe, T2V_CMP_FRAMES, T2V_CMP_AR, seed=6, latents=given)
    i2v_ok = bool(torch.equal(i2v[:, 0], given)) and _t2v_output_ok(i2v, T2V_CMP_FRAMES, "i2v")
    print(f"i2v ({T2V_CMP_FRAMES} frames x {T2V_CMP_AR} AR steps, latents= given): frame 0 "
          f"bitwise the given latents: {'ok' if i2v_ok else 'FAIL'}")
    report["t2v_int8"] = dict(rec, calibration_launches=cal_launches, video_sites=video_sites,
                              mean_abs_vs_plain=vs_plain, floor_mean_abs=floor, tol=tol,
                              compare_frames=T2V_CMP_FRAMES, compare_ar_steps=T2V_CMP_AR,
                              plain_launches=plain_launches, one_step=step, i2v_ok=i2v_ok)
    if not (ok and agree and step_ok and i2v_ok):
        raise AssertionError("t2v int8 check failed")
    return pipe


@phase("4l t2v float path")
def t2v_float(pipe_int8):
    """quantize=False on the same weights, 2 frames x 64 AR steps: the
    dispatcher's flash_attention launches by its 1024-key rule (derived by
    _t2v_flash_launches: 1552 a frame), 0 of every other kernel, finite
    latents; the step check against plain (the whole float call decorrelates
    under a 1e-6 move of its noise, ROADMAP queue 3)."""
    if pipe_int8 is None:
        raise AssertionError("no t2v weights: the int8 path failed")
    pipe = _make_t2v_pipeline(quantize=False, state_dict=pipe_int8.model.state_dict())
    expected = _t2v_flash_launches(T2V_FLOAT_FRAMES)
    print(f"flash_attention launches by the dispatcher's >= 1024-key rule: {expected}")
    _t2v_sample(pipe, frames=2, ar_steps=2, seed=9)  # warm-up
    ok, rec = _t2v_call_counted(pipe, "t2v_float", T2V_FLOAT_FRAMES,
                                {"flash_attention": expected})
    step_ok, step = _t2v_step_check(pipe, "t2v_float", "flash_attention")
    report["t2v_float"] = dict(rec, expected_flash=expected, one_step=step)
    if not (ok and step_ok and expected == T2V_FLASH_PER_FRAME * T2V_FLOAT_FRAMES):
        raise AssertionError("t2v float check failed")
    return pipe


@phase("5g timing of the t2v path")
def timing_t2v(pipe_int8, pipe_float):
    """Each kernel per launch at each t2v shape (the path's static route):
    row 5 and int8_linear at 2 x (540, 720, 1080, 1800, 618, 360) rows, the
    static attention at (2, 16, L, 64) for each image-encoder L beside
    SDPA's bf16 forward, flash_attention at (2, 16, 1080 and 1800, 64) with
    the key bias beside SDPA with that mask, row 6 at 72 rows; their plain
    versions and bounds. Then the latent call's (4k) videos/s and ms per
    frame beside the e2e call's (4n: this phase's extra full call, to uint8
    frames), one call each, and each one's peak memory above what was
    allocated before it; one float call of 2 frames (s per frame)."""
    import torch.nn.functional as Fn

    gen = torch.Generator(device=DEV).manual_seed(14)
    kw5 = _t2i_variants("mlp")[0][1]
    for L in T2V_L + T2V_VIDEO_L:
        m = T2V_ROWS * L
        ops = _t2i_mlp_operands(gen, (T2V_ROWS, L))
        _time_kernel(
            "fused_int8_mlp_postln", ("t2v", m, D, F),
            lambda: fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw5),
            lambda: fb.fused_int8_mlp_postln_plain(*ops, ln_eps=1e-5, **kw5),
            _bound(4 * m * D * F / PEAK_INT8_OPS,
                   2 * m * D * 4 + 2 * D * F + (F + 3 * D) * 2 + (F + D) * 4), graph=True)
        del ops
        for n in (3 * D, D):
            x, w, ws, b = _linear_operands(gen, m, n)
            _time_kernel("int8_linear", ("t2v", m, D, n),
                         lambda: fb.int8_linear(x, w, ws, b, torch.bfloat16),
                         lambda: fb.int8_linear_plain(x, w, ws, b, torch.bfloat16),
                         _bound(2 * m * D * n / PEAK_INT8_OPS,
                                m * D * x.element_size() + m * n * 2 + n * D + n * 2 + n * 4),
                         graph=True)
            del x
    smax = torch.tensor(9.0, device=DEV)
    bh = T2V_ROWS * HEADS
    for L in T2V_L:
        q, k, v, _ = _static_attention_operands(gen, L, "none", rows=T2V_ROWS)
        _time_kernel("flash_attention_static", ("t2v", T2V_ROWS, HEADS, L, 64),
                     lambda: fa.flash_attention_static(q, k, v, smax),
                     lambda: fa.flash_attention_static_plain(q, k, v, smax),
                     _bound(4 * bh * L * L * 64 / PEAK_BF16_FLOPS, 4 * bh * L * 64 * 2),
                     library=lambda: Fn.scaled_dot_product_attention(q, k, v), graph=True)
        if L >= 1024:
            q, k, v, bias = _static_attention_operands(gen, L, "visibility", rows=T2V_ROWS)
            mask = bias.to(q.dtype)
            live = int(torch.isfinite(bias).sum().item())  # keys this run's bias leaves
            _time_kernel("flash_attention", ("t2v key bias", T2V_ROWS, HEADS, L, 64),
                         lambda: fa.flash_attention(q, k, v, bias),
                         lambda: fa.flash_attention_plain(q, k, v, bias),
                         _bound(4 * HEADS * L * live * 64 / PEAK_BF16_FLOPS,
                                4 * bh * L * 64 * 2 + bias.numel() * 4),
                         library=lambda: Fn.scaled_dot_product_attention(q, k, v,
                                                                         attn_mask=mask),
                         graph=True)
        del q, k, v
    m = T2V_ROWS * T2V_PAD_P
    ops = _diffusion_operands(gen, m)
    kw6 = _t2i_variants("diffusion")[0][1]
    _time_kernel("fused_int8_diffusion_block", ("t2v", m, D),
                 lambda: fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw6),
                 lambda: fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5, **kw6),
                 _bound(2 * m * D * 5 * D / PEAK_INT8_OPS,
                        3 * m * D * 2 + 5 * D * D + (3 * D + 4 * D) * 2 + 5 * D * 4),
                 iters=200, graph=True)
    torch.cuda.empty_cache()
    if pipe_int8 is None or pipe_float is None:
        raise AssertionError("no t2v pipeline: phase 4k or 4l failed")
    e2e = report.get("t2v_e2e")
    if e2e is None:
        raise AssertionError("no t2v e2e call: phase 4n failed")
    latent_s, e2e_s = report["t2v_int8"]["call_s"], e2e["call_s"]
    t0 = time.perf_counter()
    _t2v_sample(pipe_float, frames=T2V_FLOAT_FRAMES, seed=21)
    float_s = time.perf_counter() - t0
    print(f"t2v_int8: batch {T2V_BATCH}, {T2V_FRAMES} frames x {T2V_AR} AR x {T2V_DIFF} steps: "
          f"the latent call (4k) {latent_s:.3f} s, {T2V_BATCH / latent_s:.4f} videos/s, "
          f"{latent_s / T2V_BATCH / T2V_FRAMES * 1e3:.1f} ms per frame; the e2e call to uint8 "
          f"frames (4n, the extra full call) {e2e_s:.3f} s, {T2V_BATCH / e2e_s:.4f} videos/s; "
          f"peak memory above what was allocated before the call: latent "
          f"{report['t2v_int8']['peak_bytes'] / 2 ** 30:.2f} GiB, e2e "
          f"{e2e['peak_bytes'] / 2 ** 30:.2f} GiB")
    print(f"t2v_float: {T2V_FLOAT_FRAMES} frames in {float_s:.3f} s, "
          f"{float_s / T2V_FLOAT_FRAMES:.3f} s per frame")
    report["t2v_int8"].update(videos_per_s=T2V_BATCH / latent_s,
                              ms_per_frame=latent_s / T2V_BATCH / T2V_FRAMES * 1e3,
                              e2e_call_s=e2e_s, e2e_videos_per_s=T2V_BATCH / e2e_s)
    report["t2v_float"].update(call_s_timed=float_s, s_per_frame=float_s / T2V_FLOAT_FRAMES)


def _vae_pipeline(pipe, vae):
    """``pipe``'s model, scheduler, text encoder and calibration, with ``vae``."""
    e2e = NOVAPipeline(pipe.model, pipe.scheduler, vae=vae, text_encoder=pipe.text_encoder)
    e2e.act_scales, e2e._act_margin = pipe.act_scales, pipe._act_margin
    return e2e


def _bench_vae(cls):
    """A bench VAE at its default widths, 4 latent channels, seeded random
    weights in bf16, computing in bf16."""
    vae = cls(latent_channels=4, dtype=torch.bfloat16, device=DEV)
    vae.init_weights(torch.Generator(device=DEV).manual_seed(VAE_SEED))
    return vae.to(torch.bfloat16)


def _rel(a, b):
    """(mean |a - b| / mean |b|, max |a - b| / max |b|) in float32."""
    a, b = a.float(), b.float()
    d = (a - b).abs()
    return (d.mean() / b.abs().mean()).item(), (d.max() / b.abs().max()).item()


@phase("4m the VAEs on the card against the CPU")
def vae_card_vs_cpu():
    """Each VAE class at a small size (VAE_SMALL) in f32, seeded weights
    made on the CPU and loaded on the card: encode (the posterior's mean and
    logvar) and decode on both, each tiling two windows; gate max |card -
    CPU| <= VAE_CPU_TOL x max |CPU|. Then the bench's two VAEs at their
    default widths (small latents, two decode windows for OpenSora): the
    bf16 decode against the f32 decode of the same bf16-rounded weights on
    the card, gate VAE_BF16_TOL. No VAE call launches a kernel of the
    repo."""
    fb.reset_launch_counts()
    res, ok = {}, True
    for name, (cls_name, cfg, xs, zs) in VAE_SMALL.items():
        cls = globals()[cls_name]
        gen = torch.Generator().manual_seed(30)
        cpu = cls(**cfg, device="cpu").init_weights(gen)
        card = cls(**cfg, device=DEV)
        card.load_state_dict(cpu.state_dict())
        x, z = torch.randn(xs, generator=gen), torch.randn(zs, generator=gen)
        t0 = time.perf_counter()
        with torch.no_grad():
            want = (cpu.encode(x), cpu.decode(z))
            cpu_s = time.perf_counter() - t0
            got = (card.encode(x.to(DEV)), card.decode(z.to(DEV)))
        torch.cuda.synchronize()
        errs = {what: _rel(a.cpu(), b)[1] for what, a, b in (
            ("mean", got[0].mean, want[0].mean), ("logvar", got[0].logvar, want[0].logvar),
            ("decode", got[1], want[1]))}
        good = all(e <= VAE_CPU_TOL for e in errs.values()) and all(
            bool(torch.isfinite(t).all()) for t in (got[0].mean, got[1]))
        ok = ok and good
        n = sum(p.numel() for p in cpu.parameters())
        print(f"{name} ({n / 1e6:.1f}M parameters) f32, encode {xs} -> "
              f"{tuple(got[0].mean.shape)}, decode {zs} -> {tuple(got[1].shape)}: card vs CPU "
              f"max |diff| / max |CPU| " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
              + f" (tol {VAE_CPU_TOL:g}; CPU {cpu_s:.1f} s): {'ok' if good else 'FAIL'}")
        res[name] = dict(errs, cpu_s=cpu_s, params=n)
        del cpu, card, got, want
    for name, cls, zs, cfg in (("AutoencoderKL", AutoencoderKL, (2, 16, 16, 4), {}),
                               ("AutoencoderKLOpenSora", AutoencoderKLOpenSora,
                                (1, 5, 16, 16, 4), dict(latent_min_t=3))):
        bf = cls(latent_channels=4, dtype=torch.bfloat16, device=DEV, **cfg)
        bf.init_weights(torch.Generator(device=DEV).manual_seed(31))
        bf.to(torch.bfloat16)
        f32 = cls(latent_channels=4, device=DEV, **cfg)
        f32.load_state_dict(bf.state_dict())
        z = torch.randn(zs, device=DEV, generator=torch.Generator(device=DEV).manual_seed(32))
        with torch.no_grad():
            ref, got = f32.decode(z), bf.decode(z)
        mean_rel, max_rel = _rel(got, ref)
        good = (got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all())
                and mean_rel <= VAE_BF16_TOL[0] and max_rel <= VAE_BF16_TOL[1])
        ok = ok and good
        print(f"{name} at its default widths, decode {zs} -> {tuple(got.shape)}: bf16 vs f32 on "
              f"the card mean |diff| / mean |f32| {mean_rel:.3e}, max / max {max_rel:.3e} (tol "
              f"{VAE_BF16_TOL[0]:g}, {VAE_BF16_TOL[1]:g}): {'ok' if good else 'FAIL'}")
        res[f"{name} bf16"] = dict(mean_rel=mean_rel, max_rel=max_rel)
        del bf, f32, ref, got
    launches = {k: v for k, v in fb.LAUNCHES.items() if v}
    print(f"kernel launches in the VAE calls: {launches or 0} (expected 0): "
          f"{'ok' if not launches else 'FAIL'}")
    report["vae_card_vs_cpu"] = dict(res, launches=launches)
    torch.cuda.empty_cache()
    if not ok or launches:
        raise AssertionError("VAE check failed")


def _u8_ok(arr, shape, label):
    good = (isinstance(arr, np.ndarray) and arr.dtype == np.uint8 and arr.shape == shape
            and float(arr.std()) > 1.0)
    print(f"{label}: {getattr(arr, 'shape', None)} {getattr(arr, 'dtype', None)} (expected "
          f"{shape} uint8), std {float(np.std(arr)):.2f} codes: {'ok' if good else 'FAIL'}")
    return good


@phase("4n t2i / t2v / i2v end to end")
def e2e(pipe_t2i, pipe_t2v):
    """bench.py --e2e's calls on the calibrated int8 pipelines of 4d and 4k
    with the bench VAEs (bf16, default widths): t2i, one call of 64 AR x 25
    steps at batch 4 with output_type="np" -> (4, 512, 512, 3) uint8; t2v,
    one 9-frame call -> (1, 33, 480, 768, 3) uint8 from exactly 2 decode
    windows (its time and peak memory are 5g's e2e numbers); the launches of
    each equal the latent call's, the pixels are not constant. i2v:
    encode_image of a seeded 480 x 768 uint8 image -> (1, 60, 96, 4)
    latents, which a prefilled call (2 frames x 8 AR steps) returns
    bitwise as frame 0. Returns the two VAEs."""
    if pipe_t2i is None or pipe_t2v is None:
        raise AssertionError("no int8 pipeline: phase 4d or 4k failed")
    vae_i, vae_v = _bench_vae(AutoencoderKL), _bench_vae(AutoencoderKLOpenSora)
    pipe = _vae_pipeline(pipe_t2i, vae_i)
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(T2I_PROMPTS, num_inference_steps=T2I_AR, num_diffusion_steps=T2I_DIFF,
               guidance_scale=T2I_GUIDANCE, guidance_trunc=0.0,
               generator=torch.Generator(device=DEV).manual_seed(1), output_type="np")
    call_s = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    counts_ok = launches == {n: T2I_INT8_LAUNCHES.get(n, 0) for n in KERNELS}
    print(f"t2i e2e call ({call_s:.2f} s): launches {launches} (the latent call's "
          f"{T2I_INT8_LAUNCHES}, else 0): {'ok' if counts_ok else 'FAIL'}")
    for name in T2I_INT8_LAUNCHES:
        _record_launches(name, "t2i_e2e", launches[name])
    ok = _u8_ok(out.images, T2I_IMAGE_SHAPE, "t2i images") and counts_ok
    report["t2i_e2e"] = dict(call_s=call_s, launches=launches)

    pipe = _vae_pipeline(pipe_t2v, vae_v)
    windows, decode_window = [], vae_v.decode_window

    def counted_window(z):
        windows.append(tuple(z.shape))
        return decode_window(z)

    vae_v.decode_window = counted_window
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        out = pipe(T2V_PROMPTS, num_inference_steps=T2V_AR, num_diffusion_steps=T2V_DIFF,
                   max_latent_length=T2V_FRAMES, guidance_scale=T2I_GUIDANCE, guidance_trunc=0.0,
                   flow_shift=T2V_SHIFT, generator=torch.Generator(device=DEV).manual_seed(21),
                   output_type="np")
    finally:
        del vae_v.decode_window
    call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    launches = dict(fb.LAUNCHES)
    expected = _t2v_int8_launches(T2V_FRAMES)
    counts_ok = launches == {n: expected.get(n, 0) for n in KERNELS}
    print(f"t2v e2e call ({call_s:.2f} s, peak {peak / 2 ** 30:.2f} GiB above "
          f"{held / 2 ** 30:.2f}): launches {launches} (the latent call's {expected}, else 0): "
          f"{'ok' if counts_ok else 'FAIL'}; decode windows {windows} (expected "
          f"{T2V_DECODE_WINDOWS}): {'ok' if len(windows) == T2V_DECODE_WINDOWS else 'FAIL'}")
    for name in expected:
        _record_launches(name, "t2v_e2e", launches[name])
    ok = (_u8_ok(out.frames, T2V_VIDEO_SHAPE, "t2v frames") and ok and counts_ok
          and len(windows) == T2V_DECODE_WINDOWS)
    report["t2v_e2e"] = dict(call_s=call_s, launches=launches, windows=len(windows),
                             peak_bytes=peak, held_bytes=held)

    image = torch.randint(0, 256, (16 * T2V_BASE[0], 16 * T2V_BASE[1], 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(5)).numpy()
    lat = pipe.encode_image(image)
    shape = (1, 2 * T2V_BASE[0], 2 * T2V_BASE[1], 4)
    lat_ok = (tuple(lat.shape) == shape and lat.dtype == torch.float32
              and bool(torch.isfinite(lat).all()))
    i2v = _t2v_sample(pipe, T2V_CMP_FRAMES, T2V_CMP_AR, seed=6, latents=lat)
    i2v_ok = _t2v_output_ok(i2v, T2V_CMP_FRAMES, "i2v from encode_image") and lat_ok and bool(
        torch.equal(i2v[:, 0], lat))
    print(f"encode_image {image.shape} uint8 -> {tuple(lat.shape)} (expected {shape}) float32, "
          f"std {lat.std().item():.4f}; the prefilled call's ({T2V_CMP_FRAMES} frames x "
          f"{T2V_CMP_AR} AR steps) frame 0 bitwise the encoded latents: "
          f"{'ok' if i2v_ok else 'FAIL'}")
    report["i2v_e2e"] = dict(latents_shape=list(lat.shape), ok=i2v_ok)
    if not (ok and i2v_ok):
        raise AssertionError("e2e check failed")
    return vae_i, vae_v


def _event_ms(fn, n=3):
    """ms of each of ``n`` calls after one warm-up, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return out


def _decode_latents(gen):
    """Seeded bench-shaped latents: the t2i batch (4, 64, 64, 4) and the
    t2v video (1, 9, 60, 96, 4)."""
    return (torch.randn((T2I_BATCH, 2 * T2I_BASE[0], 2 * T2I_BASE[1], 4), device=DEV,
                        generator=gen),
            torch.randn(T2V_LATENT_SHAPE, device=DEV, generator=gen))


@phase("5h timing of the decode")
def timing_decode(vaes, pipe_t2v):
    """The bench VAEs' decodes through VaeImageProcessor.decode_latents
    (p50 of 3 by CUDA events): t2i a batch of 4 (64 x 64 latents, two
    micro-batches of 2), t2v a video (9 x 60 x 96 latents, 2 windows) and
    one window (5 latents); each one's peak memory above what is held, its
    FLOPs (FlopCounterMode: the convolutions from their shapes, and the
    attention and projection products) and TFLOP/s against 989 bf16 dense;
    the decode's share of phase 4n's e2e call; encode_image's ms."""
    from torch.utils.flop_counter import FlopCounterMode

    if vaes is None:
        raise AssertionError("no bench VAEs: phase 4n failed")
    vae_i, vae_v = vaes
    z_i, z_v = _decode_latents(torch.Generator(device=DEV).manual_seed(33))
    proc_i, proc_v = VaeImageProcessor(vae_i), VaeImageProcessor(vae_v)
    cases = (("t2i batch of 4", lambda: proc_i.decode_latents(z_i), "t2i_e2e"),
             ("t2v video", lambda: proc_v.decode_latents(z_v), "t2v_e2e"),
             ("t2v window", lambda: vae_v.decode_window(z_v[:, :vae_v.latent_min_t]), None))
    res = {}
    with torch.no_grad():
        for label, fn, e2e_key in cases:
            times = _event_ms(fn)
            ms = float(np.percentile(times, 50))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            with FlopCounterMode(display=False) as counter:
                fn()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - held
            flops = counter.get_total_flops()
            conv = sum(v for k, v in counter.get_flop_counts()["Global"].items()
                       if "convolution" in str(k))
            tflops = flops / (ms * 1e-3) / 1e12
            line = (f"{label} decode: p50 {ms:.1f} ms (times {[round(t, 1) for t in times]}), "
                    f"peak {peak / 2 ** 30:.2f} GiB above {held / 2 ** 30:.2f}, "
                    f"{flops / 1e12:.2f} TFLOP ({conv / 1e12:.2f} in convolutions), "
                    f"{tflops:.1f} TFLOP/s = {tflops / (PEAK_BF16_FLOPS / 1e12):.1%} of 989 bf16 "
                    f"dense")
            res[label] = dict(ms=ms, times_ms=times, peak_bytes=peak, held_bytes=held,
                              flops=flops, conv_flops=conv, tflops=tflops)
            if e2e_key in report:
                share = ms * 1e-3 / report[e2e_key]["call_s"]
                line += f"; {share:.2%} of the e2e call ({report[e2e_key]['call_s']:.2f} s)"
                res[label]["share_of_e2e"] = share
            print(line)
        if pipe_t2v is not None:
            pipe = NOVAPipeline(pipe_t2v.model, vae=vae_v)
            image = torch.randint(0, 256, (16 * T2V_BASE[0], 16 * T2V_BASE[1], 3),
                                  dtype=torch.uint8,
                                  generator=torch.Generator().manual_seed(5)).numpy()
            times = _event_ms(lambda: pipe.encode_image(image))
            res["encode_image"] = dict(ms=float(np.percentile(times, 50)), times_ms=times)
            print(f"encode_image (480 x 768 -> 60 x 96 x 4): p50 "
                  f"{res['encode_image']['ms']:.1f} ms (times {[round(t, 1) for t in times]})")
    report["decode"] = res
    torch.cuda.empty_cache()


def _phi_inputs():
    """PHI_BATCH rows of PHI_TOKENS token ids (the released config's
    text_token_len): a full prompt, one half padded, an empty prompt (all
    padding: every attention row fully masked) and a short one."""
    gen = torch.Generator().manual_seed(41)
    ids = torch.randint(0, PhiConfig().vocab_size, (PHI_BATCH, PHI_TOKENS), generator=gen)
    mask = torch.ones_like(ids)
    mask[1, PHI_TOKENS // 2:] = 0
    mask[2] = 0
    mask[3, 17:] = 0
    return ids, mask


def _phi_empty_row(model, ids):
    """The encoder on one all-padding row without an attention core: each
    block's attention output is its out-projection's bias (the guarded
    plain core gives zeros for a fully masked row)."""
    x = model.embed_tokens.weight[ids]
    for blk in model.layers:
        h = layer_norm(x, blk.input_layernorm, model.config.layer_norm_eps)
        m = dense(torch.nn.functional.gelu(dense(h, blk.fc1), approximate="tanh"), blk.fc2)
        x = x + blk.self_attn.dense.bias + m
    return layer_norm(x, model.final_layernorm, model.config.layer_norm_eps)


def _phi_flops(cfg, batch, tokens):
    """Dense and attention-product FLOPs of one encode (every key computed,
    the masked ones too)."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    per_token = 2 * (4 * d * d + 2 * d * f) + 4 * tokens * d
    return batch * tokens * cfg.num_hidden_layers * per_token


@phase("4o the Phi text encoder")
def phi_encoder():
    """PhiConfig() at full size (32 layers, 2560 wide, 32 heads, 51200
    tokens), f32 with TF32 off, seeded init on the card: one encode of
    PHI_BATCH x PHI_TOKENS ids (_phi_inputs): finite (B, L, 2560) float32;
    the all-padding row against its plain recomputation (_phi_empty_row),
    gate PHI_PAD_TOL x max; ms per encode (p50 of 3 by CUDA events),
    TFLOP/s against the f32 peak (67), peak memory above what is held. Then
    the first PHI_CMP_LAYERS layers at full width on the card against the
    same weights on the CPU, gate PHI_CPU_TOL x max |CPU|. Launches no
    kernel of the repo. Returns the full prompt's embeddings (1, 256, 2560)
    on the CPU for 4p."""
    cfg = PhiConfig()
    ids, mask = _phi_inputs()
    ids_d, mask_d = ids.to(DEV), mask.to(DEV)
    fb.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    model = PhiEncoderModel(cfg, device=DEV).init_weights(
        torch.Generator(device=DEV).manual_seed(40))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        out = model(ids_d, mask_d)
        times = _event_ms(lambda: model(ids_d, mask_d))
        empty = _phi_empty_row(model, ids_d[2])
    peak = torch.cuda.max_memory_allocated() - held
    ms = float(np.median(times))
    flops = _phi_flops(cfg, PHI_BATCH, PHI_TOKENS)
    pad_err = ((out[2] - empty).abs().max() / empty.abs().max()).item()
    ok = (tuple(out.shape) == (PHI_BATCH, PHI_TOKENS, cfg.hidden_size)
          and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
          and pad_err <= PHI_PAD_TOL)
    print(f"Phi-2 encoder {n_params / 1e9:.3f}B parameters f32 (built in {build_s:.1f} s): "
          f"encode {tuple(ids.shape)} -> {tuple(out.shape)} {str(out.dtype)[6:]}, finite; "
          f"all-padding row vs its plain recomputation max |diff| / max {pad_err:.2e} (tol "
          f"{PHI_PAD_TOL:g}): {'ok' if ok else 'FAIL'}")
    print(f"  {ms:.2f} ms per encode (events {[round(t, 2) for t in times]}), "
          f"{flops / 1e12:.2f} TFLOP, {flops / ms / 1e9:.1f} TFLOP/s "
          f"({flops / ms / 1e9 / (PEAK_F32_FLOPS / 1e12):.1%} of the f32 peak), peak "
          f"{peak / 2 ** 30:.2f} GiB above {held / 2 ** 30:.2f}")
    emb = out[:1].cpu()
    cmp_sd = {k: v for k, v in model.state_dict().items()
              if not k.startswith("layers.") or int(k.split(".")[1]) < PHI_CMP_LAYERS}
    del model, out, empty
    torch.cuda.empty_cache()
    cfg2 = dataclasses.replace(cfg, num_hidden_layers=PHI_CMP_LAYERS)
    card = PhiEncoderModel(cfg2, device=DEV)
    card.load_state_dict(cmp_sd)
    cpu = PhiEncoderModel(cfg2, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in cmp_sd.items()})
    del cmp_sd
    t0 = time.perf_counter()
    with torch.no_grad():
        got = card(ids_d, mask_d).cpu()
        want = cpu(ids, mask)
    cpu_err = ((got - want).abs().max() / want.abs().max()).item()
    good = cpu_err <= PHI_CPU_TOL and bool(torch.isfinite(got).all())
    launches = {k: v for k, v in fb.LAUNCHES.items() if v}
    print(f"  {PHI_CMP_LAYERS} of {cfg.num_hidden_layers} layers at full width, card vs CPU: "
          f"max |diff| / max |CPU| {cpu_err:.2e} (tol {PHI_CPU_TOL:g}; "
          f"{time.perf_counter() - t0:.1f} s): {'ok' if good else 'FAIL'}; kernel launches "
          f"{launches or 0} (expected 0)")
    report["phi"] = dict(params=n_params, encode_ms=ms, encode_events_ms=times, flops=flops,
                         tflops_s=flops / ms / 1e9, peak_bytes=peak, pad_rel_err=pad_err,
                         cpu_rel_err=cpu_err, cpu_layers=PHI_CMP_LAYERS)
    del card, cpu, got, want
    torch.cuda.empty_cache()
    if not (ok and good and not launches):
        raise AssertionError("Phi check failed")
    return emb


def _vae_reference_state_dict(vae):
    """An AutoencoderKL's weights under diffusers' names: the loader
    (load_torch_vae_weights) reads a one-element marker for each name it
    asks for, and each marker lands on the port key it fills."""
    class Markers(dict):
        def __missing__(self, name):
            self[name] = np.full((1, 1, 1, 1), float(len(self)), np.float32)
            return self[name]

    names = Markers()
    port_of = {int(v.reshape(-1)[0]): k
               for k, v in load_torch_vae_weights(vae, names).items()}
    sd = vae.state_dict()
    return {name: sd[port_of[int(m.reshape(-1)[0])]] for name, m in names.items()}


def _phi_reference_state_dict(model):
    """The encoder's weights under HF PhiForCausalLM names."""
    return {"model." + re.sub(r"^layers\.(\d+)\.(fc[12])\.", r"layers.\1.mlp.\2.", k): v
            for k, v in model.state_dict().items()}


def _save_component(path, sd, config=None, shards=1):
    """bf16 safetensors shards (the names dealt round-robin) and the
    component's config.json."""
    os.makedirs(path, exist_ok=True)
    names = sorted(sd)
    for i in range(shards):
        safetensors_io.save_file(
            {k: sd[k].to(torch.bfloat16) for k in names[i::shards]},
            os.path.join(path, f"diffusion_pytorch_model-{i + 1:05d}-of-{shards:05d}.safetensors"))
    if config is not None:
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(config, f)


def _write_released_dir(root, model_cfg=RELEASED_MODEL):
    """A reference checkpoint directory of the released NOVA-0.6B 1024px
    config (or, with ``model_cfg`` XL_MODEL, NOVA-1.4B's): model_index.json
    (NOVAPipeline); transformer/ (``model_cfg``,
    seeded random weights with the AdaLN projections and biases filled,
    under the reference names, bf16 in 2 shards); scheduler/ (FlowMatch,
    shift 1.0); vae/ (the SDXL AutoencoderKL, seeded); text_encoder/ (Phi-2
    at full width and 2 layers, seeded, HF names). No tokenizer/: the card
    has no transformers, so from_pretrained skips the text encoder. Returns
    the directory's bytes and what the transformer and the VAE must load:
    their weights as written (bf16), under the port's keys, on the host."""
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device=DEV).manual_seed(50)
    model = build_transformer(model_cfg, device=DEV)
    model.init_weights(gen).fill_zero_init(gen)
    _save_component(os.path.join(root, "transformer"), reference_state_dict(model),
                    {"_class_name": "NOVATransformer3DModel", **model_cfg}, shards=2)
    written = {"transformer": _bf16_host_copy(model)}
    del model
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump({"_class_name": "FlowMatchEulerDiscreteScheduler",
                   "num_train_timesteps": 1000, "shift": 1.0}, f)
    vae = AutoencoderKL(**SDXL_VAE, device=DEV).init_weights(gen)
    _save_component(os.path.join(root, "vae"), _vae_reference_state_dict(vae),
                    {"_class_name": "AutoencoderKL", **SDXL_VAE})
    written["vae"] = _bf16_host_copy(vae)
    del vae
    phi_cfg = dataclasses.replace(PhiConfig(), num_hidden_layers=2)
    phi = PhiEncoderModel(phi_cfg, device=DEV).init_weights(gen)
    _save_component(os.path.join(root, "text_encoder"), _phi_reference_state_dict(phi),
                    {"architectures": ["PhiForCausalLM"], "model_type": "phi",
                     **dataclasses.asdict(phi_cfg)})
    del phi
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump({"_class_name": "NOVAPipeline",
                   "transformer": ["diffnext", "NOVATransformer3DModel"],
                   "scheduler": ["diffnext", "FlowMatchEulerDiscreteScheduler"],
                   "vae": ["diffnext", "AutoencoderKL"],
                   "text_encoder": ["transformers", "PhiForCausalLM"]}, f)
    torch.cuda.empty_cache()
    return sum(p.stat().st_size for p in Path(root).rglob("*") if p.is_file()), written


def _bf16_host_copy(module):
    """A module's state dict with its floating tensors in bf16, on the host."""
    return {k: (v.to(torch.bfloat16) if v.is_floating_point() else v).cpu()
            for k, v in module.state_dict().items()}


def _same_weights(module, written):
    """Whether ``module`` holds exactly the keys of ``written`` and, bitwise,
    their tensors (a loader that swaps two same-shaped tensors fails)."""
    sd = module.state_dict()
    return sd.keys() == written.keys() and all(
        sd[k].dtype == w.dtype and torch.equal(sd[k].cpu(), w) for k, w in written.items())


def _released_flash_check(gen):
    """flash_attention at the released config's image-encoder shape (2, 16,
    5120, 64) bf16: the video states (1024) + the image tokens (4096) as
    keys, no bias (the decoder half) and a key bias (the encoder half in the
    masking phase), against its plain version at 3c's bf16 tolerance; timed
    with its plain version, SDPA and the bound (4 B H L^2 d FLOPs at the
    bf16 peak, or q, k, v, o once)."""
    import torch.nn.functional as Fn

    b, h, L = 2, HEADS, RELEASED_NV + RELEASED_NI
    ok = True
    for kind in ("none", "key"):
        q, k, v = _flash_operands(gen, b, h, L, L, 64)
        bias = _flash_bias(gen, kind, b, L, L)
        o, _ = fa.flash_attention_with_lse(q, k, v, bias)
        ref, _ = fa.flash_attention_plain(q, k, v, bias)
        ok = _tol_check("flash_attention", f"bias={kind} bf16 Lk={L} (released 1024px)", o, ref,
                        2.0 ** -6, 2.0 ** -8, like=ref) and ok
        del o, ref, bias
    row = _time_kernel("flash_attention", (b, h, L, 64),
                       lambda: fa.flash_attention(q, k, v),
                       lambda: fa.flash_attention_plain(q, k, v),
                       _bound(4 * b * h * L * L * 64 / PEAK_BF16_FLOPS, 4 * b * h * L * 64 * 2),
                       library=lambda: Fn.scaled_dot_product_attention(q, k, v), graph=True)
    del q, k, v
    torch.cuda.empty_cache()
    return ok, row


@phase("4p from_pretrained at the released 1024px config")
def released_1024(emb):
    """The released NOVA-0.6B 1024px config (RELEASED_MODEL, from
    nova_pointcloud_tpu/configs/nova_d48w1024_sdxl1024.yaml: 64 x 64 image
    and 32 x 32 video patches, text 256 x 2560) through a reference
    checkpoint directory (_write_released_dir, about 2 GB, removed at the
    end): from_pretrained(dir, dtype=bfloat16), its load time and rate (a
    warm read: the files were just written); one prompt with 4o's
    embeddings as prompt_embeds, 64 AR x 25 steps, CFG 5.0, output_type
    "np" -> (1, 1024, 1024, 3) uint8, its flash_attention launches exactly
    _flash_route_launches of the model (every attention of the call: 1280
    video keys, 1536 / 2048 / 3072 / 5120 image keys) and 0 of every other
    kernel, its time and peak memory; the transformer's and the VAE's
    weights bitwise those written; the same call on a pipeline built by
    build_pipeline from the written weights and the config, with the same
    VAE and generator: bitwise the same pixels. First, flash_attention at the
    call's largest shape against its plain version and timed
    (_released_flash_check)."""
    if emb is None:
        raise AssertionError("no prompt embeddings: phase 4o failed")
    gen = torch.Generator(device=DEV).manual_seed(51)
    flash_ok, flash_row = _released_flash_check(gen)
    try:
        pipe, written, kw, out, rec, ok = _released_call(RELEASED_DIR, RELEASED_MODEL, emb,
                                                         "released_1024px")
        cfg = {"pipeline": {"name": "NOVAPipeline"}, "model": RELEASED_MODEL,
               "scheduler": {"_sample_class_name": "FlowMatchEulerScheduler", "shift": 1.0}}
        twin, _ = build_pipeline(cfg, state_dict=written.pop("transformer"), dtype=torch.bfloat16)
        twin = NOVAPipeline(twin.model.to(torch.bfloat16), twin.scheduler, vae=pipe.vae)
        again = twin(**kw, generator=torch.Generator(device=DEV).manual_seed(52))
        bitwise = bool(np.array_equal(out.images, again.images))
        print(f"the same call on build_pipeline's pipeline (the weights written, the VAE and "
              f"generator): {'bitwise equal' if bitwise else 'DIFFERS'} (max |diff| "
              f"{np.abs(out.images.astype(int) - again.images.astype(int)).max()} codes)")
        report["released_1024px"] = dict(rec, bitwise_twin=bitwise, flash=flash_row)
        del pipe, twin, out, again, written
    finally:
        shutil.rmtree(RELEASED_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    if not (flash_ok and ok and bitwise):
        raise AssertionError("released 1024px check failed")


def _released_call(root, model_cfg, emb, label):
    """A reference directory of ``model_cfg`` written under ``root``
    (_write_released_dir), loaded by from_pretrained(dtype=bfloat16) (its
    time and rate: a warm read, the files were just written), the
    transformer's and the VAE's weights checked bitwise those written; one
    prompt with 4o's embeddings, 64 AR x 25 steps, CFG 5.0, output_type
    "np" -> (1, 1024, 1024, 3) uint8, its flash_attention launches exactly
    _flash_route_launches of the model and 0 of every other kernel, its
    time and peak memory. Returns (pipeline, the weights written, the call's
    arguments, its output, the record, whether every check passed); the
    caller removes ``root``."""
    t0 = time.perf_counter()
    nbytes, written = _write_released_dir(root, model_cfg)
    write_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = from_pretrained(root, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    model = pipe.model
    loaded = (pipe.text_encoder is None and pipe.vae is not None
              and {p.dtype for p in model.parameters()} == {torch.bfloat16}
              and pipe.vae.scaling_factor == SDXL_VAE["scaling_factor"])
    n_params = sum(p.numel() for p in model.parameters())
    same = {name: _same_weights(mod, written[name])
            for name, mod in (("transformer", model), ("vae", pipe.vae))}
    loaded = loaded and all(same.values())
    print(f"wrote the reference directory ({nbytes / 1e9:.2f} GB) in {write_s:.1f} s; "
          f"from_pretrained(dtype=bfloat16): {load_s:.2f} s, {nbytes / load_s / 1e9:.2f} "
          f"GB/s (warm read), {n_params / 1e6:.1f}M transformer parameters bf16 (head dim "
          f"{model.head_dim_i}), the SDXL VAE, no text encoder (no tokenizer/); the weights "
          f"loaded bitwise those written: {same}: {'ok' if loaded else 'FAIL'}")
    expected = _flash_route_launches(pipe, RELEASED_AR, text_len=RELEASED_TEXT)
    kw = dict(prompt_embeds=emb.numpy(), num_inference_steps=RELEASED_AR,
              num_diffusion_steps=RELEASED_DIFF, guidance_scale=RELEASED_GUIDANCE,
              output_type="np")
    pipe(**{**kw, "num_inference_steps": 4}, generator=torch.Generator(device=DEV))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(**kw, generator=torch.Generator(device=DEV).manual_seed(52))
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - held
    counts_ok = launches == {n: expected if n == "flash_attention" else 0 for n in KERNELS}
    print(f"one call at 1024 x 1024 ({call_s:.2f} s, peak {peak / 2 ** 30:.2f} GiB above "
          f"{held / 2 ** 30:.2f}): flash_attention launches {launches['flash_attention']} "
          f"(expected {expected}), others "
          f"{ {k: v for k, v in launches.items() if v and k != 'flash_attention'} or 0}: "
          f"{'ok' if counts_ok else 'FAIL'}")
    _record_launches("flash_attention", label, launches["flash_attention"])
    ok = _u8_ok(out.images, RELEASED_IMAGE_SHAPE, f"{label} images")
    rec = dict(dir_bytes=nbytes, write_s=write_s, load_s=load_s,
               load_gb_s=nbytes / load_s / 1e9, call_s=call_s, peak_bytes=peak, held_bytes=held,
               launches=launches, expected_flash=expected, weights_as_written=same,
               params_m=n_params / 1e6)
    return pipe, written, kw, out, rec, loaded and counts_ok and ok


@phase("4q c2i int8 serving")
def c2i_int8(vae):
    """NOVAC2IPipeline over bench.py --mode t2i's model (T2I_ARCH, 32 x 32
    latent patches) with num_classes=C2I_CLASSES and no text, seeded random
    weights with the AdaLN projections, the biases and the label norm's bias
    filled, bf16: calibrated as 4d (16 AR steps, margin 1.05), one call of
    C2I_LABELS at 64 AR x 25 steps, CFG 5.0 against the null class, decoded
    by 4n's AutoencoderKL to (4, 512, 512, 3) uint8: the launches of rows
    5, 6, 8 and int8_linear exactly the t2i int8 call's (T2I_INT8_LAUNCHES:
    the 1-token class prefix changes no count) and 0 of every other kernel,
    samples/s; one step against the plain route at 4d's gates
    (_t2i_step_check)."""
    if vae is None:
        raise AssertionError("no VAE: phase 4n failed")
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = NOVATransformer(arch=T2I_ARCH, image_dim=4, image_base_size=T2I_BASE,
                            video_base_size=T2I_VIDEO_BASE, patch_size=2,
                            num_classes=C2I_CLASSES, quantize=True, attn_core="bf16",
                            dtype=torch.bfloat16, device=DEV)
    model.init_weights(gen).fill_zero_init(gen)
    pipe = NOVAC2IPipeline(model.to(torch.bfloat16), FlowMatchEulerScheduler(), vae=vae)
    t0 = time.perf_counter()
    pipe.calibrate(C2I_LABELS, num_inference_steps=T2I_CAL_AR, num_diffusion_steps=T2I_DIFF,
                   guidance_scale=T2I_GUIDANCE,
                   generator=torch.Generator(device=DEV).manual_seed(2), margin=1.05)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    kw = dict(num_diffusion_steps=T2I_DIFF, guidance_scale=T2I_GUIDANCE)
    pipe(C2I_LABELS, num_inference_steps=4, generator=torch.Generator(device=DEV), **kw)
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    out = pipe(C2I_LABELS, num_inference_steps=T2I_AR, output_type="np",
               generator=torch.Generator(device=DEV).manual_seed(1), **kw)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    counts_ok = launches == {n: T2I_INT8_LAUNCHES.get(n, 0) for n in KERNELS}
    print(f"c2i int8 ({len(C2I_LABELS)} labels, calibrated in {cal_s:.1f} s): one call "
          f"{call_s:.2f} s with the decode, {len(C2I_LABELS) / call_s:.3f} samples/s; launches "
          f"{launches} (the t2i int8 call's {T2I_INT8_LAUNCHES}, else 0): "
          f"{'ok' if counts_ok else 'FAIL'}")
    for name in T2I_INT8_LAUNCHES:
        _record_launches(name, "c2i_int8", launches[name])
    ok = _u8_ok(out.images, T2I_IMAGE_SHAPE, "c2i images")
    step_ok, step = _t2i_step_check(pipe, "c2i_int8", "flash_attention_static", T2I_VIT_LAYERS,
                                    prompts=C2I_LABELS)
    report["c2i_int8"] = dict(call_s=call_s, samples_s=len(C2I_LABELS) / call_s,
                              calibrate_s=cal_s, launches=launches, one_step=step)
    del pipe, model
    torch.cuda.empty_cache()
    if not (counts_ok and ok and step_ok):
        raise AssertionError("c2i int8 check failed")


# ---------------------------------------------------------------------------
# head dim 96: the NOVA-1.4B 1024px config (3c-3e additions, 4r-4t)
# ---------------------------------------------------------------------------

def _xl_pad_p(ar_steps=RELEASED_AR):
    """Tokens a head eval of the 1024px call (the cosine schedule's largest
    count over 64 x 64 image tokens)."""
    counts = masking.cosine_pred_counts(ar_steps, RELEASED_NI)
    return int(masking.pred_boundaries(counts[counts > 0])[1])


# the 1.4B training step's attentions (bench.py --train-arch t2i-1.4b,
# batch 2): the image encoder's decoder half sees the 1024 video states and
# all 4096 image tokens, its encoder half the video states and the training
# mask's visible bucket (round(0.3 x 4096) = 1229, a key bias), the video
# encoder the 32-token text prefix and the 1024 video tokens
XL_TRAIN_KEYS = {"decoder": XL_KEYS, "encoder": RELEASED_NV + round(0.3 * RELEASED_NI),
                 "video": XL_TRAIN_TEXT + RELEASED_NV}


# the head-dim-96 additions to phases 3c-3e, printed with 4r-4t's
_hd96_timed = _budget_timed("hd96_3ce_s")


@_hd96_timed
def _hd96_forward_checks(gen):
    """(3c) The bf16 flash forward at head dim 96 against its plain version
    at 3c's bf16 tolerance: the 1024px call's image-encoder shape (2, 16,
    5120, 96) and its video encoder's 1280 keys, each with no bias, a key
    bias and a full bias; Lq != Lk off the tiles with a key bias and with a
    fully masked sample (o = 0, lse = 1e30). Then both shapes timed by
    events and from a CUDA graph beside SDPA and the bound (4 B H L^2 d
    FLOPs at the bf16 peak, or q, k, v, o and lse once). Returns the
    failing labels."""
    import torch.nn.functional as Fn

    bad = []
    cases = ([(L, L, kind) for L in (XL_KEYS, 1280) for kind in ("none", "key", "full")]
             + [(1000, 1531, "key"), (1000, 1531, "dead")])
    for lq, lk, kind in cases:
        q, k, v = _flash_operands(gen, XL_ROWS, HEADS, lq, lk, XL_HD)
        bias = _flash_bias(gen, kind, XL_ROWS, lq, lk)
        o, lse = fa.flash_attention_with_lse(q, k, v, bias)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_attention_plain(q, k, v, bias)
        label = f"hd 96 bias={kind} bf16 Lq={lq} Lk={lk}"
        ok = _tol_check("flash_attention", label, o, ref_o, 2.0 ** -6, 2.0 ** -8, like=ref_o)
        e_lse = (lse - ref_lse).abs().max().item()
        ok = ok and bool(torch.isfinite(lse).all()) and e_lse <= 1e-4
        if kind == "dead":
            ok = ok and bool((lse[0] == 1e30).all()) and bool((o[0] == 0).all())
        print(f"    lse max_abs_err {e_lse:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(label)
        del q, k, v, o, lse, ref_o, ref_lse, bias
    bh = XL_ROWS * HEADS
    for L in (XL_KEYS, 1280):
        q, k, v = _flash_operands(gen, XL_ROWS, HEADS, L, L, XL_HD)
        row = _time_kernel("flash_attention", (XL_ROWS, HEADS, L, XL_HD),
                     lambda: fa.flash_attention(q, k, v),
                     lambda: fa.flash_attention_plain(q, k, v),
                     _bound(4 * bh * L * L * XL_HD / PEAK_BF16_FLOPS,
                            4 * bh * L * XL_HD * 2 + bh * L * 4),
                     library=lambda: Fn.scaled_dot_product_attention(q, k, v), iters=10,
                     graph=True)
        if L == XL_KEYS:
            _instance("flash_attention", "bf16 hd 96", row)
        del q, k, v
    torch.cuda.empty_cache()
    return bad


@_hd96_timed
def _hd96_int8_checks(gen):
    """(3d) The NOVA-1.4B int8 call's kernels against their plain versions
    at its shapes (one prompt x CFG 2), at 3d's tolerances:
    flash_attention_static's bf16 core at head dim 96 (the video encoder's
    256 + 1024 keys, the gather phases' 1536 and 3072, the masking phase's
    5120; no bias and a visibility bias with a fully masked sample), rows 5
    and 6 at D = 1536 (fc2 over clusters of 6 blocks, the diffusion block
    at 2 column groups a block: their first drive; static and per-row
    sites, f32 and bf16 x) and int8_linear at K = 1536. The static kernel
    timed at (2, 16, 5120, 96) (events and a graph) beside SDPA and the
    bound. Returns the failing labels."""
    import torch.nn.functional as Fn

    bad, smax = [], torch.tensor(9.0, device=DEV)
    for L in (RELEASED_TEXT + RELEASED_NV, RELEASED_NV + 512, RELEASED_NV + 2048, XL_KEYS):
        for bias_kind in ("none", "visibility"):
            q, k, v, bias = _static_attention_operands(gen, L, bias_kind, XL_ROWS, XL_HD)
            o = fa.flash_attention_static(q, k, v, smax, bias)
            torch.cuda.synchronize()
            ref = fa.flash_attention_static_plain(q, k, v, smax, bias)
            label = f"hd 96 core=bf16 bias={bias_kind} L={L}"
            ok = _tol_check("flash_attention_static", label, o, ref, 2.0 ** -6, 2.0 ** -8,
                            like=ref)
            if bias is not None:
                ok = ok and bool((o[1] == 0).all())
            if not ok:
                bad.append(f"static attention {label}")
            del q, k, v, o, ref
    for L in (RELEASED_TEXT + RELEASED_NV, XL_KEYS):
        for x_dtype in (torch.float32, torch.bfloat16):
            ops = _t2i_mlp_operands(gen, (XL_ROWS, L), x_dtype, d=XL_D, f=XL_F)
            for label, kw in _t2i_variants("mlp"):
                y = fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw)
                torch.cuda.synchronize()
                ref = fb.fused_int8_mlp_postln_plain(*ops, ln_eps=1e-5, **kw)
                if not _tol_check("fused_int8_mlp_postln", f"{label} D={XL_D} L={L} "
                                  f"x={x_dtype}", y, ref, like=ops[0]):
                    bad.append(f"mlp_postln D={XL_D} {label} {L} {x_dtype}")
                del y, ref
            del ops
    for m in (XL_ROWS * _xl_pad_p(), 77):
        ops = _diffusion_operands(gen, m, d=XL_D)
        for label, kw in _t2i_variants("diffusion"):
            y = fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw)
            torch.cuda.synchronize()
            ref = fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5, **kw)
            if not _tol_check("fused_int8_diffusion_block", f"{label} D={XL_D} rows={m}", y,
                              ref, like=ops[0]):
                bad.append(f"diffusion D={XL_D} {label} {m}")
    for n in (3 * XL_D, XL_D):
        x, w, ws, b = _linear_operands(gen, XL_ROWS * XL_KEYS, n, k=XL_D)
        y = fb.int8_linear(x, w, ws, b, torch.bfloat16)
        torch.cuda.synchronize()
        if not _tol_check("int8_linear", f"{XL_ROWS * XL_KEYS}x{XL_D}->{n} x={x.dtype}", y,
                          fb.int8_linear_plain(x, w, ws, b, torch.bfloat16)):
            bad.append(f"int8_linear K={XL_D} {n}")
        del x, w, y
    # rows 5 and 6 at D = 1536, static sites: the masking phase's rows and a head eval's
    ops = _t2i_mlp_operands(gen, (XL_ROWS, XL_KEYS), torch.float32, d=XL_D, f=XL_F)
    kw = dict(_t2i_variants("mlp")[0][1])
    m = XL_ROWS * XL_KEYS
    _time_kernel("fused_int8_mlp_postln", (m, XL_D, XL_F, "static"),
                 lambda: fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw),
                 lambda: fb.fused_int8_mlp_postln_plain(*ops, ln_eps=1e-5, **kw),
                 _bound(4 * m * XL_D * XL_F / PEAK_INT8_OPS,
                        2 * m * XL_D * 4 + 2 * XL_D * XL_F + (XL_F + 3 * XL_D) * 2
                        + (XL_F + XL_D) * 4), iters=10, graph=True)
    ops = _diffusion_operands(gen, XL_ROWS * _xl_pad_p(), d=XL_D)
    kw, m = dict(_t2i_variants("diffusion")[0][1]), XL_ROWS * _xl_pad_p()
    _time_kernel("fused_int8_diffusion_block", (m, XL_D, "static"),
                 lambda: fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw),
                 lambda: fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5, **kw),
                 _bound(2 * m * XL_D * 5 * XL_D / PEAK_INT8_OPS,
                        3 * m * XL_D * 2 + 5 * XL_D * XL_D + (3 * XL_D + 4 * XL_D) * 2
                        + 5 * XL_D * 4), iters=10, graph=True)
    del ops
    q, k, v, _ = _static_attention_operands(gen, XL_KEYS, "none", XL_ROWS, XL_HD)
    bh = XL_ROWS * HEADS
    _instance("flash_attention_static", "bf16 hd 96", _time_kernel(
        "flash_attention_static", (XL_ROWS, HEADS, XL_KEYS, XL_HD),
        lambda: fa.flash_attention_static(q, k, v, smax),
        lambda: fa.flash_attention_static_plain(q, k, v, smax),
        _bound(4 * bh * XL_KEYS ** 2 * XL_HD / PEAK_BF16_FLOPS, 4 * bh * XL_KEYS * XL_HD * 2),
        library=lambda: Fn.scaled_dot_product_attention(q, k, v), iters=10, graph=True))
    del q, k, v
    torch.cuda.empty_cache()
    return bad


# more key tiles than the card holds blocks at once (one block an SM): the
# head-dim-96 backward's ordered dQ sum must never deadlock
MANY_TILES_SHAPE, MANY_TILES_LIMIT_S = (1, 16, 32768, 96), 120.0


def _prepared_graph_ms(prepare, names, n=5, reps=3):
    """Mean ms of the named backward kernels' launches from a CUDA graph of
    ``n`` rounds captured once on a side stream, the launches prepared on
    that stream by ``prepare()`` (a prepared launch holds the stream it was
    prepared on; the head-dim-96 kernels' entry points zero their counters
    in each launch, so replays run as the first launch does). Every kernel
    runs once first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launches = prepare()
        fa.run_bwd(launches)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(n):
            fa.run_bwd(launches, names)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph, launches
    return start.elapsed_time(end) / (reps * n)


def _many_tiles_check(dt, gen):
    """(3e) The head-dim-96 backward at MANY_TILES_SHAPE, more key tiles than
    the card holds blocks (256 bf16 / 512 f32 key tiles x 16 heads): two
    runs finish within MANY_TILES_LIMIT_S (a deadlocked turn would trap
    first), finite, dq, dk and dv bitwise equal. Not held against the plain
    backward, whose (L, L) scores would take 68 GB. True when it passes."""
    b, h, L, d = MANY_TILES_SHAPE
    q, k, v = _flash_operands(gen, b, h, L, L, d, dt)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    t0 = time.perf_counter()
    o = fa.flash_attention(*ins)
    do = torch.randn(o.shape, generator=gen, device=DEV).to(dt)
    g1 = torch.autograd.grad(o, ins, do, retain_graph=True)
    g2 = torch.autograd.grad(o, ins, do)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(g).all()) for g in g1)
    same = all(torch.equal(x, y) for x, y in zip(g1, g2))
    tag = str(dt)[6:]
    print(f"  many key tiles, {tag} {MANY_TILES_SHAPE}: the forward and two backward runs in "
          f"{secs:.2f} s (limit {MANY_TILES_LIMIT_S:.0f} s), finite {finite}, dq, dk and dv "
          f"bitwise equal {same}")
    report.setdefault("bwd_many_tiles", {})[tag] = dict(seconds=secs, finite=finite, equal=same)
    del q, k, v, ins, o, do, g1, g2
    torch.cuda.empty_cache()
    return secs <= MANY_TILES_LIMIT_S and finite and same


def _bwd96_ptxas_gate(kernel, f32):
    """The ptxas report and SASS counts of both instances (no bias / key
    bias, full bias) of a head-dim-96 backward kernel, printed; the failing
    labels: a spill, no TMA load (UTMALDG) or reduce-add (UTMAREDG); bf16
    not on wgmma (HGMMA) or with mma.sync, f32 with any tensor-core
    instruction."""
    sass, out, bad = _sass_ops("flash_attention_bwd"), {}, []
    for fbias in (0, 1):
        mangled = f"{kernel}ILb{fbias}E"
        _, spills, _ = _ptxas_numbers(mangled, "flash_attention_bwd")
        ops = next((c for fn, c in sass.items() if mangled in fn), None)
        out[mangled] = (f"{_ptxas_report(mangled)}; SASS "
                        + ", ".join(f"{op} {n}" for op, n in (ops or {}).items()))
        print(f"  flash_attention_bwd ptxas ({mangled}): {out[mangled]}")
        cores = (not any(ops[op] for op in TENSOR_CORE_OPS) if f32
                 else ops["HGMMA"] and ops["HMMA"] == ops["IMMA"] == 0) if ops else False
        if not (ops and cores and ops["UTMALDG"] and ops["UTMAREDG"] and spills == 0):
            bad.append(f"hd 96 {mangled}: a spill, no TMA load or reduce-add, or the wrong "
                       f"tensor-core instructions")
    return out, bad


@_hd96_timed
def _hd96_backward_checks(gen):
    """(3e) The head-dim-96 bf16 backward (prep, dkvq96, cast) against the
    plain backward on the kernels' own forward output and lse, at 3e's bf16
    tolerance: the 1.4B training step's attentions (XL_TRAIN_KEYS: no bias,
    the encoder half's visibility bias with a fully masked sample, whose
    gradients must be exactly 0), a full bias at 1280 and Lq != Lk off the
    tiles with a key bias; the prep kernel exactly its plain version, the
    cast exactly its plain version on the dkvq96 kernel's own workspace; two
    runs bitwise equal in dq, dk and dv (the dQ sums take a fixed order);
    the many-tile case. Then each kernel timed at (2, 16, 5120, 96) by
    events and from a graph beside the whole plain backward, SDPA's
    backward (from an autograd graph built once) and the bounds, and the
    dkvq96 kernel's ptxas / SASS (wgmma, TMA loads and reduce-adds, no
    spill) as gates. Returns the failing labels."""
    import torch.nn.functional as Fn

    bad, bf16 = [], torch.bfloat16
    for part, L in XL_TRAIN_KEYS.items():
        kind = "visibility" if part == "encoder" else "none"
        q, k, v, bias = _static_attention_operands(gen, L, kind, XL_ROWS, XL_HD)
        label = f"hd 96 {part} bias={kind} {(XL_ROWS, HEADS, L, XL_HD)}"
        if not _bwd_check(label, q, k, v, bias, bf16, gen,
                          dead=1 if kind == "visibility" else None):
            bad.append(label)
        del q, k, v, bias
    for lq, lk, kind in ((1280, 1280, "full"), (1000, 1531, "key")):
        q, k, v = _flash_operands(gen, XL_ROWS, HEADS, lq, lk, XL_HD)
        label = f"hd 96 bias={kind} Lq={lq} Lk={lk}"
        if not _bwd_check(label, q, k, v, _flash_bias(gen, kind, XL_ROWS, lq, lk), bf16, gen):
            bad.append(label)
    L, bh = XL_KEYS, XL_ROWS * HEADS
    q, k, v = _flash_operands(gen, XL_ROWS, HEADS, L, L, XL_HD)
    o, lse = fa.flash_attention_with_lse(q, k, v)
    do = torch.randn(o.shape, generator=gen, device=DEV).to(bf16)
    launches, grads = fa._bwd_operands(q, k, v, None, None, o, lse, do)
    plan = fa.bwd96_plan(XL_ROWS, HEADS, L, L)
    fa.run_bwd(launches, ("flash_attention_bwd_prep",))
    ref_lse, ref_delta = fa.bwd_prep_plain(o, do, lse, plan["lqp"], True)
    tag = f"{(XL_ROWS, HEADS, L, XL_HD)}, exact"
    if not (_tol_check("flash_attention_bwd_prep", f"hd 96 delta {tag}", launches[0][3][4],
                       ref_delta, 0.0, 0.0)
            and _tol_check("flash_attention_bwd_prep", f"hd 96 lse rows {tag}",
                           launches[0][3][3], ref_lse, 0.0, 0.0)):
        bad.append("hd 96 prep")
    fa.run_bwd(launches, ("flash_attention_bwd_dkvq96",))
    ws = launches[1][3][8].clone()
    fa.run_bwd(launches, ("flash_attention_bwd_dq_cast",))
    if not _tol_check("flash_attention_bwd_dq_cast", f"hd 96 dq {tag}", grads[0],
                      fa.bwd_dq_cast_plain(ws, XL_ROWS, HEADS, L, XL_HD ** -0.5), 0.0, 0.0,
                      like=grads[0]):
        bad.append("hd 96 cast")
    del ws, grads
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_port = fa.flash_attention(*ins)
    g1 = torch.autograd.grad(o_port, ins, do, retain_graph=True)
    g2 = torch.autograd.grad(o_port, ins, do, retain_graph=True)
    same = all(torch.equal(a, b) for a, b in zip(g1, g2))
    print(f"  repeatability, two hd 96 bf16 backward runs on the same tensors "
          f"{(XL_ROWS, HEADS, L, XL_HD)}: dq, dk and dv bitwise equal: {same}")
    report.setdefault("bwd_repeatability", {})["bf16 hd 96"] = dict(dq_dk_dv_equal=same)
    if not same:
        bad.append("hd 96 repeatability")
    del g1, g2
    if not _many_tiles_check(bf16, gen):
        bad.append("hd 96 many key tiles")
    # times: each kernel by events and from a graph; the whole backward
    # through autograd and SDPA's, each from an autograd graph built once
    port_bwd = sync_ms(lambda: torch.autograd.grad(o_port, ins, do, retain_graph=True), 10)
    o_lib = Fn.scaled_dot_product_attention(*ins)
    library = sync_ms(lambda: torch.autograd.grad(o_lib, ins, do, retain_graph=True), 10)
    del o_lib, o_port
    plain_ms = sync_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, None, None, o, lse, do), 2)
    io, rows, ws_bytes = bh * L * XL_HD * 2, bh * plan["lqp"] * 4, bh * L * XL_HD * 4
    bounds = {  # (operations in seconds, bytes)
        "flash_attention_bwd_prep": (2 * bh * L * XL_HD / PEAK_F32_FLOPS,
                                     2 * io + bh * L * 4 + 2 * rows),
        # s, dp, dv, dk and dq: 10 BH L^2 d; q, k, v, do, lse, delta read, dk,
        # dv and the f32 dq sums written
        "flash_attention_bwd_dkvq96": (10 * bh * L * L * XL_HD / PEAK_BF16_FLOPS,
                                       6 * io + 2 * rows + ws_bytes),
        # the f32 sums read, dq written
        "flash_attention_bwd_dq_cast": (0.0, ws_bytes + io)}
    total = 0.0

    def prepare():
        return fa._bwd_operands(q, k, v, None, None, o, lse, do)[0]

    # one PyTorch call for each kernel's function where there is one: SDPA's
    # backward for dkvq96's, a strided torch.mul for the cast's (the dkvq96
    # kernel's own f32 sums times the scale, written in bf16 into dq)
    ws = launches[1][3][8]
    dq = torch.empty((XL_ROWS, L, HEADS, XL_HD), dtype=bf16, device=DEV).transpose(1, 2)
    libs = {"flash_attention_bwd_dkvq96": (library, "SDPA backward"),
            "flash_attention_bwd_dq_cast": (sync_ms(
                lambda: torch.mul(ws[:, :L].view(XL_ROWS, HEADS, L, XL_HD), XL_HD ** -0.5,
                                  out=dq), 10), "one strided torch.mul")}
    for name in fa.BWD96_KERNELS:
        ms = sync_ms(lambda: fa.run_bwd(launches, (name,)), 10)
        gms = _prepared_graph_ms(prepare, (name,))
        total += ms
        bound = _bound(*bounds[name])
        lib_ms, lib_what = libs.get(name, (None, None))
        row = dict(ms=ms, graph_ms=gms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                   library_ms=lib_ms)
        lib_txt = "" if lib_ms is None else f", {lib_what} {lib_ms:.3f} ms"
        print(f"  {name} {(XL_ROWS, HEADS, L, XL_HD)}: {ms:.3f} ms/launch (graph {gms:.3f}), "
              f"plain backward {plain_ms:.3f} ms{lib_txt}, bound {bound[0]:.3f} ms "
              f"({bound[1]}), {bound[0] / ms:.1%} of bound (graph {bound[0] / gms:.1%})")
        entry = report["kernels"].setdefault(name, {})
        entry.setdefault("by_shape", {})[str((XL_ROWS, HEADS, L, XL_HD))] = row
        if name == "flash_attention_bwd_dkvq96":
            entry.update(row)
        else:  # prep's and the cast's line entries stay the t2i step's
            _instance(name, "bf16 hd 96", row)
    route_graph = graph_ms(lambda: fa._launch_bwd(q, k, v, None, None, o, lse, do), n=5, reps=3)
    joint = _bound(10 * bh * L * L * XL_HD / PEAK_BF16_FLOPS, 8 * io + bh * L * 4)
    print(f"  the whole hd 96 backward at {(XL_ROWS, HEADS, L, XL_HD)}: prep + dkvq96 + cast "
          f"{total:.3f} ms, the route's launches from a graph {route_graph:.3f} ms, through "
          f"autograd {port_bwd:.3f} ms, SDPA's backward {library:.3f} ms; joint bound "
          f"{joint[0]:.3f} ms (10 BH Lq Lk d FLOPs), {joint[0] / port_bwd:.1%} of it through "
          f"autograd")
    ptxas, gate = _bwd96_ptxas_gate("flash_bwd_dkvq96_kernel", f32=False)
    bad += gate
    report["hd96_backward"] = dict(kernels_ms=total, route_graph_ms=route_graph,
                                   autograd_ms=port_bwd, sdpa_bwd_ms=library,
                                   joint_bound_ms=joint[0], ptxas=ptxas)
    del q, k, v, o, lse, do, launches, ins, ws, dq
    torch.cuda.empty_cache()
    return bad


@phase("4r from_pretrained at the released NOVA-1.4B 1024px config")
def released_1p4b(emb):
    """The released NOVA-1.4B 1024px config (XL_MODEL, from
    nova_pointcloud_tpu/configs/nova_d48w1536_sdxl1024.yaml: head dim 96, 64
    x 64 image and 32 x 32 video patches, text 256 x 2560) through a
    reference checkpoint directory as 4p writes it (_write_released_dir:
    the transformer seeded, bf16 in 2 shards, the SDXL VAE, a 2-layer Phi;
    about 3.5 GB, removed at the end): from_pretrained(dir,
    dtype=bfloat16), its load time and rate (a warm read); the transformer's
    and the VAE's weights bitwise those written; one prompt with 4o's
    embeddings, 64 AR x 25 steps, CFG 5.0, output_type "np" -> (1, 1024,
    1024, 3) uint8, its flash_attention launches exactly
    _flash_route_launches of the model at head dim 96 and 0 of every other
    kernel, its time and peak memory. No build_pipeline twin (4p holds that
    path). Returns the transformer's and the VAE's weights as written
    (bf16, on the host) for 4s, 4w and 4y. The directory stays for 4w,
    which removes it (this phase removes it if it fails)."""
    if emb is None:
        raise AssertionError("no prompt embeddings: phase 4o failed")
    kept = False
    try:
        pipe, written, _, out, rec, ok = _released_call(XL_DIR, XL_MODEL, emb, "released_1p4b")
        hd_ok = pipe.model.head_dim_i == pipe.model.head_dim_v == XL_HD
        print(f"every attention of the call at head dim 96: {'ok' if hd_ok else 'FAIL'}")
        report["released_1p4b"] = rec
        _instance_launches("flash_attention", "bf16 hd 96", "released_1p4b",
                           rec["launches"]["flash_attention"])
        del pipe, out
        kept = ok and hd_ok
    finally:
        if not kept:
            shutil.rmtree(XL_DIR, ignore_errors=True)
        torch.cuda.empty_cache()
    if not kept:
        raise AssertionError("released 1.4B 1024px check failed")
    return written


def _int8_call_launches(pipe, ar_steps):
    """Launches of rows 8, 5, 6 and int8_linear in one calibrated int8 image
    call (T = 1) from the model's sizes: the video encoder's layers once,
    the image encoder's at every non-empty AR step, the head's blocks at
    every diffusion step of those; two projections (qkv, out) a layer.
    bench.py --mode t2i's model gives T2I_INT8_LAUNCHES."""
    model = pipe.model
    s = len(pipe._schedule(ar_steps, T2I_DIFF)[1])
    vit_v, vit_i = model.video_encoder, model.image_encoder
    layers = (len(vit_v.enc_layers) + len(vit_v.dec_layers)
              + s * (len(vit_i.enc_layers) + len(vit_i.dec_layers)))
    blocks = len(list(model.image_decoder.blocks()))
    return {"flash_attention_static": layers, "fused_int8_mlp_postln": layers,
            "fused_int8_diffusion_block": blocks * T2I_DIFF * s, "int8_linear": 2 * layers}


def _xl_int8_call(emb, state, attn_core, label):
    """4r's weights with quantize=True and ``attn_core``, calibrated as 4d
    (16 AR steps, margin 1.05), one prompt with 4o's embeddings at 64 AR x
    25 steps, CFG 5.0, latent output: the launches of rows 8, 5, 6 and
    int8_linear exactly _int8_call_launches of the model (row 5's fc2 over
    clusters of 6, row 6 at 2 column groups a block) and 0 of every other
    kernel, every row-8 launch on the ``attn_core`` score core at head dim
    96; finite latents with a spread; samples/s and peak memory; one encoder
    pass and one head eval against plain (_t2i_step_check, 4d's gate).
    Returns (whether every check passed, the record)."""
    m = XL_MODEL
    model = NOVATransformer(arch=tuple(m["arch"]), image_dim=m["image_dim"],
                            image_base_size=tuple(m["image_base_size"]),
                            video_base_size=tuple(m["video_base_size"]), patch_size=2,
                            text_token_dim=m["text_token_dim"],
                            text_token_len=m["text_token_len"], quantize=True,
                            attn_core=attn_core, dtype=torch.bfloat16, device=DEV)
    model.load_state_dict(state)
    model.to(torch.bfloat16)
    pipe = NOVAPipeline(model, FlowMatchEulerScheduler())
    pe = emb.numpy()
    t0 = time.perf_counter()
    fb.reset_launch_counts()
    pipe.calibrate(prompt_embeds=pe, num_inference_steps=T2I_CAL_AR, num_diffusion_steps=T2I_DIFF,
                   guidance_scale=T2I_GUIDANCE,
                   generator=torch.Generator(device=DEV).manual_seed(2), margin=1.05)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    cal_launches = {k: v for k, v in fb.LAUNCHES.items() if v}
    kw = dict(prompt_embeds=pe, num_diffusion_steps=T2I_DIFF, guidance_scale=T2I_GUIDANCE,
              output_type="latent")
    pipe(**kw, num_inference_steps=4, generator=torch.Generator(device=DEV))  # warm-up
    expected = _int8_call_launches(pipe, RELEASED_AR)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fb.reset_launch_counts()
    with _static_cores() as cores:
        t0 = time.perf_counter()
        out = pipe(**kw, num_inference_steps=RELEASED_AR,
                   generator=torch.Generator(device=DEV).manual_seed(53))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - held
    counts_ok = launches == {n: expected.get(n, 0) for n in KERNELS}
    core_ok = cores == {(attn_core, XL_HD): expected["flash_attention_static"]}
    lat = out.latents.float()
    shape = (1, 2 * m["image_base_size"][0], 2 * m["image_base_size"][1], 4)
    out_ok = (tuple(lat.shape) == shape and bool(torch.isfinite(lat).all())
              and lat.std().item() > 0.05)
    print(f"NOVA-1.4B int8, {attn_core} score core (calibrated in {cal_s:.1f} s, launches "
          f"{cal_launches}): one call {call_s:.2f} s, {1 / call_s:.4f} samples/s, peak "
          f"{peak / 2 ** 30:.2f} GiB above {held / 2 ** 30:.2f}; launches {launches} (expected "
          f"{expected}, else 0): {'ok' if counts_ok else 'FAIL'}; row 8's launches by (score "
          f"core, head dim) {cores}: {'ok' if core_ok else 'FAIL'}; latents {tuple(lat.shape)} "
          f"finite, std {lat.std().item():.4f}: {'ok' if out_ok else 'FAIL'}")
    for name in expected:
        _record_launches(name, label, launches[name])
    _instance_launches("flash_attention_static", f"{attn_core} hd 96", label,
                       launches["flash_attention_static"])
    step_ok, step = _t2i_step_check(
        pipe, label, "flash_attention_static",
        len(model.image_encoder.enc_layers) + len(model.image_encoder.dec_layers), prompts=None,
        prompt_embeds=pe, batch=1, pad_p=_xl_pad_p())
    rec = dict(call_s=call_s, samples_s=1 / call_s, calibrate_s=cal_s,
               calibration_launches=cal_launches, launches=launches, expected=expected,
               static_cores=str(cores), peak_bytes=peak, held_bytes=held,
               output_std=lat.std().item(), one_step=step)
    del pipe, model, out, lat
    torch.cuda.empty_cache()
    return counts_ok and core_ok and out_ok and step_ok, rec


@phase("4s NOVA-1.4B int8 serving")
def xl_int8(emb, written):
    """4r's weights with quantize=True and attn_core="bf16" (head dim 96 on
    the static attention's bf16 core): _xl_int8_call."""
    if emb is None or written is None:
        raise AssertionError("no 1.4B weights or prompt embeddings: phase 4o or 4r failed")
    ok, report["xl_int8"] = _xl_int8_call(emb, written["transformer"], "bf16", "xl_int8")
    if not ok:
        raise AssertionError("NOVA-1.4B int8 check failed")


def _xl_train_batch(seed):
    """bench.py --train-arch t2i-1.4b's batch 2 in the records layout: fp16
    VAE moments of 128 x 128 x 4 latents, f32 caption embeddings 32 x 256."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    lat = (XL_TRAIN_BATCH, 2 * XL_MODEL["image_base_size"][0], 2 * XL_MODEL["image_base_size"][1],
           4)
    return {"moments": torch.cat([torch.randn(lat, generator=gen, device=DEV) * 0.8,
                                  torch.full(lat, -6.0, device=DEV)], -1).half(),
            "text_embeds": torch.randn((XL_TRAIN_BATCH, XL_TRAIN_TEXT, 256), generator=gen,
                                       device=DEV)}


def _xl_train_draws(model, seed):
    """Every random draw of one 1.4B step, fixed (as _train_draws)."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    ni, rows = model.num_image_tokens, model.loss_repeat * XL_TRAIN_BATCH
    lat = (XL_TRAIN_BATCH,) + tuple(model.latent_hw) + (4,)
    mask, _ = masking.sample_train_mask(gen, XL_TRAIN_BATCH, ni, device=DEV)
    return {"latent_eps": torch.randn(lat, generator=gen, device=DEV),
            "drop": torch.rand((XL_TRAIN_BATCH,), generator=gen, device=DEV) < 0.1, "mask": mask,
            "timesteps": model.noise_scheduler.sample_timesteps(gen, (rows, ni), device=DEV),
            "noise": torch.randn((rows, ni, model.patch_dim), generator=gen, device=DEV)}


def _train_flash_layers(model, text_len):
    """Attention layers of one training forward on the flash kernel by the
    dispatcher's rule (ops/attention.flash_route): the video encoder over
    the text prefix + the video tokens, the image encoder's encoder half
    over the video states + the training mask's visible bucket (a key
    bias), its decoder half over the video states + every image token.
    bench.py --train-arch t2i's model gives TRAIN_FLASH_LAYERS (16)."""
    from nova_pointcloud_tpu_torch.ops.attention import flash_route

    ni, nv = model.num_image_tokens, model.num_video_tokens
    vit_v, vit_i = model.video_encoder, model.image_encoder
    lv, full = text_len + nv, nv + ni
    lk = nv + int(round((1.0 - masking.TRAIN_MASK_RATIO_MIN) * ni))
    return ((len(vit_v.enc_layers) + len(vit_v.dec_layers))
            * flash_route(lv, lv, model.head_dim_v, None, "auto", True)
            + len(vit_i.enc_layers) * flash_route(lk, lk, model.head_dim_i, (2, 1, 1, lk),
                                                  "auto", True)
            + len(vit_i.dec_layers) * flash_route(full, full, model.head_dim_i, None, "auto",
                                                  True))


@phase("4t NOVA-1.4B training step (t2i-1.4b)")
def xl_train():
    """bench.py --mode train --train-arch t2i-1.4b's step: NOVATransformer(
    vit_d16w1536, vit_d32w1536, mlp_d6w1536), 64 x 64 image and 32 x 32
    video patches, text 32 x 256, seeded init_weights, f32 master weights,
    bf16 compute, remat, AdamW (lr 1e-4, wd 0.02, betas 0.9 / 0.95), batch
    2. A warm-up step, then one step's launches exactly as derived (every
    attention layer with >= 1024 keys, _train_flash_layers: its forward
    twice (remat), prep, dkvq96 and the cast once each, at head dim 96; 0 of every
    other kernel); each of the step's backward calls against the plain
    backward on its own tensors at the flash bf16 tolerance (the gate, as
    4f); the step's gradients against the plain attention core's as a
    reading (bf16 on random weights, no floor to gate on; 4x holds the f32
    twin to 4f's gate); XL_TRAIN_STEPS timed steps: p50,
    samples/s and peak memory."""
    model = NOVATransformer(arch=tuple(XL_MODEL["arch"]), image_dim=4,
                            image_base_size=tuple(XL_MODEL["image_base_size"]),
                            video_base_size=tuple(XL_MODEL["video_base_size"]), patch_size=2,
                            text_token_dim=256, text_token_len=XL_TRAIN_TEXT,
                            noise_scheduler=FlowMatchEulerScheduler(), remat=True,
                            dtype=torch.bfloat16, device=DEV)
    model.init_weights(torch.Generator(device=DEV).manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    pipe = _train_pipe(model)
    n = _train_flash_layers(model, XL_TRAIN_TEXT)
    expected = {"flash_attention": 2 * n, "flash_attention_bwd_prep": n,
                "flash_attention_bwd_dkvq96": n, "flash_attention_bwd_dq_cast": n}
    print(f"NOVA-1.4B training: {n_params / 1e6:.1f}M parameters (f32 master, bf16 compute, "
          f"remat), batch {XL_TRAIN_BATCH}, head dim {model.head_dim_i}, {n} attention layers "
          f"on the flash kernels (keys {XL_TRAIN_KEYS})")
    pipe.train(iter([_xl_train_batch(1)]), 1)  # warm-up: kernel loads, allocator, Adam state
    fb.reset_launch_counts()
    out = pipe.train(iter([_xl_train_batch(2)]), pipe.trainer.step + 1)
    torch.cuda.synchronize()
    launches = dict(fb.LAUNCHES)
    counts_ok = launches == {name: expected.get(name, 0) for name in KERNELS}
    print(f"launches in one training step: {launches} (expected {expected}, else 0): "
          f"{'ok' if counts_ok else 'FAIL'}")
    for name in expected:
        _record_launches(name, "xl_train", launches[name])
    _instance_launches("flash_attention", "bf16 hd 96", "xl_train", launches["flash_attention"])
    for name in ("flash_attention_bwd_prep", "flash_attention_bwd_dq_cast"):
        _instance_launches(name, "bf16 hd 96", "xl_train", launches[name])
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    draws, batch = _xl_train_draws(model, 3), _xl_train_batch(1)
    loss_k, g_k, in_path, worst = _checked_step_grads(pipe, batch, draws, n)
    g_k = {name: g.cpu() for name, g in g_k.items()}
    with fb.use_plain_kernels():
        loss_p, g_p = _step_grads(pipe, batch, draws)
    reading = _rel_l2(g_k, {name: g.cpu() for name, g in g_p.items()})
    del g_k, g_p
    torch.cuda.empty_cache()
    grads_ok = np.isfinite(loss_k) and in_path
    print(f"  reading, no gate: the step's gradients, kernels vs the plain attention core "
          f"(bf16) {reading:.3e} relative L2; losses {loss_k:.6f} / plain {loss_p:.6f}")
    data = itertools.repeat(_xl_train_batch(4))
    pipe.train(data, pipe.trainer.step + 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(XL_TRAIN_STEPS):
        t0 = time.perf_counter()
        pipe.train(data, pipe.trainer.step + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.percentile(times, 50))
    print(f"NOVA-1.4B training: batch {XL_TRAIN_BATCH}, p50 {p50:.3f} s per step, "
          f"{XL_TRAIN_BATCH / p50:.3f} samples/s (times {[round(t, 3) for t in times]}); peak "
          f"memory {peak / 2 ** 30:.2f} GiB; step loss {out['loss']:.4f}, parameters finite "
          f"{finite}")
    report["xl_train"] = dict(params_m=n_params / 1e6, launches=launches, expected=expected,
                              in_path_worst_err_over_tol=worst, grad_reading_vs_plain=reading,
                              p50_s=p50, samples_per_s=XL_TRAIN_BATCH / p50, times_s=times,
                              peak_bytes=peak, step_loss=out["loss"])
    del pipe, model
    torch.cuda.empty_cache()
    if not (counts_ok and finite and grads_ok):
        raise AssertionError("NOVA-1.4B training check failed")


# ---------------------------------------------------------------------------
# head dim 96 in f32 and on the static attention's int8 score core (3c-3e
# additions, 4w-4y): the f32 forward (flash_fwd_f32_kernel<96>), the f32
# backward's f32_96 kernel, the int8 core at 96
# ---------------------------------------------------------------------------
# 4w: AR steps of the f32 1024px call (the full 64-step call would take
# minutes of f32 GEMMs)
W_AR = 8
F32_HD96_SHAPE = (XL_ROWS, HEADS, XL_KEYS, XL_HD)  # (2, 16, 5120, 96): every new instance timed here


@contextlib.contextmanager
def _launches_by(route, key):
    """Counts the calls of the wrapper's launch ``fa.<route>`` by ``key(its
    arguments)`` while the block runs: {key: n}."""
    seen, launch = {}, getattr(fa, route)

    def counted(*args):
        out = launch(*args)
        k = key(*args)
        seen[k] = seen.get(k, 0) + 1
        return out

    setattr(fa, route, counted)
    try:
        yield seen
    finally:
        setattr(fa, route, launch)


def _flash_instances():
    """flash_attention's forward launches by (dtype, head dim)."""
    return _launches_by("_launch", lambda q, *_: (str(q.dtype)[6:], q.shape[-1]))


def _static_cores():
    """flash_attention_static's launches by (score core, head dim)."""
    return _launches_by("_launch_static", lambda q, k, v, smax, kb, a_q, a_k: (
        "int8" if a_q is not None else "bf16", q.shape[-1]))


@_budget_timed("hd96_new_3ce_s")
def _f32_hd96_forward_checks(gen):
    """(3c) The f32 forward at head dim 96 (flash_fwd_f32_kernel<96>)
    against its plain version at 3c's f32 tolerance (1e-4 max / 1e-5 mean
    relative, lse 1e-4): the 1024px call's (2, 16, 5120, 96) with no bias
    and a key bias, the training step's shapes (1024 + 1229 keys with a
    fully masked sample; 32 + 1024 at batch 1), a full bias at 1280, Lq !=
    Lk off the tiles with a key bias, and a shape under one tile. Then timed
    at (2, 16, 5120, 96) by events and from a CUDA graph beside its plain
    version, SDPA's f32 forward and the bound (4 B H L^2 d FLOPs at 67
    TFLOP/s). Returns the failing labels."""
    import torch.nn.functional as Fn

    bad, f32 = [], torch.float32
    cases = [(2, XL_KEYS, XL_KEYS, "none"), (2, XL_KEYS, XL_KEYS, "key"),
             (2, 2253, 2253, "dead"), (1, 1056, 1056, "none"), (2, 1280, 1280, "full"),
             (2, 1000, 1531, "key"), (2, 37, 45, "none")]
    for b, lq, lk, kind in cases:
        q, k, v = _flash_operands(gen, b, HEADS, lq, lk, XL_HD, f32)
        bias = _flash_bias(gen, kind, b, lq, lk)
        o, lse = fa.flash_attention_with_lse(q, k, v, bias)
        torch.cuda.synchronize()
        ref_o, ref_lse = fa.flash_attention_plain(q, k, v, bias)
        label = f"f32 hd 96 bias={kind} {(b, HEADS, lq, lk)}"
        ok = _tol_check("flash_attention", label, o, ref_o, 1e-4, 1e-5, like=ref_o)
        e_lse = (lse - ref_lse).abs().max().item()
        ok = ok and bool(torch.isfinite(lse).all()) and e_lse <= 1e-4
        if kind == "dead":
            ok = ok and bool((lse[0] == 1e30).all()) and bool((o[0] == 0).all())
        print(f"    lse max_abs_err {e_lse:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            bad.append(label)
        del q, k, v, o, lse, ref_o, ref_lse, bias
    b, h, L, d = F32_HD96_SHAPE
    q, k, v = _flash_operands(gen, b, h, L, L, d, f32)
    bh = b * h
    row = _time_kernel("flash_attention", F32_HD96_SHAPE + ("f32",),
                       lambda: fa.flash_attention(q, k, v),
                       lambda: fa.flash_attention_plain(q, k, v),
                       _bound(4 * bh * L * L * d / PEAK_F32_FLOPS, 4 * bh * L * d * 4 + bh * L * 4),
                       library=lambda: Fn.scaled_dot_product_attention(q, k, v), iters=5,
                       graph=True)
    _instance("flash_attention", "f32 hd 96", row)
    del q, k, v
    torch.cuda.empty_cache()
    return bad


@_budget_timed("hd96_new_3ce_s")
def _int8_core_hd96_checks(gen):
    """(3d) flash_attention_static's int8 score core at head dim 96 (the
    quant pass into 96-byte code rows, three 32-byte panels in the 32B
    swizzle, three s8 k-steps) against its plain version at 3d's int8
    tolerance (2^-6 max / 2^-10 mean relative): the NOVA-1.4B int8 call's
    shapes (one prompt x CFG 2; 1280, 1536, 3072 and 5120 keys), no bias
    and a visibility bias with a fully masked sample (o = 0), bf16 q / k as
    the ViT hands them over and once f32; a and k's amax as calibrated
    (their max |x| x 1.05). Then timed at (2, 16, 5120, 96) by events and
    from a graph beside its plain version and the bound (2 B H L^2 d int8
    operations at 1979 TOP/s plus as many bf16 FLOPs for p v at 989
    TFLOP/s); no library call computes the function (library_ms null).
    Returns the failing labels."""
    bad, smax = [], torch.tensor(9.0, device=DEV)
    cases = [(L, kind, torch.bfloat16) for L in (RELEASED_TEXT + RELEASED_NV, RELEASED_NV + 512,
                                               RELEASED_NV + 2048, XL_KEYS)
             for kind in ("none", "visibility")] + [(1280, "visibility", torch.float32)]
    for L, kind, dt in cases:
        q, k, v, bias = _static_attention_operands(gen, L, kind, XL_ROWS, XL_HD)
        q, k = q.to(dt), k.to(dt)
        a_q, a_k = q.float().abs().amax() * 1.05, k.float().abs().amax() * 1.05
        o = fa.flash_attention_static(q, k, v, smax, bias, a_q=a_q, a_k=a_k)
        torch.cuda.synchronize()
        ref = fa.flash_attention_static_plain(q, k, v, smax, bias, a_q=a_q, a_k=a_k)
        label = f"hd 96 core=int8 bias={kind} L={L} q, k {str(dt)[6:]}"
        ok = _tol_check("flash_attention_static", label, o, ref, like=ref)
        if bias is not None:
            ok = ok and bool((o[1] == 0).all())
        if not ok:
            bad.append(f"static attention {label}")
        del q, k, v, o, ref
    q, k, v, _ = _static_attention_operands(gen, XL_KEYS, "none", XL_ROWS, XL_HD)
    a_q, a_k = q.float().abs().amax() * 1.05, k.float().abs().amax() * 1.05
    b, h, L, d = F32_HD96_SHAPE
    ops = 2 * b * h * L * L * d
    row = _time_kernel("flash_attention_static", F32_HD96_SHAPE + ("int8",),
                       lambda: fa.flash_attention_static(q, k, v, smax, a_q=a_q, a_k=a_k),
                       lambda: fa.flash_attention_static_plain(q, k, v, smax, a_q=a_q, a_k=a_k),
                       _bound(ops / PEAK_INT8_OPS + ops / PEAK_BF16_FLOPS, 4 * b * h * L * d * 2),
                       iters=10, graph=True)
    print("    library: none (no PyTorch call computes an int8 score product under a "
          "calibrated softmax offset)")
    _instance("flash_attention_static", "int8 hd 96", row)
    del q, k, v
    torch.cuda.empty_cache()
    return bad


@_budget_timed("hd96_new_3ce_s")
def _f32_hd96_backward_checks(gen):
    """(3e) The f32 backward at head dim 96 (prep, f32_96) against the plain
    backward on the kernels' own forward output and lse at 3e's f32
    tolerance (1e-4 / 1e-5 relative): (2, 16, 5120, 96) with no bias, the
    step's encoder half (1024 + 1229 keys) with a key bias and a fully
    masked sample (its gradients exactly 0), its video encoder at batch 1
    (32 + 1024), a full bias at 1280 and Lq != Lk off the tiles with a key
    bias; the prep kernel exactly its plain version; dq, dk and dv of two
    runs bitwise equal (a gate: dk and dv are written once, the dQ sums take
    a fixed order); the many-tile case. Then each kernel timed at (2, 16,
    5120, 96) by events and from a graph beside the whole plain backward,
    SDPA's f32 backward (an autograd graph built once) and the bounds (10 B
    H L^2 d FLOPs at 67 TFLOP/s), the route's launches from a CUDA graph,
    and the f32_96 kernel's ptxas / SASS as gates: no spill, TMA loads and
    reduce-adds, no tensor-core instruction. Returns the failing labels."""
    import torch.nn.functional as Fn

    bad, f32 = [], torch.float32
    cases = [(2, XL_KEYS, XL_KEYS, "none"), (2, 2253, 2253, "dead"), (1, 1056, 1056, "none"),
             (2, 1280, 1280, "full"), (2, 1000, 1531, "key")]
    for b, lq, lk, kind in cases:
        q, k, v = _flash_operands(gen, b, HEADS, lq, lk, XL_HD, f32)
        label = f"f32 hd 96 bias={kind} {(b, HEADS, lq, lk)}"
        if not _bwd_check(label, q, k, v, _flash_bias(gen, kind, b, lq, lk), f32, gen,
                          dead=0 if kind == "dead" else None):
            bad.append(label)
        del q, k, v
    b, h, L, d = F32_HD96_SHAPE
    bh = b * h
    q, k, v = _flash_operands(gen, b, h, L, L, d, f32)
    o, lse = fa.flash_attention_with_lse(q, k, v)
    do = torch.randn(o.shape, generator=gen, device=DEV)
    launches, _ = fa._bwd_operands(q, k, v, None, None, o, lse, do)
    plan = fa.bwd96_f32_plan(b, h, L, L)
    fa.run_bwd(launches, ("flash_attention_bwd_prep",))
    ref_lse, ref_delta = fa.bwd_prep_plain(o, do, lse, plan["lqp"], False)
    tag = f"{F32_HD96_SHAPE}, exact"
    if not (_tol_check("flash_attention_bwd_prep", f"f32 hd 96 delta {tag}", launches[0][3][4],
                       ref_delta, 0.0, 0.0)
            and _tol_check("flash_attention_bwd_prep", f"f32 hd 96 lse rows {tag}",
                           launches[0][3][3], ref_lse, 0.0, 0.0)):
        bad.append("f32 hd 96 prep")
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_port = fa.flash_attention(*ins)
    g1 = torch.autograd.grad(o_port, ins, do, retain_graph=True)
    g2 = torch.autograd.grad(o_port, ins, do, retain_graph=True)
    same = all(torch.equal(x, y) for x, y in zip(g1, g2))
    print(f"  repeatability, two f32 hd 96 backward runs on the same tensors {F32_HD96_SHAPE}: "
          f"dq, dk and dv bitwise equal: {same}")
    report.setdefault("bwd_repeatability", {})["f32 hd 96"] = dict(dq_dk_dv_equal=same)
    if not same:
        bad.append("f32 hd 96 repeatability")
    del g1, g2
    if not _many_tiles_check(f32, gen):
        bad.append("f32 hd 96 many key tiles")
    port_bwd = sync_ms(lambda: torch.autograd.grad(o_port, ins, do, retain_graph=True), 3)
    o_lib = Fn.scaled_dot_product_attention(*ins)
    library = sync_ms(lambda: torch.autograd.grad(o_lib, ins, do, retain_graph=True), 3)
    del o_lib, o_port
    plain_ms = sync_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, None, None, o, lse, do), 2)
    io, rows = bh * L * d * 4, bh * plan["lqp"] * 4
    bounds = {  # (operations in seconds, bytes)
        "flash_attention_bwd_prep": (2 * bh * L * d / PEAK_F32_FLOPS, 2 * io + bh * L * 4 + 2 * rows),
        # s, dp, dv, dk and dq: 10 BH L^2 d; q, k, v, do, lse, delta read, dq, dk, dv written
        "flash_attention_bwd_f32_96": (10 * bh * L * L * d / PEAK_F32_FLOPS, 7 * io + 2 * rows)}
    total = 0.0

    def prepare():
        return fa._bwd_operands(q, k, v, None, None, o, lse, do)[0]

    for name in fa.BWD96_F32_KERNELS:
        ms = sync_ms(lambda: fa.run_bwd(launches, (name,)), 3)
        gms = _prepared_graph_ms(prepare, (name,), n=2, reps=2)
        total += ms
        bound = _bound(*bounds[name])
        row = dict(ms=ms, graph_ms=gms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                   library_ms=library if name != "flash_attention_bwd_prep" else None)
        lib_txt = "" if row["library_ms"] is None else f", SDPA f32 backward {library:.3f} ms"
        print(f"  {name} {F32_HD96_SHAPE} f32: {ms:.3f} ms/launch (graph {gms:.3f}), plain "
              f"backward {plain_ms:.3f} ms{lib_txt}, bound {bound[0]:.3f} ms ({bound[1]}), "
              f"{bound[0] / ms:.1%} of bound (graph {bound[0] / gms:.1%})")
        entry = report["kernels"].setdefault(name, {})
        entry.setdefault("by_shape", {})[str(F32_HD96_SHAPE + ("f32",))] = row
        if name == "flash_attention_bwd_prep":  # prep's line entry stays the t2i step's
            _instance(name, "f32 hd 96", row)
        else:
            entry.update(row)
    route_graph = graph_ms(lambda: fa._launch_bwd(q, k, v, None, None, o, lse, do), n=3, reps=2)
    joint = _bound(10 * bh * L * L * d / PEAK_F32_FLOPS, 8 * io + bh * L * 4)
    print(f"  the whole f32 hd 96 backward at {F32_HD96_SHAPE}: prep + f32_96 {total:.3f} ms, the "
          f"route's launches from a graph {route_graph:.3f} ms, through autograd "
          f"{port_bwd:.3f} ms, SDPA's f32 backward {library:.3f} ms; joint bound "
          f"{joint[0]:.3f} ms (10 BH Lq Lk d FLOPs at 67 TFLOP/s), {joint[0] / port_bwd:.1%} of "
          f"it through autograd")
    ptxas, gate = _bwd96_ptxas_gate("flash_bwd_f32_96_kernel", f32=True)
    bad += gate
    report["f32_hd96_backward"] = dict(kernels_ms=total, route_graph_ms=route_graph,
                                       autograd_ms=port_bwd, sdpa_f32_bwd_ms=library,
                                       joint_bound_ms=joint[0], ptxas=ptxas)
    del q, k, v, o, lse, do, launches, ins
    torch.cuda.empty_cache()
    return bad


@phase("4w from_pretrained at the released NOVA-1.4B 1024px config, float32")
def released_1p4b_f32(emb, written):
    """4r's reference directory (removed at the end) through
    from_pretrained(dir) at its default dtype, float32: the transformer's
    and the VAE's weights exactly the written bf16 values upcast; one prompt
    with 4o's embeddings, CFG 5.0, W_AR AR x 25 steps, latent output (the
    cut: the full 64-step call takes minutes of f32 GEMMs, and the f32 SDXL
    decode adds no kernel): flash_attention launches exactly
    _flash_route_launches of the model for W_AR steps, every one f32 at
    head dim 96, 0 of every other kernel; finite latents; the wall time and
    the peak memory above what is held; one image-encoder pass and one head
    eval against the same with use_plain_kernels() at the f32 tolerance (2 x
    floor + 1e-5; the whole float call is chaotic on random weights)."""
    try:
        if emb is None or written is None or not os.path.isdir(XL_DIR):
            raise AssertionError("no 1.4B directory or prompt embeddings: phase 4o or 4r failed")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe = from_pretrained(XL_DIR)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(XL_DIR, ignore_errors=True)
    model = pipe.model
    upcast = {name: {k: v.float() if v.is_floating_point() else v
                     for k, v in written[name].items()} for name in ("transformer", "vae")}
    same = {name: _same_weights(mod, upcast[name])
            for name, mod in (("transformer", model), ("vae", pipe.vae))}
    dtypes = {p.dtype for p in model.parameters()}
    loaded = all(same.values()) and dtypes == {torch.float32} and model.head_dim_i == XL_HD
    print(f"from_pretrained(dir) at its default dtype: {load_s:.2f} s, transformer dtypes "
          f"{dtypes}, head dim {model.head_dim_i}; the weights exactly the written bf16 values "
          f"upcast: {same}: {'ok' if loaded else 'FAIL'}")
    del upcast
    expected = _flash_route_launches(pipe, W_AR, text_len=RELEASED_TEXT)
    kw = dict(prompt_embeds=emb.numpy(), num_inference_steps=W_AR,
              num_diffusion_steps=RELEASED_DIFF, guidance_scale=RELEASED_GUIDANCE,
              output_type="latent")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fb.reset_launch_counts()
    with _flash_instances() as seen:
        t0 = time.perf_counter()
        out = pipe(**kw, generator=torch.Generator(device=DEV).manual_seed(54))
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() - held
    counts_ok = (launches == {n: expected if n == "flash_attention" else 0 for n in KERNELS}
                 and seen == {("float32", XL_HD): expected})
    lat = out.latents
    shape = (1, 2 * XL_MODEL["image_base_size"][0], 2 * XL_MODEL["image_base_size"][1], 4)
    out_ok = tuple(lat.shape) == shape and lat.dtype == torch.float32 and bool(
        torch.isfinite(lat).all())
    print(f"one f32 call, {W_AR} AR x {RELEASED_DIFF} steps: {call_s:.2f} s, peak "
          f"{peak / 2 ** 30:.2f} GiB above {held / 2 ** 30:.2f}; flash_attention launches "
          f"{launches['flash_attention']} (expected {expected}) by (dtype, head dim) {seen}, "
          f"others {({k: v for k, v in launches.items() if v and k != 'flash_attention'} or 0)}: "
          f"{'ok' if counts_ok else 'FAIL'}; latents {tuple(lat.shape)} f32 finite: "
          f"{'ok' if out_ok else 'FAIL'}")
    _instance_launches("flash_attention", "f32 hd 96", "released_1p4b_f32",
                       launches["flash_attention"])
    step_ok, step = _t2i_step_check(
        pipe, "released_1p4b_f32", "flash_attention",
        len(model.image_encoder.enc_layers) + len(model.image_encoder.dec_layers), prompts=None,
        prompt_embeds=emb.numpy(), batch=1, pad_p=_xl_pad_p(W_AR), tol=1e-5)
    report["released_1p4b_f32"] = dict(load_s=load_s, weights_upcast=same, call_s=call_s,
                                       ar_steps=W_AR, peak_bytes=peak, held_bytes=held,
                                       launches=launches, expected_flash=expected,
                                       by_dtype_head_dim=str(seen), one_step=step)
    del pipe, model, out, lat
    torch.cuda.empty_cache()
    if not (loaded and counts_ok and out_ok and step_ok):
        raise AssertionError("released 1.4B 1024px f32 check failed")


@phase("4x NOVA-1.4B training step in f32 (t2i-1.4b's f32 twin)")
def xl_train_f32():
    """4t's model (bench.py --train-arch t2i-1.4b: head dim 96, remat, f32
    master weights) in f32 compute, the loss and gradients of one step on
    fixed draws (no optimizer step, so no Adam state), 4t's batch 2: the
    launches exactly 4t's derived counts in f32 (96
    forward at head dim 96, 48 each of prep and f32_96; 0 of every other
    kernel); the gradient within 2 x floor + 1e-6 relative L2 of the
    f32 plain step (floor: the f32 plain step against itself with the
    latents moved by 1e-6, as 4f); the step's time and peak memory above
    what is held."""
    model = NOVATransformer(arch=tuple(XL_MODEL["arch"]), image_dim=4,
                            image_base_size=tuple(XL_MODEL["image_base_size"]),
                            video_base_size=tuple(XL_MODEL["video_base_size"]), patch_size=2,
                            text_token_dim=256, text_token_len=XL_TRAIN_TEXT,
                            noise_scheduler=FlowMatchEulerScheduler(), remat=True, device=DEV)
    model.init_weights(torch.Generator(device=DEV).manual_seed(0))
    pipe = _train_pipe(model)
    n = _train_flash_layers(model, XL_TRAIN_TEXT)
    expected = {"flash_attention": 2 * n, "flash_attention_bwd_prep": n,
                "flash_attention_bwd_f32_96": n}
    batch, draws = _xl_train_batch(1), _xl_train_draws(model, 3)
    _step_grads(pipe, batch, draws)  # warm-up: kernel loads, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fb.reset_launch_counts()
    with _flash_instances() as seen:
        t0 = time.perf_counter()
        loss_k, g_k = _step_grads(pipe, batch, draws)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - held
    launches = dict(fb.LAUNCHES)
    counts_ok = (launches == {name: expected.get(name, 0) for name in KERNELS}
                 and seen == {("float32", XL_HD): 2 * n})
    print(f"NOVA-1.4B f32 step (loss and gradients, batch {XL_TRAIN_BATCH}): {step_s:.3f} s, peak "
          f"{peak / 2 ** 30:.2f} GiB above {held / 2 ** 30:.2f}; launches {launches} (expected "
          f"{expected}, else 0), forward by (dtype, head dim) {seen}: "
          f"{'ok' if counts_ok else 'FAIL'}")
    for name in expected:
        _record_launches(name, "xl_train_f32", launches[name])
    _instance_launches("flash_attention", "f32 hd 96", "xl_train_f32", launches["flash_attention"])
    _instance_launches("flash_attention_bwd_prep", "f32 hd 96", "xl_train_f32",
                       launches["flash_attention_bwd_prep"])
    g_k = {name: g.cpu() for name, g in g_k.items()}
    moved = dict(draws, latent_eps=draws["latent_eps"] + 1e-6 * torch.randn(
        draws["latent_eps"].shape, generator=torch.Generator(device=DEV).manual_seed(4),
        device=DEV))
    with fb.use_plain_kernels():
        loss_p, g_p = _step_grads(pipe, batch, draws)
        g_p = {name: g.cpu() for name, g in g_p.items()}
        _, g_m = _step_grads(pipe, batch, moved)
        g_m = {name: g.cpu() for name, g in g_m.items()}
    vs_plain, floor = _rel_l2(g_k, g_p, "f32 kernels vs plain"), _rel_l2(g_m, g_p)
    finite = np.isfinite(loss_k) and all(bool(torch.isfinite(g).all()) for g in g_k.values())
    tol = 2 * floor + 1e-6
    grad_ok = finite and vs_plain <= tol
    print(f"the step's gradient (relative L2 of the whole vector): f32 kernels vs plain "
          f"{vs_plain:.3e} (tol 2 x floor + 1e-6 = {tol:.3e}; floor, f32 plain vs itself with "
          f"the latents moved by 1e-6: {floor:.3e}); finite: {finite}; losses {loss_k:.6f} / "
          f"plain {loss_p:.6f}: {'ok' if grad_ok else 'FAIL'}")
    report["xl_train_f32"] = dict(batch=XL_TRAIN_BATCH, step_s=step_s, peak_bytes=peak,
                                  held_bytes=held,
                                  launches=launches, expected=expected,
                                  grad_rel_l2_vs_plain=vs_plain, grad_floor=floor, loss=loss_k,
                                  loss_plain=loss_p)
    del pipe, model, g_k, g_p, g_m
    torch.cuda.empty_cache()
    if not (counts_ok and grad_ok):
        raise AssertionError("NOVA-1.4B f32 training check failed")


@phase("4y the static attention's int8 score core: NOVA-1.4B and bench.py --mode t2i")
def int8_core_serving(emb, written):
    """(a) 4s's weights with attn_core="int8" (_xl_int8_call): calibrated as
    4s (the calibration records the amax of q and k), one call at 64 AR x
    25 steps, rows 8 / 5 / 6 / int8_linear exactly 4s's counts with every
    row-8 launch on the int8 score core at head dim 96, 4d's one-step check
    against plain, samples/s and peak memory. (b) bench.py --mode t2i
    --attn-core int8: 4d's model with the int8 core at head dim 64,
    calibrated as 4d, one call at T2I_CMP_AR AR steps: the launches exactly
    _int8_call_launches of the model for that call, every row-8 launch on
    the int8 core at 64; the call against the same with the plain versions
    (4d's gate: 2 x floor + 1e-3)."""
    if emb is None or written is None:
        raise AssertionError("no 1.4B weights or prompt embeddings: phase 4o or 4r failed")
    ok_xl, rec = _xl_int8_call(emb, written["transformer"], "int8", "xl_int8_core")
    report["xl_int8_core"] = rec
    pipe = _make_t2i_pipeline(quantize=True, attn_core="int8")
    t0 = time.perf_counter()
    pipe.calibrate(T2I_PROMPTS, num_inference_steps=T2I_CAL_AR, num_diffusion_steps=T2I_DIFF,
                   guidance_scale=T2I_GUIDANCE,
                   generator=torch.Generator(device=DEV).manual_seed(2), margin=1.05)
    torch.cuda.synchronize()
    cal_s = time.perf_counter() - t0
    expected = _int8_call_launches(pipe, T2I_CMP_AR)
    fb.reset_launch_counts()
    with _static_cores() as cores:
        t0 = time.perf_counter()
        lat = _t2i_sample(pipe, ar_steps=T2I_CMP_AR, seed=1)
        call_s = time.perf_counter() - t0
    launches = dict(fb.LAUNCHES)
    counts_ok = (launches == {n: expected.get(n, 0) for n in KERNELS}
                 and cores == {("int8", 64): expected["flash_attention_static"]})
    out_ok = bool(torch.isfinite(lat).all()) and lat.std().item() > 0.05
    print(f"bench.py --mode t2i --attn-core int8 (calibrated in {cal_s:.1f} s): one call of "
          f"{T2I_CMP_AR} AR steps {call_s:.2f} s; launches {launches} (expected {expected}, "
          f"else 0), row 8 by (score core, head dim) {cores}: {'ok' if counts_ok else 'FAIL'}; "
          f"latents finite, std {lat.std().item():.4f}: {'ok' if out_ok else 'FAIL'}")
    for name in expected:
        _record_launches(name, "t2i_int8_core", launches[name])
    _instance_launches("flash_attention_static", "int8 hd 64", "t2i_int8_core",
                       launches["flash_attention_static"])
    agree, cmp = _t2i_compare(pipe, "t2i_int8_core", T2I_CMP_AR)
    report["t2i_int8_core"] = dict(call_s=call_s, calibrate_s=cal_s, launches=launches,
                                   expected=expected, static_cores=str(cores), **cmp)
    del pipe
    torch.cuda.empty_cache()
    if not (ok_xl and counts_ok and out_ok and agree):
        raise AssertionError("int8 score core serving check failed")


# row 1 at head dim 96 and at T != 128 (3h, 4u, 4v, 5i): bench.py --arch
# pc_d48w1536 (16 heads of 96, T = 2048 / 16 = 128: the one-kernel route)
# and bench.py --points 4096 (pc_d48w1024, T = 256: the split route); the
# bf16 core's other admitted T at batch 8 (the fused rule's bounds: 161 at
# D = 1536, 435 at 1024, 607 at 768)
XLPC_ARCH, XLPC_D, XLPC_HEADS, XLPC_F = "pc_d48w1536", 1536, 16, 6144
P4K_POINTS = 4096
ROW1_NEW = {"pc_d48w1536": (T, XLPC_D, XLPC_HEADS, XLPC_F),  # (T, D, heads, F)
            "points_4096": (P4K_POINTS // PATCH, D, HEADS, F)}
ROW1_RAGGED = ((1, 1536, 16), (64, 1536, 16), (100, 1536, 16), (161, 1536, 16), (1, 1024, 16),
               (64, 1024, 16), (100, 1024, 16), (435, 1024, 16), (607, 768, 12))
ROW1_RAGGED_BATCH = 8
# 4u / 4v calibrate on 16 prompts: at batch 128 the plain mirror (float64
# int8 products) takes ~32 s at D = 1024 and T = 128 (phase 4), ~2.25x at
# D = 1536 and ~2x at T = 256
ROW1_CALIB_PROMPTS = 16


@phase("3h row 1 at head dim 96 and T != 128 vs plain")
def check_row1_shapes():
    """fused_attention_block at the two shapes of 4u and 4v in every variant
    (3 cores x static / per-row x smax on / off) at the CFG steps' 2x batch
    and the 1x: (256 / 128, 128, 1536), 16 heads of 96 (the one-kernel
    route at head dim 96), and (256 / 128, 256, 1024), 16 heads of 64 (the
    split route: the bf16 qkv, then attn_core_bf16_kernel); the bf16 core's
    four variants at batch 8 at ROW1_RAGGED's T (1, 64, 100 and the fused
    rule's bounds 161, 435, 607), at T = 607 the f32 core (static, no smax)
    and the int8 core (per row, no smax) too; fused_ln_int8_mlp at 4u's and 4v's 2x
    batch rows, 32768 x 1536 -> 6144 and 65536 x 1024 -> 4096. Phase 3's
    tolerances."""
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(1818)
    bad = []

    def check(name, label, kernel, plain, ops, kw):
        y = kernel(*ops, **kw)
        torch.cuda.synchronize()
        if not _tol_check(name, label, y, plain(*ops, **kw), like=ops[0]):
            bad.append(f"{name} {label}")

    for label, (t, d, heads, f) in ROW1_NEW.items():
        for n in (2 * BATCH, BATCH):
            ops = _kernel_operands(gen, n, "attention", t, d, f)
            for vlabel, kw in _variants("attention", heads):
                check("fused_attention_block", f"{label} {n}x{t}x{d} {vlabel}",
                      fb.fused_attention_block, fb.fused_attention_block_plain, ops, kw)
            del ops
            torch.cuda.empty_cache()
    for t, d, heads in ROW1_RAGGED:
        ops = _kernel_operands(gen, ROW1_RAGGED_BATCH, "attention", t, d, 4 * d)
        variants = _variants("attention", heads)
        # the bf16 core's four; at T = 607 also the f32 and int8 cores (a
        # block of 607 threads, the int8 core over 48 KB of shared memory)
        for vlabel, kw in variants[:4] + (variants[5:6] + variants[11:] if t == 607 else []):
            check("fused_attention_block", f"{ROW1_RAGGED_BATCH}x{t}x{d} {vlabel}",
                  fb.fused_attention_block, fb.fused_attention_block_plain, ops, kw)
    for label, (t, d, heads, f) in ROW1_NEW.items():
        ops = _kernel_operands(gen, 2 * BATCH * t, "mlp", t, d, f)
        for vlabel, kw in _variants("mlp"):
            check("fused_ln_int8_mlp", f"{label} {2 * BATCH * t}x{d}->{f} {vlabel}",
                  fb.fused_ln_int8_mlp, fb.fused_ln_int8_mlp_plain, ops, kw)
        del ops
        torch.cuda.empty_cache()
    fb.reset_launch_counts()  # these launches were comparisons, not a path
    report["row1_3h_s"] = time.perf_counter() - t0
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")


def _row1_serving(label, arch, points, depth):
    """4u / 4v: the int8 call of ``arch`` at ``points`` as phase 4 serves
    the flagship (patch 16, calibrated static scales, bf16 core, DDPM 25
    steps, CFG 7.5 cut at 800, batch 128, bf16 weights), calibrated on
    ROW1_CALIB_PROMPTS prompts; a warm-up call, then one call's launches
    (depth x 25 of rows 1 and 2, 0 of every other kernel) and output
    (finite, in [-1, 1], a spread); one forward of the stack at the first
    CFG step against the plain versions (phase 4's gate; no whole plain
    call: its ~40 s at this width); the p50 of 3 calls and the peak memory
    above what is held."""
    pipe = _make_pipeline(arch, points)
    t0 = time.perf_counter()
    pipe.calibrate(prompt_embeds=pipe.encode_prompt(PROMPTS[:ROW1_CALIB_PROMPTS]),
                   num_points=points, num_diffusion_steps=STEPS,
                   generator=torch.Generator(device=DEV).manual_seed(2))
    calib_s = time.perf_counter() - t0
    print(f"{label}: calibrated on {ROW1_CALIB_PROMPTS} prompts (batch {BATCH} would take "
          f"~{BATCH // ROW1_CALIB_PROMPTS}x as long) in {calib_s:.1f} s")
    _sample(pipe, seed=9, num_points=points)  # warm-up: kernel loads, allocator
    gen = torch.Generator(device=DEV).manual_seed(1)
    latents = torch.randn((BATCH, points, 3), generator=gen, device=DEV)
    fb.reset_launch_counts()
    out = _sample(pipe, latents=latents, num_points=points)
    launches = dict(fb.LAUNCHES)
    expected = depth * STEPS
    counts_ok = launches == {n: expected if n in _kernels() else 0 for n in KERNELS}
    print(f"{label}: launches in one call: {launches} (expected {expected} of rows 1 and 2, 0 "
          f"of the others): {'ok' if counts_ok else 'FAIL'}")
    for name in _kernels():
        _record_launches(name, label, launches[name])
    pts, cols = out.point_clouds.float(), out.colors.float()
    ok = (tuple(pts.shape) == (BATCH, points, 3) and bool(torch.isfinite(pts).all())
          and pts.abs().max().item() <= 1.0 and 0.0 <= cols.min().item()
          and cols.max().item() <= 1.0 and pts.std().item() > 0.05)
    print(f"{label}: output {tuple(pts.shape)} finite, in [-1, 1], std {pts.std().item():.4f}: "
          f"{'ok' if ok else 'FAIL'}")
    fwd_ok, rel, rel_floor = _forward_vs_plain(pipe, latents, gen, depth)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        _sample(pipe, seed=20 + i, num_points=points)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() - held
    p50 = float(np.percentile(times, 50))
    print(f"{label}: batch {BATCH}, {STEPS} steps, p50 {p50:.3f} s per call, "
          f"{BATCH / p50:.2f} samples/s (times {[round(x, 3) for x in times]}); peak "
          f"{peak / 2 ** 30:.2f} GiB above {held / 2 ** 30:.2f} held")
    report["pipeline"][label] = dict(
        arch=arch, points=points, calibrate_s=calib_s, launches=launches, output_ok=ok,
        forward_rel_err=rel, forward_rel_floor=rel_floor, p50_s=p50,
        samples_per_s=BATCH / p50, times_s=times, peak_bytes_above_held=peak)
    if not (ok and fwd_ok and counts_ok):
        raise AssertionError(f"{label} check failed")
    return pipe


@phase("4u bench.py --arch pc_d48w1536 (head dim 96)")
def xlpc_serving():
    """pc_d48w1536 (48 x 1536, 16 heads of 96) at 2048 points: row 1 on
    attn_qkv_core_kernel<96> (T = 128). Kept for phase 6's profile."""
    return _row1_serving("pc_d48w1536", XLPC_ARCH, POINTS, DEPTH)


@phase("4v bench.py --points 4096 (T = 256)")
def points4096_serving():
    """The flagship's pc_d48w1024 at 4096 points: T = 256, row 1 on the
    split route (the bf16 qkv, attn_core_bf16_kernel<64>), row 2 at 65536
    rows at the 2x batch. Freed after the phase."""
    _row1_serving("points_4096", ARCH, P4K_POINTS, DEPTH)
    torch.cuda.empty_cache()


# the instances of row 1's cores added for head dim 96 and T != 128 that
# are not wgmma instances (phase 5's gate prints those: the hd-96 QKV +
# core kernel, the split route's TMA-store QKV GEMM), by their mangled
# names (ptxas reports in 5i)
ROW1_NEW_INSTANCES = {"split bf16 core, hd 64": "attn_core_bf16_kernelILi64E",
                      "split bf16 core, hd 96": "attn_core_bf16_kernelILi96E",
                      "f32 core, hd 96": "attn_core_scalar_kernelILi0ELi96E",
                      "int8 core, hd 96": "attn_core_scalar_kernelILi2ELi96E",
                      "f32 core, hd 64": "attn_core_scalar_kernelILi0ELi64E",
                      "int8 core, hd 64": "attn_core_scalar_kernelILi2ELi64E"}


@phase("5i timing of row 1 at head dim 96 and T = 256")
def timing_row1_shapes():
    """fused_attention_block at 4u's and 4v's shapes at the 2x and 1x batch,
    the flagship variant (static, bf16 core, smax): events, a CUDA graph,
    plain, the bound (_bound_ms); at T = 256 the byte time of the split
    route's bf16 qkv round trip (M x 3D written and read back); row 2 at
    the 2x batch's rows of both (32768 x 1536 -> 6144, 65536 x 1024 ->
    4096), the same readings and torch._int_mm's time for its two products;
    ptxas of each new instance (ROW1_NEW_INSTANCES)."""
    gen = torch.Generator(device=DEV).manual_seed(1819)
    for label, (t, d, heads, f) in ROW1_NEW.items():
        kw = _variants("attention", heads)[0][1]
        for n in (2 * BATCH, BATCH):
            ops = _kernel_operands(gen, n, "attention", t, d, f)
            row = _time_kernel("fused_attention_block", (label, n, t, d),
                               lambda: fb.fused_attention_block(*ops, **kw),
                               lambda: fb.fused_attention_block_plain(*ops, **kw),
                               _bound_ms("attention", n, t, d, f), graph=True)
            if t != fb.ATTN_T:
                row["qkv_round_trip_ms"] = 2 * n * t * 3 * d * 2 / PEAK_BYTES * 1e3
                print(f"    the split route's bf16 qkv ({n * t} x {3 * d}) written and read "
                      f"back: {row['qkv_round_trip_ms']:.4f} ms at {PEAK_BYTES / 1e12} TB/s")
            del ops
            torch.cuda.empty_cache()
    # row 2 (fused_ln_int8_mlp) at the rows 4u and 4v give it: 32768 x 1536
    # -> 6144 and 65536 x 1024 -> 4096, beside torch._int_mm's two products
    for label, (t, d, heads, f) in ROW1_NEW.items():
        m = 2 * BATCH * t
        ops = _kernel_operands(gen, m, "mlp", t, d, f)
        kw = _variants("mlp")[0][1]
        row = _time_kernel("fused_ln_int8_mlp", (label, m, d, f),
                           lambda: fb.fused_ln_int8_mlp(*ops, **kw),
                           lambda: fb.fused_ln_int8_mlp_plain(*ops, **kw),
                           _bound_ms("mlp", m, t, d, f), graph=True)
        row["int_mm_ms"] = _int_mm_ms(gen, (m, d, f), (m, f, d))
        print(f"    torch._int_mm, its two products alone: {row['int_mm_ms']} ms")
        del ops
        torch.cuda.empty_cache()
    out = {}
    for label, mangled in ROW1_NEW_INSTANCES.items():
        out[label] = _ptxas_report(mangled, library="fused_attention_block")
        print(f"  fused_attention_block ptxas ({label}): {out[label]}")
    report["kernels"].setdefault("fused_attention_block", {})["ptxas_new"] = out
    fb.reset_launch_counts()


def _flash_flops(lq, lk, bh=T2I_ROWS * HEADS, d=64):
    """FLOPs of the flash kernels of one training step, from their shapes:
    forward 4 BH Lq Lk d (twice: remat), backward 10 BH Lq Lk d (the
    function's own count: s, do vᵀ, pᵀ do, dsᵀ q, ds k)."""
    per = bh * lq * lk * d
    return TRAIN_FLASH_LAYERS * (2 * 4 + 10) * per


def _ptxas_report(kernel, library="flash_attention_bwd"):
    """The ``-Xptxas -v`` lines (registers, spills) of the kernel of
    ``library`` whose mangled name holds ``kernel``, from this checkout's
    build log, and a count of ptxas's wgmma notes on it (C751x: wgmma
    serialized, or a warpgroup arrive injected)."""
    lines, on, notes = [], False, 0
    for line in _build.build_log(library).splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif "(C751" in line:
            notes += kernel in line
        elif on and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines + [f"{notes} wgmma notes (C751x)"])


# the instances of csrc/flash_fwd.cuh's attn_fwd_kernel<STATIC, INT8, KBIAS,
# FBIAS> in each library, by the mangled template arguments
FWD_INSTANCES = {
    "flash_attention": {"no bias": "attn_fwd_kernelILi64ELb0ELb0ELb0ELb0E",
                        "key bias": "attn_fwd_kernelILi64ELb0ELb0ELb1ELb0E",
                        "full bias": "attn_fwd_kernelILi64ELb0ELb0ELb0ELb1E",
                        "hd 96 no bias": "attn_fwd_kernelILi96ELb0ELb0ELb0ELb0E",
                        "hd 96 key bias": "attn_fwd_kernelILi96ELb0ELb0ELb1ELb0E",
                        "hd 96 full bias": "attn_fwd_kernelILi96ELb0ELb0ELb0ELb1E"},
    "flash_attention_static": {"bf16": "attn_fwd_kernelILi64ELb1ELb0ELb0ELb0E",
                               "bf16 key bias": "attn_fwd_kernelILi64ELb1ELb0ELb1ELb0E",
                               "int8": "attn_fwd_kernelILi64ELb1ELb1ELb0ELb0E",
                               "int8 key bias": "attn_fwd_kernelILi64ELb1ELb1ELb1ELb0E",
                               "hd 96 bf16": "attn_fwd_kernelILi96ELb1ELb0ELb0ELb0E",
                               "hd 96 bf16 key bias": "attn_fwd_kernelILi96ELb1ELb0ELb1ELb0E",
                               "hd 96 int8": "attn_fwd_kernelILi96ELb1ELb1ELb0ELb0E",
                               "hd 96 int8 key bias": "attn_fwd_kernelILi96ELb1ELb1ELb1ELb0E"}}
# the instances that must show no spill in ptxas's report (those of this
# slice; the gate of the others stays wgmma and TMA)
NO_SPILL_INSTANCES = ("hd 96 int8", "hd 96 int8 key bias")


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "UTMASTG", "UTMAREDG", "HMMA", "IMMA")


def _sass_ops(library):
    """Counts of the tensor-core and TMA instructions, and of all
    instructions, in each function of the built ``library`` (``cuobjdump
    -sass``): {mangled name: {op: n}}."""
    so = _build._library_path(library)
    sass = subprocess.run([str(Path(_build.nvcc_path()).parent / "cuobjdump"), "-sass", str(so)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            counts[fn] = dict.fromkeys(SASS_OPS + ("instructions",), 0)
        elif fn is not None:
            for op in SASS_OPS:
                counts[fn][op] += f" {op}." in line or f" {op} " in line
            counts[fn]["instructions"] += line.lstrip().startswith("/*") and "*/" in line[4:]
    return counts


def _fwd_ptxas(name):
    """Print and record the ptxas report of each instance of ``name``'s
    forward kernel and its SASS: every instance issues wgmma (HGMMA; IGMMA
    for the int8 score core) and TMA loads (UTMALDG) and no mma.sync (HMMA,
    IMMA), and no function of the library is an mma.sync attention kernel
    of the first design; raises otherwise."""
    out, sass = {}, _sass_ops(name)
    gone = [fn for fn in sass if "flash_fwd_bf16_kernel" in fn or "flash_static_kernel" in fn]
    bad = [f"{name}: first-design kernel {fn}" for fn in gone]
    for label, mangled in FWD_INSTANCES[name].items():
        ops = next(c for fn, c in sass.items() if mangled in fn)
        out[label] = f"{_ptxas_report(mangled, library=name)}; SASS " + ", ".join(
            f"{op} {n}" for op, n in ops.items())
        print(f"  {name} ptxas ({label}): {out[label]}")
        int8 = "int8" in label
        _, spills, _ = _ptxas_numbers(mangled, name)
        if not (ops["HGMMA"] and ops["UTMALDG"] and (ops["IGMMA"] or not int8)
                and ops["HMMA"] == ops["IMMA"] == 0
                and (spills == 0 or label not in NO_SPILL_INSTANCES)):
            bad.append(f"{name} ({label}): {ops}, {spills} spill bytes")
    report["kernels"].setdefault(name, {})["ptxas"] = out
    if bad:
        raise AssertionError(f"the forward kernels are not on wgmma and TMA: {bad}")


# the wgmma instances of each int8 library, by their mangled names:
# csrc/int8_wgmma.cuh's gemm_s8_wgmma_kernel<EPI, tile width, TMA store>
# (by the epilogue), row 1's QKV + bf16 core kernel, row 5's fc2 + post-LN
# kernel<x is bf16>
INT8_INSTANCES = {
    "int8_linear": {
        "cast + bias, 128 x 256, TMA store": "gemm_s8_wgmma_kernelILi8ELi256ELb1E",
        "cast + bias, 128 x 128, TMA store": "gemm_s8_wgmma_kernelILi8ELi128ELb1E",
        "cast + bias, 128 x 256, f32 out": "gemm_s8_wgmma_kernelILi8ELi256ELb0E",
        "cast + bias, 128 x 128, f32 out": "gemm_s8_wgmma_kernelILi8ELi128ELb0E"},
    "fused_ln_int8_matmul": {
        "store, 128 x 256, TMA store": "gemm_s8_wgmma_kernelILi0ELi256ELb1E",
        "store, 128 x 128, TMA store": "gemm_s8_wgmma_kernelILi0ELi128ELb1E",
        "store, 128 x 256, f32 out": "gemm_s8_wgmma_kernelILi0ELi256ELb0E",
        "store, 128 x 128, f32 out": "gemm_s8_wgmma_kernelILi0ELi128ELb0E"},
    "int8_matmul_residual": {
        "residual, 128 x 256, TMA in and store": "gemm_s8_wgmma_kernelILi3ELi256ELb1E",
        "residual, 128 x 128, TMA in and store": "gemm_s8_wgmma_kernelILi3ELi128ELb1E",
        "residual, 128 x 256, f32": "gemm_s8_wgmma_kernelILi3ELi256ELb0E",
        "residual, 128 x 128, f32": "gemm_s8_wgmma_kernelILi3ELi128ELb0E"},
    "fused_ln_int8_mlp": {"fc1 relu -> int8 (static)": "gemm_s8_wgmma_kernelILi1E",
                          "fc1 relu -> f32 (per row)": "gemm_s8_wgmma_kernelILi2E",
                          "fc2 + residual": "gemm_s8_wgmma_kernelILi3E"},
    "fused_attention_block": {
        "qkv + bf16 core, hd 64": "attn_qkv_core_kernelILi64E",
        "qkv + bf16 core, hd 96": "attn_qkv_core_kernelILi96E",
        "qkv -> f32 (f32 / int8 cores)": "gemm_s8_wgmma_kernelILi0ELi256ELb0E",
        "qkv -> bf16 (split route), 128 x 256, TMA store": "gemm_s8_wgmma_kernelILi0ELi256ELb1E",
        "qkv -> bf16 (split route), 128 x 128, TMA store": "gemm_s8_wgmma_kernelILi0ELi128ELb1E",
        "out-projection + residual": "gemm_s8_wgmma_kernelILi3E"},
    "fused_int8_mlp_postln": {"fc1 gelu -> int8 (static)": "gemm_s8_wgmma_kernelILi4E",
                              "fc1 gelu -> f32 (per row)": "gemm_s8_wgmma_kernelILi5E",
                              "fc2 + post-LN, f32 x": "fc2_postln_kernelILb0E",
                              "fc2 + post-LN, bf16 x": "fc2_postln_kernelILb1E"}}
# the bf16 products of the attention core
HGMMA_INSTANCES = ("attn_qkv_core_kernelILi64E", "attn_qkv_core_kernelILi96E")
# row 1's split-route core, a first design on mma.sync (HMMA): the one
# function of the int8 libraries allowed it
MMA_SYNC_FUNCTIONS = ("attn_core_bf16_kernel",)
# the instances that store a bf16 output by TMA (UTMASTG)
TMA_STORE_INSTANCES = tuple(m for lib in ("int8_linear", "fused_ln_int8_matmul",
                                         "int8_matmul_residual", "fused_attention_block")
                            for label, m in INT8_INSTANCES[lib].items()
                            if "TMA store" in label or "TMA in and store" in label)


def _ptxas_numbers(kernel, library):
    """(registers, spill bytes stored + loaded, C7514 notes: every wgmma
    serialized) of the kernel of ``library`` whose mangled name holds
    ``kernel``, from this checkout's build log."""
    regs, spills, serial, on = None, None, 0, False
    for line in _build.build_log(library).splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif "(C7514)" in line:
            serial += kernel in line
        elif on and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            spills = nums[1] + nums[2]  # stack frame, spill stores, spill loads
        elif on and "Used" in line and "registers" in line:
            regs = int(line.split("Used", 1)[1].split()[0])
    return regs, spills, serial


def _int8_ptxas():
    """Print and record the ptxas report and the SASS of each wgmma instance
    of the int8 libraries (int8_linear, rows 3, 4, 2, 1 and 5): every instance
    issues s8
    wgmma (IGMMA) and TMA loads (UTMALDG), row 1's core bf16 wgmma (HGMMA)
    too, with no spills and no C7514 note; no function of the libraries
    issues mma.sync (IMMA, HMMA; MMA_SYNC_FUNCTIONS may issue HMMA) or is
    the mma.sync GEMM of the first design (gemm_s8_kernel); raises
    otherwise."""
    bad = []
    for library, instances in INT8_INSTANCES.items():
        out, sass = {}, _sass_ops(library)
        bad += [f"{library}: mma.sync {fn}" for fn, c in sass.items()
                if "gemm_s8_kernel" in fn or c["IMMA"]
                or (c["HMMA"] and not any(m in fn for m in MMA_SYNC_FUNCTIONS))]
        for label, mangled in instances.items():
            ops = next(c for fn, c in sass.items() if mangled in fn)
            regs, spills, serial = _ptxas_numbers(mangled, library)
            out[label] = (f"{_ptxas_report(mangled, library=library)}; {serial} C7514; "
                          f"SASS " + ", ".join(f"{op} {n}" for op, n in ops.items()))
            print(f"  {library} ptxas ({label}): {out[label]}")
            if not (ops["IGMMA"] and ops["UTMALDG"] and ops["IMMA"] == ops["HMMA"] == 0
                    and (ops["HGMMA"] or mangled not in HGMMA_INSTANCES)
                    and (ops["UTMASTG"] or mangled not in TMA_STORE_INSTANCES)
                    and spills == 0 and serial == 0):
                bad.append(f"{library} {label}: {ops}, {spills} spill bytes, {serial} C7514")
        report["kernels"].setdefault(library, {})["ptxas"] = out
    if bad:
        raise AssertionError(f"the int8 kernels are not all on wgmma and TMA: {bad}")


# the instances of flash_attention.cu's f32 forward kernel,
# flash_fwd_f32_kernel<KBIAS, FBIAS>, by their mangled template arguments
F32_FWD_INSTANCES = {"no bias": "flash_fwd_f32_kernelILi64ELb0ELb0E",
                     "key bias": "flash_fwd_f32_kernelILi64ELb1ELb0E",
                     "full bias": "flash_fwd_f32_kernelILi64ELb0ELb1E",
                     "hd 96 no bias": "flash_fwd_f32_kernelILi96ELb0ELb0E",
                     "hd 96 key bias": "flash_fwd_f32_kernelILi96ELb1ELb0E",
                     "hd 96 full bias": "flash_fwd_f32_kernelILi96ELb0ELb1E"}
TENSOR_CORE_OPS = ("HGMMA", "IGMMA", "HMMA", "IMMA")


def _f32_fwd_ptxas():
    """Print and record the ptxas report and the SASS of each instance of
    the f32 forward kernel: no spills, and no tensor-core instruction (no
    wgmma or mma.sync: HGMMA, IGMMA, HMMA, IMMA), so no TF32 on a route
    that exists for exactness; raises otherwise."""
    out, bad, sass = {}, [], _sass_ops("flash_attention")
    for label, mangled in F32_FWD_INSTANCES.items():
        ops = next((c for fn, c in sass.items() if mangled in fn), None)
        _, spills, _ = _ptxas_numbers(mangled, "flash_attention")
        if ops is None or spills is None:
            bad.append(f"{label}: {mangled} not in the library or its build log")
            continue
        out[label] = f"{_ptxas_report(mangled, library='flash_attention')}; SASS " + ", ".join(
            f"{op} {n}" for op, n in ops.items())
        print(f"  flash_attention f32 ptxas ({label}): {out[label]}")
        if spills != 0 or any(ops[op] for op in TENSOR_CORE_OPS):
            bad.append(f"{label}: {spills} spill bytes, {ops}")
    report["kernels"].setdefault("flash_attention", {})["f32_ptxas"] = out
    if bad:
        raise AssertionError(f"the f32 forward spills or reaches the tensor cores: {bad}")


def _int_mm_ms(gen, *products):
    """torch._int_mm's time for the int8 products (m, k, n) of a kernel
    (the MLP's two: (m, d, f) and (m, f, d)), on random int8 codes, the
    weights in the K-major layout the kernel reads (a column-major operand
    for _int_mm): a yardstick of the GEMM part only (no LayerNorm, quant or
    epilogue), used nowhere in the port; None where the call refuses these
    operands."""
    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device=DEV, dtype=torch.int8)
    pairs = [(codes(m, k), codes(n, k).t()) for m, k, n in products]
    try:
        return sync_ms(lambda: [torch._int_mm(a, w) for a, w in pairs], 10)
    except RuntimeError as e:
        print(f"  torch._int_mm: refused ({e})")
        return None


@phase("5d timing of the backward kernels and the training step")
def timing_train(pipe):
    """The bf16 backward's kernels (prep, dkvq, cast) per launch at (8, 16,
    1280, 64), the f32 route's dK/dV and dQ at the same shape in f32, their
    plain version (the whole plain backward), one library call where one
    computes the same function (SDPA's backward for the gradients, from a
    graph built once; a strided copy for the cast), their bounds (the
    operations over the peak rate of their type, or the bytes: each input
    read once, each output written once), the whole backward through
    autograd against its joint bound; the f32 forward kernel beside SDPA's
    f32 forward, its instances' ptxas reports (no spill) and SASS (no
    tensor-core instruction) as gates; then the training step."""
    import torch.nn.functional as Fn
    from torch.utils.flop_counter import FlopCounterMode

    gen = torch.Generator(device=DEV).manual_seed(8)
    L, bh = T2I_L["full"], T2I_ROWS * HEADS
    q, k, v, _ = _static_attention_operands(gen, L, "none")
    o, lse = fa.flash_attention_with_lse(q, k, v)
    do = torch.randn(o.shape, generator=gen, device=DEV).to(torch.bfloat16)
    launches, _ = fa._bwd_operands(q, k, v, None, None, o, lse, do)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def sdpa_fwd():
        with torch.no_grad():
            Fn.scaled_dot_product_attention(ins[0], ins[1], ins[2])

    # the backward alone, from a graph built once (retain_graph): SDPA's
    # (dq, dk, dv) and the port's whole autograd backward (prep, dkvq, cast)
    o_lib = Fn.scaled_dot_product_attention(*ins)
    library = sync_ms(lambda: torch.autograd.grad(o_lib, ins, do, retain_graph=True), 20)
    o_port = fa.flash_attention(*ins)
    port_bwd = sync_ms(lambda: torch.autograd.grad(o_port, ins, do, retain_graph=True), 20)
    del o_lib, o_port
    # the forward kernel at this shape too (its kernels-line entry stays path A's)
    _time_kernel("flash_attention", (T2I_ROWS, HEADS, L, 64),
                 lambda: fa.flash_attention_with_lse(q, k, v),
                 lambda: fa.flash_attention_plain(q, k, v),
                 _bound(4 * bh * L * L * 64 / PEAK_BF16_FLOPS, 4 * bh * L * 64 * 2 + bh * L * 4),
                 library=sdpa_fwd, graph=True)
    plain_ms = sync_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, None, None, o, lse, do), 3)
    plan = fa.bwd_plan(T2I_ROWS, HEADS, L, L)
    io, rows, ws_bytes = bh * L * 64 * 2, bh * plan["lqp"] * 4, bh * plan["lqp"] * 64 * 4
    ws, dq = launches[1][3][8], torch.empty_like(q)
    bounds = {  # (operations in seconds, bytes)
        "flash_attention_bwd_prep": (2 * bh * L * 64 / PEAK_F32_FLOPS, 2 * io + bh * L * 4 + 2 * rows),
        "flash_attention_bwd_dkvq": (10 * bh * L * L * 64 / PEAK_BF16_FLOPS,
                                     4 * io + 2 * rows + 2 * io + ws_bytes),
        "flash_attention_bwd_dq_cast": (0.0, ws_bytes + io)}
    libs = {"flash_attention_bwd_dkvq": library,
            "flash_attention_bwd_dq_cast": sync_ms(
                lambda: torch.mul(ws[:, :L].view(T2I_ROWS, HEADS, L, 64), 0.125, out=dq), 20)}
    total = 0.0
    for name in fa.BWD_KERNELS:
        ms = sync_ms(lambda: fa.run_bwd(launches, (name,)), 20)
        total += ms
        bound = _bound(*bounds[name])
        row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
                   library_ms=libs.get(name))
        lib_txt = "" if row["library_ms"] is None else f", library {row['library_ms']:.3f} ms"
        print(f"  {name} {(T2I_ROWS, HEADS, L, 64)}: {ms:.3f} ms/launch, plain backward "
              f"{plain_ms:.3f} ms{lib_txt}, bound {bound[0]:.3f} ms ({bound[1]}), "
              f"{bound[0] / ms:.1%} of bound")
        report["kernels"][name].update(row)
    ptxas = _ptxas_report("flash_bwd_dkvq")
    joint = _bound(10 * bh * L * L * 64 / PEAK_BF16_FLOPS, 8 * io + bh * L * 4)
    print(f"  the whole backward at {(T2I_ROWS, HEADS, L, 64)} bf16: prep + dkvq + cast "
          f"{total:.3f} ms, through autograd {port_bwd:.3f} ms, SDPA's backward {library:.3f} ms "
          f"(dq, dk and dv); joint bound {joint[0]:.3f} ms ({joint[1]}: 10 BH Lq Lk d FLOPs), "
          f"{joint[0] / port_bwd:.1%} of it through autograd; dkvq ptxas: {ptxas}")
    report.setdefault("t2i_train", {}).update(
        bwd_kernels_ms=total, bwd_autograd_ms=port_bwd, sdpa_bwd_ms=library,
        bwd_joint_bound_ms=joint[0], dkvq_ptxas=ptxas)
    del launches, ins, ws, dq
    # the f32 route at the same shape in f32: its one-pass kernel (events;
    # a prepared launch holds the stream it was prepared on, so no graph),
    # the route's launches (prep, the zeroed dq, the kernel) from a CUDA
    # graph, the whole f32 backward through autograd and SDPA's f32
    # backward, each from an autograd graph built once; the f32 forward
    # kernel and SDPA's f32 forward (events and a CUDA graph)
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    launches, _ = fa._bwd_operands(q, k, v, None, None, o, lse, do)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = Fn.scaled_dot_product_attention(*ins)
    library32 = sync_ms(lambda: torch.autograd.grad(o_lib, ins, do, retain_graph=True), 5)
    o_port = fa.flash_attention(*ins)
    port32 = sync_ms(lambda: torch.autograd.grad(o_port, ins, do, retain_graph=True), 5)
    del o_lib, o_port

    def sdpa_fwd32():
        with torch.no_grad():
            Fn.scaled_dot_product_attention(ins[0], ins[1], ins[2])

    io32 = 2 * io
    _instance("flash_attention", "f32 hd 64", _time_kernel(
        "flash_attention", (T2I_ROWS, HEADS, L, 64, "f32"),
        lambda: fa.flash_attention_with_lse(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
        _bound(4 * bh * L * L * 64 / PEAK_F32_FLOPS, 4 * io32 + bh * L * 4),
        library=sdpa_fwd32, iters=5, graph=True))
    _f32_fwd_ptxas()
    plain32 = sync_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, None, None, o, lse, do), 3)

    def run32():
        fa.run_bwd(launches, ("flash_attention_bwd_f32",))

    ms = sync_ms(run32, 5)
    graph32 = graph_ms(lambda: fa._launch_bwd(q, k, v, None, None, o, lse, do), n=5, reps=3)
    bound = _bound(10 * bh * L * L * 64 / PEAK_F32_FLOPS, 7 * io32 + 2 * rows)
    row = dict(ms=ms, graph_ms=graph32, plain_ms=plain32, bound_ms=bound[0], bound_by=bound[1],
               library_ms=library32, autograd_ms=port32)
    report["kernels"]["flash_attention_bwd_f32"].update(row)
    ptxas32 = {label: _ptxas_report(f"flash_bwd_f32_kernelILb{i}E")
               for i, label in enumerate(("no / key bias", "full bias"))}
    print(f"  flash_attention_bwd_f32 {(T2I_ROWS, HEADS, L, 64)} f32: {ms:.3f} ms/launch; prep + "
          f"zeroed dq + kernel from a graph {graph32:.3f} ms, the whole f32 backward through "
          f"autograd {port32:.3f} ms, plain "
          f"backward {plain32:.3f} ms, SDPA f32 backward {library32:.3f} ms; bound "
          f"{bound[0]:.3f} ms ({bound[1]}: 10 BH Lq Lk d FLOPs at 67 TFLOP/s f32), "
          f"{bound[0] / ms:.1%} of bound; ptxas: {ptxas32}")
    report.setdefault("t2i_train", {}).update(bwd_f32_ptxas=ptxas32)
    del q, k, v, o, lse, do, launches, ins
    torch.cuda.empty_cache()
    fb.reset_launch_counts()
    if pipe is None:
        raise AssertionError("no training pipeline: phase 4f failed")
    data = itertools.repeat(_train_batch(4))
    pipe.train(data, pipe.trainer.step + 2)  # warm-ups
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        pipe.train(data, pipe.trainer.step + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    p50 = float(np.percentile(times, 50))
    with FlopCounterMode(display=False) as counter:
        pipe.train(data, pipe.trainer.step + 1)
    lib_flops = counter.get_total_flops()
    flash = _flash_flops(L, L)
    tflops = (lib_flops + flash) / p50 / 1e12
    print(f"t2i training: batch {TRAIN_BATCH}, p50 {p50:.3f} s per step, "
          f"{TRAIN_BATCH / p50:.2f} samples/s (times {[round(t, 3) for t in times]}); peak "
          f"memory {peak / 2 ** 30:.2f} GiB; FLOPs per step {lib_flops / 1e12:.2f} T (library "
          f"ops, FlopCounterMode) + {flash / 1e12:.2f} T (flash kernels, from shapes) = "
          f"{tflops:.1f} TFLOP/s, {tflops * 1e12 / PEAK_BF16_FLOPS:.1%} of the bf16 peak")
    report["t2i_train"].update(batch=TRAIN_BATCH, p50_s=p50, samples_per_s=TRAIN_BATCH / p50,
                               times_s=times, peak_bytes=peak, library_flops=lib_flops,
                               flash_flops=flash, tflop_s=tflops)


def _bound(ops_s, nbytes):
    """Least time for the work in ms: its operations over the peak rate of
    their type (``ops_s``, seconds), or its bytes (each input read once, each
    output written once) over the memory rate, whichever is larger."""
    bytes_s = nbytes / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


def _bound_ms(kind, n, t=T, d=D, f=F):
    """Bounds of the flagship kernels (or at T = t, D = d, F = f): n rows
    (MLP) or samples (attention: the int8 projections, 2 n t d 4d
    operations, at the int8 peak plus the bf16 core, 4 n t^2 d FLOPs, at the
    bf16 peak, against x read and y written in bf16 and the weights)."""
    if kind == "mlp":
        return _bound(4 * n * d * f / PEAK_INT8_OPS, 2 * n * d * 2 + 2 * d * f)
    rows = n * t
    return _bound(2 * rows * d * 4 * d / PEAK_INT8_OPS + 4 * n * t * t * d / PEAK_BF16_FLOPS,
                  2 * rows * d * 2 + 4 * d * d)


def _attention_floors(n):
    """Row 1's byte floors in ms at n samples: what the design moves through
    device memory (x read by the LN pass and again as the residual, y
    written, the int8 q1 and attention rows each written and read, the
    weights, the row scales), and the first design's, which also wrote the
    bf16 qkv rows (M x 3D) and read them back."""
    rows = n * T
    new = 3 * rows * D * 2 + 2 * rows * D + 2 * rows * D + 4 * D * D + 2 * rows * 4
    return new / PEAK_BYTES * 1e3, (new + 2 * rows * 3 * D * 2) / PEAK_BYTES * 1e3


def _postln_floors(m, x_bytes):
    """Row 5's byte floors in ms at m rows: x read by the quant pass and
    again as the residual, y written, the int8 x and mid rows each written
    and read, the weights, the row scales; and the first design's, which
    also wrote the f32 product (M x D) and read it back in its row pass."""
    new = 3 * m * D * x_bytes + 2 * m * D + 2 * m * F + 2 * D * F + 2 * m * 4
    return new / PEAK_BYTES * 1e3, (new + 2 * m * D * 4) / PEAK_BYTES * 1e3


def _print_floors(name, row, new, old, extra=""):
    row.update(byte_floor_ms=new, first_design_byte_floor_ms=old)
    print(f"    {name}: byte floor of this design {new:.4f} ms, of the first design "
          f"{old:.4f} ms; operation bound {row['bound_ms']:.4f} ms{extra}")


def _time_kernel(name, shape_key, kernel, plain, bound, library=None, iters=20, graph=False):
    """Event-timed ms per launch of the kernel, its plain version and the
    library call; with ``graph`` also the kernel and the library call
    replayed from a CUDA graph (``graph_ms``)."""
    ms = sync_ms(kernel, iters)
    plain_ms = sync_ms(plain, 3)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
               library_ms=None if library is None else sync_ms(library, iters))
    lib = "" if library is None else f", library {row['library_ms']:.3f} ms"
    if graph:
        row["graph_ms"] = graph_ms(kernel)
        if library is not None:
            row["library_graph_ms"] = graph_ms(library)
            lib += f" (graph {row['library_graph_ms']:.3f})"
    graph_txt = f" (graph {row['graph_ms']:.3f})" if graph else ""
    print(f"  {name} {shape_key}: {ms:.3f} ms/launch{graph_txt}, plain {plain_ms:.3f} ms{lib}, "
          f"bound {bound[0]:.3f} ms ({bound[1]}), {bound[0] / ms:.1%} of bound")
    report["kernels"].setdefault(name, {}).setdefault("by_shape", {})[str(shape_key)] = row
    return row


@phase("5 timing")
def timing(pipe):
    gen = torch.Generator(device=DEV).manual_seed(5)
    for name, (kind, kernel, plain) in _kernels().items():
        kw = dict(_variants(kind)[0][1])  # flagship: static acts (+ bf16 core, smax)
        for mult in (2, 1):
            n = FLAGSHIP_SHAPE[kind] * mult // 2
            ops = _kernel_operands(gen, n, kind)
            row = _time_kernel(name, tuple(ops[0].shape), lambda: kernel(*ops, **kw),
                               lambda: plain(*ops, **kw), _bound_ms(kind, n), graph=True)
            del ops
            if kind == "attention":
                _print_floors(name, row, *_attention_floors(n))
            if kind == "mlp":
                row["int_mm_ms"] = _int_mm_ms(gen, (n, D, F), (n, F, D))
                print(f"    torch._int_mm, its two products alone: {row['int_mm_ms']} ms")
            if mult == 2:  # the kernels line quotes the CFG steps' 2x batch
                report["kernels"][name].update(row)
            torch.cuda.empty_cache()
    _int8_ptxas()
    fb.reset_launch_counts()
    if pipe is None:
        raise AssertionError("no pipeline: the main path failed")
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        _sample(pipe, seed=20 + i)
        times.append(time.perf_counter() - t0)
    p50 = float(np.percentile(times, 50))
    print(f"pipeline: batch {BATCH}, {STEPS} steps, p50 {p50:.3f} s per call, "
          f"{BATCH / p50:.2f} samples/s (times {[round(t, 3) for t in times]})")
    report["pipeline"].update(batch=BATCH, p50_s=p50, samples_per_s=BATCH / p50, times_s=times)


PORT_KERNEL_NAMES = ("gemm_s8_wgmma_kernel", "diffusion_block_kernel",
                     "row_quant_kernel", "row_quant_warp_kernel", "row_op_kernel", "attn_core_", "attn_qkv_core_kernel",
                     "fc2_postln_kernel",
                     "attn_fwd_kernel", "flash_fwd_", "static_qk_quant_kernel", "flash_bwd_")


def profile_call(sample, label="flagship", keep=20):
    """Device time by kernel over one pipeline call ``sample()``
    (torch.profiler, device activity only: host operator events would slow
    the host-bound calls and take minutes to aggregate), and the device's
    idle share of that call's wall time; the ``keep`` kernels by time go to
    the report. Reported only: the profiler is untried on some machines,
    and its absence fails nothing."""
    try:
        from torch.profiler import ProfilerActivity, profile

        t_prof = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sample()
            wall_us = (time.perf_counter() - t0) * 1e6
        from torch.autograd import DeviceType

        by_name = {}
        for e in prof.key_averages():
            # device-side events only: an operator's own entry repeats the
            # time of the kernels it launched
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                by_name[e.key] = by_name.get(e.key, 0.0) + us
    except Exception as e:  # reported, not fatal: see the docstring
        print(f"profiler: not available ({type(e).__name__}: {e})")
        return
    busy = sum(by_name.values())
    ours = {k: v for k, v in by_name.items() if any(n in k for n in PORT_KERNEL_NAMES)}
    print(f"profiled {label} call: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"(idle share {1 - busy / wall_us:.1%}), port kernels {sum(ours.values()) / 1e3:.1f} ms; "
          f"with the profiler's own work {time.perf_counter() - t_prof:.1f} s")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {v / 1e3:9.1f} ms  {k[:100]}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:keep]
    report["profile" if label == "flagship" else f"profile_{label}"] = dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        port_kernels_ms=sum(ours.values()) / 1e3, top={k[:160]: v / 1e3 for k, v in top})


@phase("5b timing of the per-point kernels and paths")
def timing_per_point(pipe_a, pipe_b):
    """Each new kernel at the 2x (CFG steps) and 1x batch of its path; the
    entry of the kernels line is the 2x one. Bounds: each input read once and
    each output written once over the memory rate, or the operations over
    the int8 / bf16 peak, whichever is larger."""
    import torch.nn.functional as F

    gen = torch.Generator(device=DEV).manual_seed(6)
    d, hd, h = PP_D, PP_HD, PP_HEADS
    for mult in (2, 1):
        b = PP_BATCH * mult
        m = b * PP_T
        x, lns, lnb, wq, ws, bias, _ = _proj_operands(gen, (b, PP_T), d, 3 * d)
        row = _time_kernel(
            "fused_ln_int8_matmul", (m, d, 3 * d),
            lambda: fb.fused_ln_int8_matmul(x, lns, lnb, wq, ws, bias),
            lambda: fb.fused_ln_int8_matmul_plain(x, lns, lnb, wq, ws, bias),
            _bound(2 * m * d * 3 * d / PEAK_INT8_OPS,
                   2 * m * d + 2 * m * 3 * d + 3 * d * d + (2 * d + 3 * d) * 2 + 3 * d * 4),
            graph=True)
        plan = fb.store_plan(m, 3 * d, d, fb._sms(torch.device(DEV)), True)
        row.update(block_n=plan["block_n"], waves=plan["waves"],
                   int_mm_ms=_int_mm_ms(gen, (m, d, 3 * d)))
        print(f"    128 x {plan['block_n']} tiles, {plan['waves']:.2f} waves; "
              f"torch._int_mm, its product alone: {row['int_mm_ms']} ms")
        if mult == 2:
            report["kernels"]["fused_ln_int8_matmul"].update(row)
        x, _, _, wq, ws, bias, res = _proj_operands(gen, (b, PP_T), d, d)
        row = _time_kernel(
            "int8_matmul_residual", (m, d, d),
            lambda: fb.int8_matmul_residual(x, res, wq, ws, bias),
            lambda: fb.int8_matmul_residual_plain(x, res, wq, ws, bias),
            _bound(2 * m * d * d / PEAK_INT8_OPS, 3 * 2 * m * d + d * d + d * 2 + d * 4),
            graph=True)
        plan = fb.store_plan(m, d, d, fb._sms(torch.device(DEV)), True)  # bf16 residual
        row.update(block_n=plan["block_n"], waves=plan["waves"],
                   int_mm_ms=_int_mm_ms(gen, (m, d, d)))
        print(f"    the plan's choice: 128 x {plan['block_n']} tiles, {plan['waves']:.2f} waves; "
              f"torch._int_mm, its product alone: {row['int_mm_ms']} ms")
        if mult == 2:
            report["kernels"]["int8_matmul_residual"].update(row)
        del x, res
        q, k, v = _flash_operands(gen, b, h, PP_T, PP_T, hd)
        row = _time_kernel(
            "flash_attention", (b, h, PP_T, hd),
            lambda: fa.flash_attention_with_lse(q, k, v),
            lambda: fa.flash_attention_plain(q, k, v),
            _bound(4 * b * h * PP_T * PP_T * hd / PEAK_BF16_FLOPS,
                   4 * b * h * PP_T * hd * 2 + b * h * PP_T * 4),
            library=lambda: F.scaled_dot_product_attention(q, k, v), graph=True)
        if mult == 2:
            report["kernels"]["flash_attention"].update(row)
        # the same MLP kernel at this path's width (its entry in the kernels
        # line stays the flagship's)
        mlp_ops = _pp_mlp_operands(gen, m)
        kw = _variants("mlp")[0][1]  # static a_ln2 / a_mid, as path B passes them
        row = _time_kernel(
            "fused_ln_int8_mlp", (m, d, PP_F),
            lambda: fb.fused_ln_int8_mlp(*mlp_ops, **kw),
            lambda: fb.fused_ln_int8_mlp_plain(*mlp_ops, **kw),
            _bound(4 * m * d * PP_F / PEAK_INT8_OPS, 2 * m * d * 2 + 2 * d * PP_F), graph=True)
        del q, k, v, mlp_ops
        row["int_mm_ms"] = _int_mm_ms(gen, (m, d, PP_F), (m, PP_F, d))
        print(f"    torch._int_mm, its two products alone: {row['int_mm_ms']} ms")
        torch.cuda.empty_cache()
    _fwd_ptxas("flash_attention")
    fb.reset_launch_counts()
    for label, pipe in (("path_a", pipe_a), ("path_b", pipe_b)):
        if pipe is None:
            raise AssertionError(f"no pipeline: {label} failed")
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            _sample(pipe, seed=20 + i, prompts=PP_PROMPTS)
            times.append(time.perf_counter() - t0)
        p50 = float(np.percentile(times, 50))
        print(f"{label}: batch {PP_BATCH}, {STEPS} steps, p50 {p50:.3f} s per call, "
              f"{PP_BATCH / p50:.2f} samples/s (times {[round(t, 3) for t in times]})")
        report[label].update(batch=PP_BATCH, p50_s=p50, samples_per_s=PP_BATCH / p50,
                             times_s=times)


@phase("5c timing of the t2i kernels and paths")
def timing_t2i(pipe_int8, pipe_float):
    """The MLP and the static attention at L = 1280 (the full phase and the
    decoder half) and 768 (the largest gather bucket), 8 rows each; the
    diffusion block at 200 rows. Bounds: the int8 / bf16 operations over
    their peaks or the bytes (each input read once, each output written
    once) over the memory rate, whichever is larger."""
    import torch.nn.functional as Fn

    gen = torch.Generator(device=DEV).manual_seed(7)
    for L in (T2I_L["full"], 768):
        m = T2I_ROWS * L
        ops = _t2i_mlp_operands(gen, (T2I_ROWS, L))
        kw = _t2i_variants("mlp")[0][1]
        row = _time_kernel(
            "fused_int8_mlp_postln", (m, D, F),
            lambda: fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw),
            lambda: fb.fused_int8_mlp_postln_plain(*ops, ln_eps=1e-5, **kw),
            _bound(4 * m * D * F / PEAK_INT8_OPS,
                   2 * m * D * 4 + 2 * D * F + (F + 3 * D) * 2 + (F + D) * 4), graph=True)
        fc2 = fb.mlp_postln_plan(m, D, F, fb._sms(torch.device(DEV)),
                                 fb._clusters(torch.device(DEV), D // 256))["fc2"]
        _print_floors("fused_int8_mlp_postln", row, *_postln_floors(m, 4),
                      f"; fc2: {fc2['m_tiles']} m-tiles over {fc2['clusters']} clusters of "
                      f"{fc2['cluster']}, {fc2['waves']:.2f} waves")
        row["fc2_waves"] = fc2["waves"]
        if L == T2I_L["full"]:
            report["kernels"]["fused_int8_mlp_postln"].update(row)
        del ops
        q, k, v, _ = _static_attention_operands(gen, L, "none")
        smax = torch.tensor(9.0, device=DEV)
        bh = T2I_ROWS * HEADS
        row = _time_kernel(
            "flash_attention_static", (T2I_ROWS, HEADS, L, 64),
            lambda: fa.flash_attention_static(q, k, v, smax),
            lambda: fa.flash_attention_static_plain(q, k, v, smax),
            _bound(4 * bh * L * L * 64 / PEAK_BF16_FLOPS, 4 * bh * L * 64 * 2),
            library=lambda: Fn.scaled_dot_product_attention(q, k, v), graph=True)
        if L == T2I_L["full"]:
            report["kernels"]["flash_attention_static"].update(row)
            # the int8 score core (driven since 4y: bench.py --attn-core
            # int8): the quant pass and the kernel; q k^T's operations at
            # the int8 rate
            aq = torch.tensor(4.5, device=DEV)
            _instance("flash_attention_static", "int8 hd 64", _time_kernel(
                "flash_attention_static", (T2I_ROWS, HEADS, L, 64, "int8 core"),
                lambda: fa.flash_attention_static(q, k, v, smax, a_q=aq, a_k=aq),
                lambda: fa.flash_attention_static_plain(q, k, v, smax, a_q=aq, a_k=aq),
                _bound(2 * bh * L * L * 64 / PEAK_INT8_OPS + 2 * bh * L * L * 64 / PEAK_BF16_FLOPS,
                       4 * bh * L * 64 * 2), graph=True))
        del q, k, v
        for n in (3 * D, D):  # qkv (f32 x), the out-projection (bf16 x)
            x, w, ws, b = _linear_operands(gen, m, n)
            row = _time_kernel(
                "int8_linear", (m, D, n),
                lambda: fb.int8_linear(x, w, ws, b, torch.bfloat16),
                lambda: fb.int8_linear_plain(x, w, ws, b, torch.bfloat16),
                _bound(2 * m * D * n / PEAK_INT8_OPS,
                       m * D * x.element_size() + m * n * 2 + n * D + n * 2 + n * 4),
                graph=True)
            plan = fb.store_plan(m, n, D, fb._sms(torch.device(DEV)), True)
            row.update(block_n=plan["block_n"], waves=plan["waves"],
                       int_mm_ms=_int_mm_ms(gen, (m, D, n)))
            print(f"    128 x {plan['block_n']} tiles, {plan['waves']:.2f} waves; "
                  f"torch._int_mm, its product alone: {row['int_mm_ms']} ms")
            if L == T2I_L["full"] and n == 3 * D:
                report["kernels"]["int8_linear"].update(row)
            del x
    m = T2I_ROWS * T2I_PAD_P
    ops = _diffusion_operands(gen, m)
    kw = _t2i_variants("diffusion")[0][1]
    row = _time_kernel(
        "fused_int8_diffusion_block", (m, D),
        lambda: fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw),
        lambda: fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5, **kw),
        _bound(2 * m * D * 5 * D / PEAK_INT8_OPS,
               3 * m * D * 2 + 5 * D * D + (3 * D + 4 * D) * 2 + 5 * D * 4), iters=200,
        graph=True)
    report["kernels"]["fused_int8_diffusion_block"].update(row)
    _fwd_ptxas("flash_attention_static")
    torch.cuda.empty_cache()
    fb.reset_launch_counts()
    for label, pipe in (("t2i_int8", pipe_int8), ("t2i_float", pipe_float)):
        if pipe is None:
            raise AssertionError(f"no pipeline: {label} failed")
        times = []
        for i in range(T2I_TIMED_CALLS):
            t0 = time.perf_counter()
            _t2i_sample(pipe, seed=20 + i)
            times.append(time.perf_counter() - t0)
        p50 = float(np.percentile(times, 50))
        print(f"{label}: batch {T2I_BATCH}, {T2I_AR} AR x {T2I_DIFF} diffusion steps, p50 "
              f"{p50:.3f} s per call, {T2I_BATCH / p50:.3f} samples/s "
              f"(times {[round(t, 3) for t in times]})")
        report[label].update(batch=T2I_BATCH, p50_s=p50, samples_per_s=T2I_BATCH / p50,
                             times_s=times)


def _kernels_per_call(groups, calls=10):
    """The device kernels of ``calls`` calls of each ``(name, call,
    expected)`` in ``groups`` (kernel ``name`` at its path's shape), from one
    torch.profiler trace (each trace costs seconds of set-up): each
    ``expected`` kernel-name substring once a call of every group that names
    it, and nothing else (outputs and workspaces come from torch.empty, which
    launches nothing); raises otherwise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _, call, _ in groups:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _, call, _ in groups:
            for _ in range(calls):
                call()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA and not e.key.startswith("Mem"):
            kernels[e.key] = kernels.get(e.key, 0) + e.count
    n = sum(kernels.values())
    names = [name for name, _, _ in groups]
    print(f"{' + '.join(names)}: {n} device kernels in {calls} calls each: {kernels}")
    wants = [want for _, _, expected in groups for want in expected]
    for name, _, expected in groups:
        report["kernels"].setdefault(name, {})["device_kernels_per_call"] = len(expected)
    each = {want: sum(c for k, c in kernels.items() if want in k) for want in wants}
    if n != len(wants) * calls or any(each[w] != calls * wants.count(w) for w in each):
        raise AssertionError(f"{names} ran {n} device kernels in {calls} calls each "
                             f"({kernels}), not {wants} once a call")


def _device_kernels_per_call():
    """Row 6's one kernel a call (head's 200 rows); the three of a static
    call of rows 1 (the flagship's 1x batch: LN pass, QKV + core,
    out-projection) and 5 (8 x 1280 rows: x quant pass, fc1, fc2 + post-LN);
    the two of row 3 (path B's 2x batch: the LN pass, the wgmma GEMM with
    its TMA-store epilogue) and of row 4 (the same batch: the row pass
    without LayerNorm, the wgmma GEMM with the residual epilogue) in row
    1's trace and of int8_linear (8 x 1280
    rows, qkv: the row pass, the wgmma GEMM) in row 5's."""
    gen = torch.Generator(device=DEV).manual_seed(8)
    ops = _diffusion_operands(gen, T2I_ROWS * T2I_PAD_P)
    kw = _t2i_variants("diffusion")[0][1]
    _kernels_per_call([("fused_int8_diffusion_block",
                        lambda: fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw),
                        ("diffusion_block_kernel",))])
    ops1 = _kernel_operands(gen, BATCH, "attention")
    kw1 = _variants("attention")[0][1]
    x3, lns, lnb, wq, ws3, b3, _ = _proj_operands(gen, (2 * PP_BATCH, PP_T), PP_D, 3 * PP_D)
    x4, _, _, wq4, ws4, b4, r4 = _proj_operands(gen, (2 * PP_BATCH, PP_T), PP_D, PP_D)
    _kernels_per_call([
        ("fused_attention_block", lambda: fb.fused_attention_block(*ops1, **kw1),
         ("row_quant_kernel", "attn_qkv_core_kernel", "gemm_s8_wgmma_kernel<3,")),
        ("fused_ln_int8_matmul", lambda: fb.fused_ln_int8_matmul(x3, lns, lnb, wq, ws3, b3),
         ("row_quant_kernel", "gemm_s8_wgmma_kernel<0,")),
        ("int8_matmul_residual", lambda: fb.int8_matmul_residual(x4, r4, wq4, ws4, b4),
         ("row_quant_warp_kernel", "gemm_s8_wgmma_kernel<3,"))])
    del ops1, x3, x4, r4
    ops5 = _t2i_mlp_operands(gen, (T2I_ROWS, T2I_L["full"]))
    kw5 = _t2i_variants("mlp")[0][1]
    x, w, ws, b = _linear_operands(gen, T2I_ROWS * T2I_L["full"], 3 * D)
    _kernels_per_call([
        ("fused_int8_mlp_postln", lambda: fb.fused_int8_mlp_postln(*ops5, ln_eps=1e-5, **kw5),
         ("row_quant_warp_kernel", "gemm_s8_wgmma_kernel<4,", "fc2_postln_kernel")),
        ("int8_linear", lambda: fb.int8_linear(x, w, ws, b, torch.bfloat16),
         ("row_quant_warp_kernel", "gemm_s8_wgmma_kernel<8,"))])
    del ops5, x
    torch.cuda.empty_cache()


def _row1_split_profile():
    """Device time by kernel of 10 calls of row 1's split route at 4v's 2x
    batch, (256, 256, 1024), the flagship variant: the LN pass, the QKV
    product writing the bf16 qkv, attn_core_bf16_kernel reading it, the
    out-projection."""
    t, d, heads, f = ROW1_NEW["points_4096"]
    ops = _kernel_operands(torch.Generator(device=DEV).manual_seed(1820), 2 * BATCH,
                           "attention", t, d, f)
    kw = _variants("attention", heads)[0][1]

    def calls():
        for _ in range(10):
            fb.fused_attention_block(*ops, **kw)
        torch.cuda.synchronize()

    calls()
    profile_call(calls, "row1_split_10_calls", keep=10)
    del ops
    fb.reset_launch_counts()


@phase("6 profiles")
def profiles(pipe, pipe_a, pipe_b, pipe_t2i, pipe_train, pc_pipes=None, pipe_ar=None,
             pipe_t2v=None, vaes=None, pipe_xlpc=None):
    """One profiled call of each path (one step of training), after every
    timing: the profiler's hooks stay on the launch path once it has run,
    and would slow the host side of the per-launch timings. First, the
    device kernels of 10 calls of rows 6 (gated at 10), 1 and 5 (at 30),
    int8_linear, rows 3 and 4 (at 20). Last, one t2v decode (the bench VAE,
    2 windows) and the share of its device time in channels-last (NHWC /
    NDHWC) convolution kernels and in layout conversions."""
    _device_kernels_per_call()
    if pipe is not None:
        profile_call(lambda: _sample(pipe, seed=30))
    if pipe_xlpc is not None:  # 4u's call: row 1 at head dim 96
        profile_call(lambda: _sample(pipe_xlpc, seed=30), "pc_d48w1536")
    _row1_split_profile()
    for label, p in (("path_a", pipe_a), ("path_b", pipe_b)):
        if p is not None:
            profile_call(lambda: _sample(p, seed=30, prompts=PP_PROMPTS), label)
    if pipe_t2i is not None:
        profile_call(lambda: _t2i_sample(pipe_t2i, ar_steps=T2I_PROFILE_AR, seed=30), "t2i_int8")
    if pipe_train is not None:
        data = itertools.repeat(_train_batch(5))

        def step():
            pipe_train.train(data, pipe_train.trainer.step + 1)
            torch.cuda.synchronize()

        profile_call(step, "t2i_train")
    for label, p in zip(("t2pc_train", "t2pc_train_dropout0"), pc_pipes or ()):
        norm = p.normalizer
        pc_data = itertools.repeat(p.encode_batch(_pc_batch(norm, 20)))

        def pc_step(p=p, pc_data=pc_data):
            p.trainer.train(pc_data, p.trainer.step + 1)
            torch.cuda.synchronize()

        profile_call(pc_step, label)
    if pipe_ar is not None:
        profile_call(lambda: _ar_sample(pipe_ar, ar_steps=AR_PROFILE_STEPS, seed=30),
                     "masked_ar_int8")
    if pipe_t2v is not None:
        profile_call(lambda: _t2v_sample(pipe_t2v, T2V_PROFILE_FRAMES, T2V_PROFILE_AR, seed=30),
                     "t2v_int8")
    if vaes is not None:
        proc = VaeImageProcessor(vaes[1])
        z = _decode_latents(torch.Generator(device=DEV).manual_seed(34))[1]

        def decode():
            with torch.no_grad():
                proc.decode_latents(z)
            torch.cuda.synchronize()

        profile_call(decode, "t2v_decode", keep=30)
        by_name = report.get("profile_t2v_decode", {}).get("top", {})
        busy = sum(by_name.values()) or 1.0
        # each kernel in the first group whose name holds one of its words
        groups = {"layout conversions (nchwToNhwc / nhwcToNchw)": ("tonhwc", "tonchw"),
                  "channels-last kernels (nhwc / ndhwc in the name)": ("nhwc", "ndhwc"),
                  "channels-first kernels (nchw / ncdhw in the name)": ("nchw", "ncdhw")}
        left, layouts = dict(by_name), {}
        for what, keys in groups.items():
            hits = [k for k in left if any(x in k.lower() for x in keys)]
            layouts[what] = sum(left.pop(k) for k in hits)
            print(f"  t2v decode, {what}: {layouts[what]:.1f} ms of {busy:.1f} ms in the top 30 "
                  f"({layouts[what] / busy:.1%})")
        report.setdefault("profile_t2v_decode", {})["layouts_ms"] = layouts


@phase("7 where the released 1024px call's time goes")
def released_profile():
    """The model of 4p (RELEASED_MODEL) with seeded random bf16 weights
    behind NOVAPipeline; one prompt of random embeddings at 64 AR x 25
    steps, CFG 5.0, latent output: two calls' walls (host clock around a
    call ending in a synchronize); one masking-phase image-encoder pass (2
    rows x 4096 tokens, half visible, on the video states) and one head
    eval on 2 x 100 tokens by CUDA events (_event_ms), 25 head evals by the
    host clock; one call under torch.profiler (profile_call)."""
    gen = torch.Generator(device=DEV).manual_seed(50)
    model = build_transformer(RELEASED_MODEL, dtype=torch.bfloat16, device=DEV)
    model.init_weights(gen).fill_zero_init(gen)
    pipe = NOVAPipeline(model.to(torch.bfloat16), FlowMatchEulerScheduler())
    emb = torch.randn((1, RELEASED_TEXT, PhiConfig().hidden_size),
                      generator=torch.Generator().manual_seed(1)).numpy()
    kw = dict(prompt_embeds=emb, num_diffusion_steps=RELEASED_DIFF,
              guidance_scale=RELEASED_GUIDANCE)
    pipe(num_inference_steps=4, **kw)  # warm-up
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe(num_inference_steps=RELEASED_AR, **kw)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"latent calls at {RELEASED_AR} AR: {walls} s")
    with torch.no_grad():
        c = pipe.encode_prompt(None, prompt_embeds=emb,
                               guidance=GuidanceConfig(guidance_scale=RELEASED_GUIDANCE))
        cond = model.encode_video(model.bos_frame(2), c, 1)
        tokens = torch.randn((2, RELEASED_NI, 1024), device=DEV, dtype=torch.bfloat16,
                             generator=gen)
        mask = (torch.rand((2, RELEASED_NI, 1), device=DEV, generator=gen) < 0.5).float()
        x = torch.randn((2, 100, 16), device=DEV, generator=gen)
        t = torch.full((2,), 500.0, device=DEV)
        encoder_ms = _event_ms(lambda: model.encode_image_step(tokens, mask, cond))
        z = model.encode_image_step(tokens, mask, cond)[:, :100]
        head_ms = _event_ms(lambda: model.denoise_step(x, t, z))
        t0 = time.perf_counter()
        for _ in range(RELEASED_DIFF):
            model.denoise_step(x, t, z)
        torch.cuda.synchronize()
        heads_ms = 1e3 * (time.perf_counter() - t0)
    print(f"one masking-phase image-encoder pass {encoder_ms} ms, one head eval on 2 x 100 "
          f"tokens {head_ms} ms (events); {RELEASED_DIFF} head evals {heads_ms:.1f} ms (host)")
    report["released_profile"] = dict(call_walls_s=walls, encoder_pass_ms=encoder_ms,
                                      head_eval_ms=head_ms, head_evals_25_host_ms=heads_ms)
    profile_call(lambda: (pipe(num_inference_steps=RELEASED_AR, **kw), torch.cuda.synchronize()),
                 "released_1024px", keep=30)
    report["released_profile"]["profile"] = report.get("profile_released_1024px")
    del pipe, model


def main():
    import argparse

    ap = argparse.ArgumentParser(description="Smoke run of the port on one GPU.")
    ap.add_argument("--profile", choices=["released_1024px"], default=None,
                    help="run only this profile target after the build")
    args = ap.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        _fail("CUDA is not available: this script runs on the GPU only", 2)
    if _PORT_IMPORT_ERROR is not None:
        _fail(f"the port package is not importable ({_PORT_IMPORT_ERROR}): "
              f"run from the root of the repository", 3)
    device_info()
    build()
    if args.profile is not None:
        if "2 build" not in failures:
            released_profile()
        if failures:
            print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
            sys.exit(1)
        print(f"card (nvidia-smi name, power limit): {report['device']['smi']}")
        print(json.dumps(report["released_profile"], default=str))
        return
    if "2 build" not in failures:
        check_kernels()
        check_split_kernels()
        check_flash()
        check_nova_kernels()
        check_flash_backward()
        check_ar_kernels()
        check_t2v_kernels()
        pipe = main_path()
        pipe_a = path_a()
        pipe_b = path_b()
        pipe_t2i = t2i_int8()
        pipe_t2i_f = t2i_float(pipe_t2i)
        pipe_train = t2i_train()
        timing(pipe)
        timing_per_point(pipe_a, pipe_b)
        timing_t2i(pipe_t2i, pipe_t2i_f)
        timing_train(pipe_train)
        # after the other paths' timings, so its models stay out of their
        # peak-memory readings
        pc_state = pc_train()
        pc_pipes = timing_pc_train(pc_state)
        # the point-cloud AR modes, after the earlier paths' timings
        ar_pipes = ar_serving() or (None, None)
        pipe_refine = refinement(pipe)
        ar_state = ar_train()
        timing_ar(*ar_pipes, pipe_refine, ar_state)
        # NOVA t2v serving, after the earlier paths' timings
        pipe_t2v = t2v_int8()
        pipe_t2v_f = t2v_float(pipe_t2v)
        # the VAEs and the e2e calls, after the t2v paths
        vae_card_vs_cpu()
        vaes = e2e(pipe_t2i, pipe_t2v)
        timing_t2v(pipe_t2v, pipe_t2v_f)
        timing_decode(vaes, pipe_t2v)
        # the Phi encoder, the released 1024px config and c2i, after the decode
        t_7c = time.perf_counter()
        emb = phi_encoder()
        released_1024(emb)
        c2i_int8(vaes[0] if vaes else None)
        report["slice_7c_s"] = time.perf_counter() - t_7c
        print(f"phases 4o-4q took {report['slice_7c_s']:.1f} s (budget 120 s)")
        # head dim 96: the NOVA-1.4B 1024px config served and trained
        t_xl = time.perf_counter()
        xl_written = released_1p4b(emb)
        xl_int8(emb, xl_written)
        xl_train()
        report["hd96_4rt_s"] = time.perf_counter() - t_xl
        print(f"phases 4r-4t took {report['hd96_4rt_s']:.1f} s; with the head-dim-96 checks of "
              f"3c-3e {report['hd96_4rt_s'] + report.get('hd96_3ce_s', 0.0):.1f} s (budget "
              f"180 s)")
        # head dim 96 in f32 and on the int8 score core: from_pretrained's
        # default dtype, the step's f32 twin, attn_core="int8"
        t_new = time.perf_counter()
        released_1p4b_f32(emb, xl_written)
        shutil.rmtree(XL_DIR, ignore_errors=True)
        xl_train_f32()
        int8_core_serving(emb, xl_written)
        del xl_written
        report["hd96_new_4wy_s"] = time.perf_counter() - t_new
        new_s = report["hd96_new_4wy_s"] + report.get("hd96_new_3ce_s", 0.0)
        print(f"phases 4w-4y took {report['hd96_new_4wy_s']:.1f} s; with their checks and "
              f"timings in 3c-3e {new_s:.1f} s (budget 150 s)")
        # row 1 at head dim 96 and T = 256: bench.py --arch pc_d48w1536 and
        # --points 4096
        t_row1 = time.perf_counter()
        check_row1_shapes()
        pipe_xlpc = xlpc_serving()
        points4096_serving()
        timing_row1_shapes()
        report["row1_3h_5i_s"] = time.perf_counter() - t_row1
        print(f"phases 3h, 4u, 4v, 5i took {report['row1_3h_5i_s']:.1f} s (budget 90 s)")
        profiles(pipe, pipe_a, pipe_b, pipe_t2i, pipe_train, pc_pipes, ar_pipes[0], pipe_t2v,
                 vaes, pipe_xlpc)
    kernels = []
    for name in KERNELS:
        k = report["kernels"].get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": k.get("launches"),
                        "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                        "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                        "bound_by": k.get("bound_by"), "library_ms": k.get("library_ms"),
                        "launches_by_path": k.get("launches_by_path"),
                        "instances": {label: {key: inst.get(key) for key in
                                              ("launches", "ms", "graph_ms", "plain_ms",
                                               "bound_ms", "bound_by", "library_ms")}
                                      for label, inst in k.get("instances", {}).items()}})
        missing = [key for key, val in kernels[-1].items()
                   if val is None and key != "library_ms"]
        missing += [f"{label} {key}" for label, inst in kernels[-1]["instances"].items()
                    for key, val in inst.items()
                    if val is None and key not in ("library_ms", "graph_ms")]
        if missing or not kernels[-1]["launches"]:
            failures.append(f"kernels line: {name} lacks {missing or 'launches'}")
    total_s = time.perf_counter() - t_start
    print(f"chip_smoke: all phases took {total_s:.1f} s")
    report["total_s"] = total_s
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        sys.exit(1)
    # again beside the results, so the end of the output names the card
    print(f"card (nvidia-smi name, power limit): {report['device']['smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
    shapes: fused_int8_mlp_postln (static / per row, 8 x 288 and 8 x 1280
    rows, f32 and bf16 residual streams), fused_int8_diffusion_block
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
    t2i paths' samples/s (p50 of 3 calls, batch 4);
6.  (in the profiles phase) one profiled t2i int8 call.

The NOVA t2i training slice adds:

3e. the flash backward kernels against their plain version at the training
    shape (8, 16, 1280, 64), bf16 (prep, the one-pass dkvq kernel on wgmma
    and TMA, cast) and f32 (prep, the SIMT dK/dV and dQ kernels): no bias; a
    key bias with -inf keys and a fully masked sample (its gradients exactly
    0); a full bias; a ragged Lq != Lk; the prep and cast kernels exactly
    equal to their plain versions; two bf16 backward runs on the same
    tensors: dk and dv bitwise equal (a gate), max |dq1 - dq2| printed (the
    atomic f32 dQ sums run in no fixed order);
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
    flash_attention_dkv, 16 flash_attention_dq, 32 flash_attention), finite
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
    route's dK/dV and dQ, their plain version, the SDPA backward (from a
    graph built once) beside the port's whole backward through autograd and
    the kernels' sum, the bounds, and the whole backward's joint bound (10
    BH Lq Lk d FLOPs) with the dkvq kernel's ptxas registers and spills;
    the training step (p50 of 5 after 2 warm-ups),
    samples/s, peak memory, the step's FLOPs (FlopCounterMode for the
    library ops, the flash kernels' counted from their shapes) and TFLOP/s;
6.  (in the profiles phase) one profiled training step.

The line before the last is a JSON object with one entry per kernel; the
last line is the result object. Details go to build/chip_smoke.json.
"""

import itertools
import json
import os
import subprocess
import sys
import time
import traceback

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
                      "flash_attention_dkv": TRAIN_FLASH_LAYERS,
                      "flash_attention_dq": TRAIN_FLASH_LAYERS,
                      "flash_attention": 2 * TRAIN_FLASH_LAYERS}
KERNELS = ("fused_attention_block", "fused_ln_int8_mlp", "fused_ln_int8_matmul",
           "int8_matmul_residual", "flash_attention", "fused_int8_mlp_postln",
           "fused_int8_diffusion_block", "flash_attention_static", "int8_linear",
           "flash_attention_dkv", "flash_attention_dq", "flash_attention_bwd_prep",
           "flash_attention_bwd_dkvq", "flash_attention_bwd_dq_cast")
SOURCES = {n: f"nova_pointcloud_tpu_torch/csrc/{n}.cu" for n in KERNELS}
BWD_SOURCE_KERNELS = ("flash_attention_dkv", "flash_attention_dq", "flash_attention_bwd_prep",
                      "flash_attention_bwd_dkvq", "flash_attention_bwd_dq_cast")
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
            # the f32 route of the two backward kernels
            "flash_attention_dkv": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:297",
            "flash_attention_dq": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:346",
            # _flash_bwd's delta (XLA, line 261) and lse rows
            "flash_attention_bwd_prep": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:254",
            # the bf16 dK/dV kernel, and the dQ kernel's products (one pass)
            "flash_attention_bwd_dkvq": "nova_pointcloud_tpu/ops/pallas/flash_attention.py:297",
            # the dQ kernel's output
            "flash_attention_bwd_dq_cast":
                "nova_pointcloud_tpu/ops/pallas/flash_attention.py:346"}
OUT_DIR = "build"
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


def _kernel_operands(gen, rows_or_batch, kind):
    """Random operands at flagship widths: bf16 activations, int8 weights
    quantized per channel from N(0, 1/fan_in) in the K-major layout the
    serving path pre-quantizes to, bf16 LN params and biases."""
    dev = DEV

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    if kind == "attention":
        x = randn(rows_or_batch, T, D).to(torch.bfloat16)
        w1, s1 = quantize_weight_kmajor(randn(3 * D, D, std=D ** -0.5))
        w2, s2 = quantize_weight_kmajor(randn(D, D, std=D ** -0.5))
        b1, b2 = randn(3 * D, std=0.02), randn(D, std=0.02)
    else:
        x = randn(rows_or_batch, D).to(torch.bfloat16)
        w1, s1 = quantize_weight_kmajor(randn(F, D, std=D ** -0.5))
        w2, s2 = quantize_weight_kmajor(randn(D, F, std=F ** -0.5))
        b1, b2 = randn(F, std=0.02), randn(D, std=0.02)
    lns = (1.0 + randn(D, std=0.1)).to(torch.bfloat16)
    lnb = randn(D, std=0.1).to(torch.bfloat16)
    return [x, lns, lnb, w1, s1, b1.to(torch.bfloat16), w2, s2, b2.to(torch.bfloat16)]


def _variants(kind):
    s = lambda v: torch.tensor(v, device=DEV)  # noqa: E731
    if kind == "attention":
        out = []
        for core in ("bf16", "f32", "int8"):
            for static in (True, False):
                for smax in (True, False):
                    kw = dict(num_heads=HEADS, core=core)
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
    <= 2^-10 mean|y| pass; a wrong fragment, scale or bias fails both."""
    gen = torch.Generator(device=DEV).manual_seed(1234)
    bad = []
    for name, (kind, kernel, plain) in _kernels().items():
        # every variant at the CFG steps' 2x batch, the flagship variant
        # (the first) also at the 1x batch of the steps after truncation
        cases = [(FLAGSHIP_SHAPE[kind], v) for v in _variants(kind)]
        cases.append((FLAGSHIP_SHAPE[kind] // 2, _variants(kind)[0]))
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
             ("none", 2, H, 1000, 1531, 64, f32),
             ("dead", 2, H, 515, 1000, 64, f32), ("full", 2, H, 515, 1000, 64, f32)]
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
        if not _tol_check(_bwd_kernel(name, torch.bfloat16),
                          f"{name} strided (B, L, H, D) view", g, r, 2.0 ** -6,
                          2.0 ** -8, like=r):
            bad.append(f"strided backward {name}")
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


def _make_pipeline():
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = NOVAPointCloudTransformer(
        arch=ARCH, point_cloud_size=POINTS, patch_size=PATCH, text_token_dim=256,
        quantize=True, attn_core="bf16", dtype=torch.bfloat16, device=DEV)
    model.init_weights(gen)
    with torch.no_grad():  # a non-zero head, so the cloud depends on every block
        model.output_proj.weight.copy_(
            torch.randn(model.output_proj.weight.shape, generator=gen, device=DEV) * 0.02)
    model = model.to(torch.bfloat16)  # serving: bf16 weights, as the JAX bench
    n_params = sum(p.numel() for p in model.parameters())
    print(f"{ARCH}: {n_params / 1e6:.1f}M parameters, T={T} tokens, batch {BATCH}")
    pipe = NOVAPointCloudGenerationPipeline(
        model, DDPMScheduler(beta_schedule="squaredcos_cap_v2"),
        text_encoder=DummyTextEncoder(256, 32))
    return pipe


PROMPTS = [f"a chair {i}" for i in range(BATCH)]


PP_PROMPTS = PROMPTS[:PP_BATCH]


def _sample(pipe, seed=1, prompts=None, **kw):
    out = pipe(prompts or PROMPTS, num_points=POINTS, num_diffusion_steps=STEPS,
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

    # one forward of the 48-layer stack at the first (CFG) step, same inputs
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
    print(f"one forward ({DEPTH} layers, batch {2 * BATCH}), kernels vs plain: mean |diff| / "
          f"mean |pred| {rel:.3e} (tol 2 x floor + 1e-3 = {fwd_tol:.3e}; floor, kernels vs "
          f"kernels with inputs moved by 1e-6: {rel_floor:.3e}): {'ok' if fwd_ok else 'FAIL'}")
    report["pipeline"].update(launches=launches, plain_launches=plain_launches,
                              mean_abs_vs_plain=vs_plain, floor_mean_abs=floor,
                              mean_abs_int8_vs_float=int8_vs_float,
                              forward_rel_err=rel, forward_rel_floor=rel_floor,
                              output_ok=ok)
    if not (ok and agree and fwd_ok and counts_ok and not any(plain_launches.values())):
        raise AssertionError("main path check failed")
    return pipe


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


def _t2i_mlp_operands(gen, lead, x_dtype=torch.float32):
    """fused_int8_mlp_postln at the ViT's width: x (*lead, 1024) (the image
    encoder's residual stream is f32: flax promotes the bf16 weights' output
    against the f32 canvas), W1 (1024, 4096), W2 (4096, 1024), bf16 vectors."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * std

    bf16 = torch.bfloat16
    x = randn(*lead, D).to(x_dtype)
    w1, s1 = quantize_weight_kmajor(randn(F, D, std=D ** -0.5))
    w2, s2 = quantize_weight_kmajor(randn(D, F, std=F ** -0.5))
    return [x, w1, s1, randn(F, std=0.02).to(bf16), w2, s2, randn(D, std=0.02).to(bf16),
            (1.0 + randn(D, std=0.1)).to(bf16), randn(D, std=0.1).to(bf16)]


def _diffusion_operands(gen, m):
    """fused_int8_diffusion_block at the head's width: x, zc (m, 1024) bf16,
    Ws (1024, 3072), W1, W2 (1024, 1024), bf16 vectors; the stats bias is
    wide enough that scale / shift / gate are far from 0 / 0 / 0."""
    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=DEV) * std

    bf16 = torch.bfloat16
    ws, ss = quantize_weight_kmajor(randn(3 * D, D, std=D ** -0.5))
    w1, s1 = quantize_weight_kmajor(randn(D, D, std=D ** -0.5))
    w2, s2 = quantize_weight_kmajor(randn(D, D, std=D ** -0.5))
    return [randn(m, D).to(bf16), randn(m, D).to(bf16), ws, ss, randn(3 * D, std=0.3).to(bf16),
            w1, s1, randn(D, std=0.02).to(bf16), w2, s2, randn(D, std=0.02).to(bf16),
            (1.0 + randn(D, std=0.1)).to(bf16), randn(D, std=0.1).to(bf16)]


def _static_attention_operands(gen, L, bias_kind, rows=T2I_ROWS):
    """q, k, v as the ViT hands them over: (B, H, L, 64) views of one (B, L,
    3, H, 64) bf16 projection; a visibility bias masks ~40% of the keys
    after a 256-key prefix, and every key of sample 1 (a fully masked row)."""
    qkv = torch.randn((rows, L, 3, HEADS, 64), generator=gen, device=DEV).to(torch.bfloat16)
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
    for L in (T2I_L["video"], T2I_L["full"]):
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
    for m in (T2I_ROWS * T2I_PAD_P, 77):
        ops = _diffusion_operands(gen, m)
        for label, kw in _t2i_variants("diffusion"):
            y = fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw)
            torch.cuda.synchronize()
            ref = fb.fused_int8_diffusion_block_plain(*ops, n2_eps=1e-5, **kw)
            if not _tol_check("fused_int8_diffusion_block", f"{label} rows={m}", y, ref,
                              like=ops[0]):
                bad.append(f"diffusion {label} {m}")
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
    for n in (3 * D, D):  # the qkv and out projections, f32 residual in, bf16 out
        x = torch.randn((T2I_ROWS, T2I_L["full"], D), generator=gen, device=DEV)
        w, ws = quantize_weight_kmajor(
            torch.randn((n, D), generator=gen, device=DEV) * D ** -0.5)
        b = (torch.randn((n,), generator=gen, device=DEV) * 0.1).to(torch.bfloat16)
        y = fb.int8_linear(x, w, ws, b, torch.bfloat16)
        torch.cuda.synchronize()
        if not _tol_check("int8_linear", f"{D}->{n}", y, fb.int8_linear_plain(
                x, w, ws, b, torch.bfloat16)):
            bad.append(f"int8_linear {n}")
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    fb.reset_launch_counts()


def _make_t2i_pipeline(quantize, state_dict=None):
    """bench.py --mode t2i's model at full width and depth, seeded random
    weights with the zero-initialised AdaLN projections (and the biases)
    filled, so every diffusion block's gate and modulation depend on its
    inputs; bf16 weights and compute dtype, as the bench serves."""
    gen = torch.Generator(device=DEV).manual_seed(0)
    model = NOVATransformer(arch=T2I_ARCH, image_dim=4, image_base_size=T2I_BASE,
                            video_base_size=T2I_VIDEO_BASE, patch_size=2, text_token_dim=256,
                            text_token_len=32, quantize=quantize, attn_core="bf16",
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


def _t2i_step_check(pipe, label, kernel, expected):
    """One image-encoder pass of the masking phase (half the tokens visible,
    256 + 1024 keys: every layer on the path's attention kernel) and one
    diffusion-head eval, kernels against plain, relative mean error gated at
    2 x floor + 1e-3 (floor: kernels against kernels with the canvas and
    x_t moved by 1e-6); ``expected`` launches of ``kernel`` in the pass."""
    from nova_pointcloud_tpu_torch.models.guidance import GuidanceConfig

    model, qp = pipe.model, pipe.serving_qparams()
    gen = torch.Generator(device=DEV).manual_seed(11)
    ni, pd = model.num_image_tokens, model.patch_dim
    with torch.no_grad():
        c = pipe.encode_prompt(T2I_PROMPTS, guidance=GuidanceConfig(guidance_scale=T2I_GUIDANCE))
        cond = model.encode_video(model.bos_frame(T2I_ROWS), c, 1, qparams=qp)
        canvas = torch.randn((T2I_BATCH, ni, pd), generator=gen, device=DEV)
        mask = (torch.rand((T2I_BATCH, ni, 1), generator=gen, device=DEV) < 0.5).float()
        x_t = torch.randn((T2I_ROWS, T2I_PAD_P, pd), generator=gen, device=DEV)
        t = torch.full((T2I_ROWS,), 500.0, device=DEV)

        def step(cv, xt):
            z = model.encode_image_step(model.tokens_from_patches(cv).repeat(2, 1, 1),
                                        mask.repeat(2, 1, 1), cond, qparams=qp)
            zs = z[:, :T2I_PAD_P]
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
        good = bool(torch.isfinite(a).all()) and rel <= 2 * floor + 1e-3
        ok = ok and good
        print(f"{label} one {name}, kernels vs plain: mean |diff| / mean |plain| {rel:.3e} "
              f"(tol 2 x floor + 1e-3 = {2 * floor + 1e-3:.3e}; floor, inputs moved by 1e-6: "
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


def _flash_route_launches(pipe):
    """flash_attention launches of one float call by the dispatcher's rule
    (ops/attention.flash_route): per image-encoder pass, the decoder half
    sees all 256 + 1024 keys; the encoder half sees 256 + its visible bucket
    (128, 256, 512) in the gather phases and 1280 in the masking phase; the
    video encoder sees 288. Each layer with >= 1024 keys launches once."""
    from nova_pointcloud_tpu_torch.ops.attention import flash_route
    from nova_pointcloud_tpu_torch.pipelines.nova import bucket_plan

    _, counts, starts, _ = pipe._schedule(T2I_AR, T2I_DIFF)
    ni = pipe.model.num_image_tokens
    half = T2I_VIT_LAYERS // 2
    n = T2I_V_LAYERS * flash_route(T2I_L["video"], T2I_L["video"], 64, None, "auto", True)
    for s_b, s_e, bucket in bucket_plan(starts, ni):
        lk = 256 + (ni if bucket is None else bucket)
        bias = (T2I_ROWS, 1, 1, lk)
        enc = flash_route(lk, lk, 64, bias, "auto", True)
        dec = flash_route(T2I_L["full"], T2I_L["full"], 64, None, "auto", True)
        n += (s_e - s_b) * half * (int(enc) + int(dec))
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


def _bwd_kernel(grad, dt):
    """The kernel a gradient of the backward is held against: the bf16
    route's one-pass kernel, or the f32 route's dK/dV or dQ kernel."""
    if dt == torch.bfloat16:
        return "flash_attention_bwd_dkvq"
    return "flash_attention_dq" if grad == "dq" else "flash_attention_dkv"


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
        ok = _tol_check(_bwd_kernel(name, dt), f"{name} {label}", g, r, *rel, like=r) and ok
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
    """Two backward runs on the same tensors: dk and dv bitwise equal (a
    gate: each block writes them once); dq's largest difference printed (a
    reading: the f32 atomic sums of dQ run in no fixed order)."""
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o = fa.flash_attention(*ins)
    do = torch.randn(o.shape, generator=gen, device=DEV).to(q.dtype)
    g1 = torch.autograd.grad(o, ins, do, retain_graph=True)
    g2 = torch.autograd.grad(o, ins, do)
    torch.cuda.synchronize()
    dq_diff = (g1[0].float() - g2[0].float()).abs().max().item()
    same = all(torch.equal(a, b) for a, b in zip(g1[1:], g2[1:]))
    print(f"  repeatability, two backward runs on the same tensors {tuple(q.shape)}: max |dq1 - "
          f"dq2| {dq_diff:.3e} (dq max {g1[0].float().abs().max().item():.3e}; reading); dk and "
          f"dv bitwise equal: {same}")
    report["bwd_repeatability"] = dict(dq_max_abs_diff=dq_diff, dk_dv_equal=same)
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
                if dt == torch.bfloat16 and not _bwd_repeatability(q, k, v, gen):
                    bad.append("dk, dv repeatability")
            del q, k, v, bias
        q, k, v = _flash_operands(gen, 2, HEADS, 1000, 1531, 64, dt)
        bias = _flash_bias(gen, "key", 2, 1000, 1531)
        label = f"bias=key {str(dt)[6:]} Lq=1000 Lk=1531"
        if not _bwd_check(label, q, k, v, bias, dt, gen):
            bad.append(label)
        torch.cuda.empty_cache()
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
    calls = []  # per backward call: (ok, worst err / tol of dq, dk, dv)
    launch_bwd = fa._launch_bwd

    def check(*args):
        grads = launch_bwd(*args)
        ref = fa.flash_attention_bwd_plain(*args)
        ok, worst = True, []
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            ok = _tol_check(_bwd_kernel(name, g.dtype), f"{name} of the step's backward call {len(calls) + 1} (do "
                            f"strides {tuple(args[-1].stride())})", g, r, 2.0 ** -6, 2.0 ** -8,
                            like=r, quiet=True) and ok
            c = report["checks"][-1]
            worst.append(max(c["max_abs_err"] / max(c["tol_max"], 1e-30),
                             c["mean_abs_err"] / max(c["tol_mean"], 1e-30)))
        calls.append((ok, worst))
        return grads

    fa._launch_bwd = check
    try:
        loss_k, g_k = _step_grads(pipe, batch, draws)
    finally:
        fa._launch_bwd = launch_bwd
    grads_finite = all(bool(torch.isfinite(g).all()) for g in g_k.values())
    in_path = len(calls) == TRAIN_FLASH_LAYERS and all(ok for ok, _ in calls)
    worst = [max((w[i] for _, w in calls), default=float("nan")) for i in range(3)]
    print(f"  every backward call of the step ({len(calls)}, expected {TRAIN_FLASH_LAYERS}) vs "
          f"the plain backward on its own tensors, flash bf16 tolerance: worst error / "
          f"tolerance dq {worst[0]:.3f}, dk {worst[1]:.3f}, dv {worst[2]:.3f}; failing calls "
          f"{[i + 1 for i, (ok, _) in enumerate(calls) if not ok]}: "
          f"{'ok' if in_path else 'FAIL'}")
    del calls
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
    for name in ("flash_attention_dkv", "flash_attention_dq"):
        _record_launches(name, "t2i_train_f32", launches32[name])
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


def _flash_flops(lq, lk, bh=T2I_ROWS * HEADS, d=64):
    """FLOPs of the flash kernels of one training step, from their shapes:
    forward 4 BH Lq Lk d (twice: remat), backward 10 BH Lq Lk d (the
    function's own count: s, do vᵀ, pᵀ do, dsᵀ q, ds k)."""
    per = bh * lq * lk * d
    return TRAIN_FLASH_LAYERS * (2 * 4 + 10) * per


def _ptxas_report(kernel):
    """The ``-Xptxas -v`` lines (registers, spills) of one kernel of
    flash_attention_bwd.cu from this checkout's build log."""
    lines, on = [], False
    for line in _build.build_log("flash_attention_bwd").splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines)


@phase("5d timing of the backward kernels and the training step")
def timing_train(pipe):
    """The bf16 backward's kernels (prep, dkvq, cast) per launch at (8, 16,
    1280, 64), the f32 route's dK/dV and dQ at the same shape in f32, their
    plain version (the whole plain backward), one library call where one
    computes the same function (SDPA's backward for the gradients, from a
    graph built once; a strided copy for the cast), their bounds (the
    operations over the peak rate of their type, or the bytes: each input
    read once, each output written once), the whole backward through
    autograd against its joint bound; then the training step."""
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
                 library=sdpa_fwd)
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
    # the f32 route's kernels at the same shape in f32
    q, k, v, o, do = (t.float() for t in (q, k, v, o, do))
    launches, _ = fa._bwd_operands(q, k, v, None, None, o, lse, do)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    o_lib = Fn.scaled_dot_product_attention(*ins)
    library32 = sync_ms(lambda: torch.autograd.grad(o_lib, ins, do, retain_graph=True), 3)
    del o_lib, ins
    plain32 = sync_ms(lambda: fa.flash_attention_bwd_plain(q, k, v, None, None, o, lse, do), 3)
    for name, mult, nbytes in (("flash_attention_dkv", 8, 2 * (4 * io + 2 * io) + 2 * rows),
                               ("flash_attention_dq", 6, 2 * (4 * io + io) + 2 * rows)):
        ms = sync_ms(lambda: fa.run_bwd(launches, (name,)), 3)
        bound = _bound(mult * bh * L * L * 64 / PEAK_F32_FLOPS, nbytes)
        report["kernels"][name].update(dict(ms=ms, plain_ms=plain32, bound_ms=bound[0],
                                            bound_by=bound[1], library_ms=library32))
        print(f"  {name} f32 {(T2I_ROWS, HEADS, L, 64)}: {ms:.3f} ms/launch, plain backward "
              f"{plain32:.3f} ms, SDPA f32 backward {library32:.3f} ms, bound {bound[0]:.3f} ms "
              f"({bound[1]}, f32 at 67 TFLOP/s), {bound[0] / ms:.1%} of bound")
    del q, k, v, o, lse, do, launches
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


def _bound_ms(kind, n):
    """Bounds of the flagship kernels: n rows (MLP) or samples (attention)."""
    if kind == "mlp":
        return _bound(4 * n * D * F / PEAK_INT8_OPS, 2 * n * D * 2 + 2 * D * F)
    rows = n * T
    return _bound(2 * rows * D * 4 * D / PEAK_INT8_OPS + 4 * n * T * T * D / PEAK_BF16_FLOPS,
                  2 * rows * D * 2 + 4 * D * D)


def _time_kernel(name, shape_key, kernel, plain, bound, library=None, iters=20):
    ms = sync_ms(kernel, iters)
    plain_ms = sync_ms(plain, 3)
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
               library_ms=None if library is None else sync_ms(library, iters))
    lib = "" if library is None else f", library {row['library_ms']:.3f} ms"
    print(f"  {name} {shape_key}: {ms:.3f} ms/launch, plain {plain_ms:.3f} ms{lib}, bound "
          f"{bound[0]:.3f} ms ({bound[1]}), {bound[0] / ms:.1%} of bound")
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
                               lambda: plain(*ops, **kw), _bound_ms(kind, n))
            if mult == 2:  # the kernels line quotes the CFG steps' 2x batch
                report["kernels"][name].update(row)
            del ops
            torch.cuda.empty_cache()
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


PORT_KERNEL_NAMES = ("gemm_s8_kernel", "row_quant_kernel", "row_op_kernel", "attn_core_",
                     "flash_fwd_", "flash_static_kernel", "static_qk_quant_kernel", "flash_bwd_")


def profile_call(sample, label="flagship"):
    """Device time by kernel over one pipeline call ``sample()``
    (torch.profiler), and the device's idle share of that call's wall time.
    Reported only: the profiler is untried on some machines, and its absence
    fails nothing."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
          f"(idle share {1 - busy / wall_us:.1%}), port kernels {sum(ours.values()) / 1e3:.1f} ms")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {v / 1e3:9.1f} ms  {k[:100]}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:20]
    report["profile" if label == "flagship" else f"profile_{label}"] = dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
        port_kernels_ms=sum(ours.values()) / 1e3, top={k[:100]: v / 1e3 for k, v in top})


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
                   2 * m * d + 2 * m * 3 * d + 3 * d * d + (2 * d + 3 * d) * 2 + 3 * d * 4))
        if mult == 2:
            report["kernels"]["fused_ln_int8_matmul"].update(row)
        x, _, _, wq, ws, bias, res = _proj_operands(gen, (b, PP_T), d, d)
        row = _time_kernel(
            "int8_matmul_residual", (m, d, d),
            lambda: fb.int8_matmul_residual(x, res, wq, ws, bias),
            lambda: fb.int8_matmul_residual_plain(x, res, wq, ws, bias),
            _bound(2 * m * d * d / PEAK_INT8_OPS, 3 * 2 * m * d + d * d + d * 2 + d * 4))
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
            library=lambda: F.scaled_dot_product_attention(q, k, v))
        if mult == 2:
            report["kernels"]["flash_attention"].update(row)
        # the same MLP kernel at this path's width (its entry in the kernels
        # line stays the flagship's)
        mlp_ops = _pp_mlp_operands(gen, m)
        kw = _variants("mlp")[0][1]  # static a_ln2 / a_mid, as path B passes them
        _time_kernel(
            "fused_ln_int8_mlp", (m, d, PP_F),
            lambda: fb.fused_ln_int8_mlp(*mlp_ops, **kw),
            lambda: fb.fused_ln_int8_mlp_plain(*mlp_ops, **kw),
            _bound(4 * m * d * PP_F / PEAK_INT8_OPS, 2 * m * d * 2 + 2 * d * PP_F))
        del q, k, v, mlp_ops
        torch.cuda.empty_cache()
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
                   2 * m * D * 4 + 2 * D * F + (F + 3 * D) * 2 + (F + D) * 4))
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
            library=lambda: Fn.scaled_dot_product_attention(q, k, v))
        if L == T2I_L["full"]:
            report["kernels"]["flash_attention_static"].update(row)
        del q, k, v
        x = torch.randn((m, D), generator=gen, device=DEV)
        w, ws = quantize_weight_kmajor(torch.randn((3 * D, D), generator=gen, device=DEV)
                                       * D ** -0.5)
        b = torch.zeros((3 * D,), device=DEV, dtype=torch.bfloat16)
        row = _time_kernel(
            "int8_linear", (m, D, 3 * D),
            lambda: fb.int8_linear(x, w, ws, b, torch.bfloat16),
            lambda: fb.int8_linear_plain(x, w, ws, b, torch.bfloat16),
            _bound(2 * m * D * 3 * D / PEAK_INT8_OPS, m * D * 4 + m * 3 * D * 2 + 3 * D * D))
        if L == T2I_L["full"]:
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
               3 * m * D * 2 + 5 * D * D + (3 * D + 4 * D) * 2 + 5 * D * 4), iters=200)
    report["kernels"]["fused_int8_diffusion_block"].update(row)
    torch.cuda.empty_cache()
    fb.reset_launch_counts()
    for label, pipe in (("t2i_int8", pipe_int8), ("t2i_float", pipe_float)):
        if pipe is None:
            raise AssertionError(f"no pipeline: {label} failed")
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            _t2i_sample(pipe, seed=20 + i)
            times.append(time.perf_counter() - t0)
        p50 = float(np.percentile(times, 50))
        print(f"{label}: batch {T2I_BATCH}, {T2I_AR} AR x {T2I_DIFF} diffusion steps, p50 "
              f"{p50:.3f} s per call, {T2I_BATCH / p50:.3f} samples/s "
              f"(times {[round(t, 3) for t in times]})")
        report[label].update(batch=T2I_BATCH, p50_s=p50, samples_per_s=T2I_BATCH / p50,
                             times_s=times)


@phase("6 profiles")
def profiles(pipe, pipe_a, pipe_b, pipe_t2i, pipe_train):
    """One profiled call of each path (one step of training), after every
    timing: the profiler's hooks stay on the launch path once it has run,
    and would slow the host side of the per-launch timings."""
    if pipe is not None:
        profile_call(lambda: _sample(pipe, seed=30))
    for label, p in (("path_a", pipe_a), ("path_b", pipe_b)):
        if p is not None:
            profile_call(lambda: _sample(p, seed=30, prompts=PP_PROMPTS), label)
    if pipe_t2i is not None:
        profile_call(lambda: _t2i_sample(pipe_t2i, seed=30), "t2i_int8")
    if pipe_train is not None:
        data = itertools.repeat(_train_batch(5))

        def step():
            pipe_train.train(data, pipe_train.trainer.step + 1)
            torch.cuda.synchronize()

        profile_call(step, "t2i_train")


def main():
    if not torch.cuda.is_available():
        _fail("CUDA is not available: this script runs on the GPU only", 2)
    if _PORT_IMPORT_ERROR is not None:
        _fail(f"the port package is not importable ({_PORT_IMPORT_ERROR}): "
              f"run from the root of the repository", 3)
    device_info()
    build()
    if "2 build" not in failures:
        check_kernels()
        check_split_kernels()
        check_flash()
        check_nova_kernels()
        check_flash_backward()
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
        profiles(pipe, pipe_a, pipe_b, pipe_t2i, pipe_train)
    kernels = []
    for name in KERNELS:
        k = report["kernels"].get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": k.get("launches"),
                        "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                        "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                        "bound_by": k.get("bound_by"), "library_ms": k.get("library_ms"),
                        "launches_by_path": k.get("launches_by_path")})
        missing = [key for key, val in kernels[-1].items()
                   if val is None and key != "library_ms"]
        if missing or not kernels[-1]["launches"]:
            failures.append(f"kernels line: {name} lacks {missing or 'launches'}")
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

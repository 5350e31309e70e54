"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; any failure makes the script exit non-zero without the
result line:

1. print the card, its power limit, and the torch / CUDA / nvcc versions;
2. build every CUDA kernel of the main path from the sources in this
   checkout (one nvcc per source, in parallel) and print the build time;
3. hold each kernel against its plain PyTorch version on the card at the
   flagship shapes, every variant (attention cores f32/bf16/int8 x static /
   per-row activations x calibrated softmax offset on/off; MLP static /
   per-row);
4. drive the main path through the user-facing entry points: flagship
   t2pc serving (pc_d48w1024, 2048 points at patch 16, DummyTextEncoder(256,
   32), DDPM squaredcos_cap_v2 with 25 steps, CFG 7.5 with guidance
   truncation at 800, int8 with calibrated static scales, bf16 attention
   core, batch 128) on seeded random weights with a non-zero output head;
   count the kernel launches of that call, check the output, and hold it
   against the same call with the plain versions substituted;
5. time each kernel per launch at both batch sizes of the main path, its
   plain version, and the pipeline's samples/s (CUDA events and
   torch.cuda.synchronize).

The line before the last is a JSON object with one entry per kernel; the
last line is the result object. Details go to build/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

try:
    from nova_pointcloud_tpu_torch.models.pointcloud import NOVAPointCloudTransformer
    from nova_pointcloud_tpu_torch.models.text_encoders.dummy import DummyTextEncoder
    from nova_pointcloud_tpu_torch.ops.kernels import _build
    from nova_pointcloud_tpu_torch.ops.kernels import fused_block as fb
    from nova_pointcloud_tpu_torch.ops.quantization import quantize_weight_kmajor
    from nova_pointcloud_tpu_torch.pipelines.pointcloud_gen import (
        NOVAPointCloudGenerationPipeline)
    from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler
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
SOURCES = {"fused_attention_block": "nova_pointcloud_tpu_torch/csrc/fused_attention_block.cu",
           "fused_ln_int8_mlp": "nova_pointcloud_tpu_torch/csrc/fused_ln_int8_mlp.cu"}
REPLACES = {"fused_attention_block": "nova_pointcloud_tpu/ops/pallas/fused_block.py:412",
            "fused_ln_int8_mlp": "nova_pointcloud_tpu/ops/pallas/fused_block.py:133"}
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
        worst = 0.0
        # every variant at the CFG steps' 2x batch, the flagship variant
        # (the first) also at the 1x batch of the steps after truncation
        cases = [(FLAGSHIP_SHAPE[kind], v) for v in _variants(kind)]
        cases.append((FLAGSHIP_SHAPE[kind] // 2, _variants(kind)[0]))
        for n, (label, kw) in cases:
            ops = _kernel_operands(gen, n, kind)
            y = kernel(*ops, **kw)
            torch.cuda.synchronize()
            ref = plain(*ops, **kw).float()
            err = (y.float() - ref).abs()
            tol_max = 2.0 ** -6 * ref.abs().max().item()
            tol_mean = 2.0 ** -10 * ref.abs().mean().item()
            e_max, e_mean = err.max().item(), err.mean().item()
            ok = (bool(torch.isfinite(y).all()) and e_max <= tol_max and e_mean <= tol_mean
                  and y.dtype == ops[0].dtype and y.shape == ops[0].shape)
            print(f"  {name} {label} {tuple(ops[0].shape)}: max_abs_err {e_max:.3e} "
                  f"(tol {tol_max:.3e}) mean {e_mean:.3e} (tol {tol_mean:.3e}) "
                  f"{'ok' if ok else 'FAIL'}")
            report["checks"].append(dict(kernel=name, variant=label, max_abs_err=e_max,
                                         tol_max=tol_max, mean_abs_err=e_mean,
                                         tol_mean=tol_mean, ok=ok))
            worst = max(worst, e_max)
            if not ok:
                bad.append(f"{name} {label}")
            del y, ref, err, ops
            torch.cuda.empty_cache()
        report["kernels"].setdefault(name, {})["max_abs_err"] = worst
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    fb.reset_launch_counts()  # these launches were comparisons, not the main path


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


def _sample(pipe, seed=1, **kw):
    out = pipe(PROMPTS, num_points=POINTS, num_diffusion_steps=STEPS,
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
    print(f"launches in one pipeline call: {launches} (expected {expected} each)")
    for name in _kernels():
        report["kernels"].setdefault(name, {})["launches"] = launches[name]
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
    if not (ok and agree and fwd_ok and all(v == expected for v in launches.values())
            and not any(plain_launches.values())):
        raise AssertionError("main path check failed")
    return pipe


def _bound_ms(kind, n):
    """Least time for the work: bytes (x in, y out, weights) over HBM rate,
    or operations over the peak rate of their type, whichever is larger."""
    if kind == "mlp":
        ops_s = 4 * n * D * F / PEAK_INT8_OPS
        bytes_ = 2 * n * D * 2 + 2 * D * F
    else:
        rows = n * T
        ops_s = 2 * rows * D * 4 * D / PEAK_INT8_OPS + 4 * n * T * T * D / PEAK_BF16_FLOPS
        bytes_ = 2 * rows * D * 2 + 4 * D * D
    bytes_s = bytes_ / PEAK_BYTES
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"


@phase("5 timing")
def timing(pipe):
    gen = torch.Generator(device=DEV).manual_seed(5)
    for name, (kind, kernel, plain) in _kernels().items():
        kw = dict(_variants(kind)[0][1])  # flagship: static acts (+ bf16 core, smax)
        rows = {}
        for mult in (2, 1):
            n = FLAGSHIP_SHAPE[kind] * mult // 2
            ops = _kernel_operands(gen, n, kind)
            ms = sync_ms(lambda: kernel(*ops, **kw), 20)
            plain_ms = sync_ms(lambda: plain(*ops, **kw), 3)
            bound, by = _bound_ms(kind, n)
            rows[n] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            print(f"  {name} {tuple(ops[0].shape)}: {ms:.3f} ms/launch, plain {plain_ms:.3f} ms, "
                  f"bound {bound:.3f} ms ({by}), {bound / ms:.1%} of bound")
            del ops
            torch.cuda.empty_cache()
        k = report["kernels"].setdefault(name, {})
        k["by_shape"] = rows
        k.update(rows[FLAGSHIP_SHAPE[kind]])
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
    profile_call(pipe)


def profile_call(pipe):
    """Device time by kernel over one pipeline call (torch.profiler), and
    the device's idle share of that call's wall time. Reported only: the
    profiler is untried on some machines, and its absence fails nothing."""
    try:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _sample(pipe, seed=30)
            wall_us = (time.perf_counter() - t0) * 1e6
        by_name = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0.0)
            if us > 0:
                by_name[e.key] = by_name.get(e.key, 0.0) + us
    except Exception as e:  # reported, not fatal: see the docstring
        print(f"profiler: not available ({type(e).__name__}: {e})")
        return
    busy = sum(by_name.values())
    ours = {k: v for k, v in by_name.items()
            if any(n in k for n in ("gemm_s8_kernel", "row_quant_kernel", "attn_core_"))}
    print(f"profiled call: wall {wall_us / 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms "
          f"(idle share {1 - busy / wall_us:.1%}), port kernels {sum(ours.values()) / 1e3:.1f} ms")
    for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {v / 1e3:9.1f} ms  {k[:100]}")
    report["profile"] = dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                             port_kernels_ms=sum(ours.values()) / 1e3,
                             top={k[:100]: v / 1e3 for k, v in sorted(
                                 by_name.items(), key=lambda kv: -kv[1])[:20]})


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
        pipe = main_path()
        timing(pipe)
    kernels = []
    for name in _kernels():
        k = report["kernels"].get(name, {})
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": k.get("launches"),
                        "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                        "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                        "bound_by": k.get("bound_by"), "library_ms": None})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

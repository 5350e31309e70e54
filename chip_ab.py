"""A/B timing of one tree of the PyTorch/CUDA port on one GPU.

    python3 chip_ab.py LABEL
    python3 chip_ab.py --row1 LABEL
    python3 chip_ab.py --flash LABEL
    python3 chip_ab.py --xl-steps LABEL
    python3 chip_ab.py --compare LABEL_A LABEL_B

Run from the root of a tree (this checkout, or another commit unpacked with
``git archive`` into a gitignored directory such as ``build/old``); the
script may live in another tree (``cd build/old && python3 ../../chip_ab.py
old``): it imports ``chip_smoke`` and the port from the directory it is run
in. It builds the kernels, checks each flagship kernel against its plain
version once, times each kernel per launch at both batch sizes of its path
(CUDA events; fused_attention_block and fused_ln_int8_mlp also from a CUDA
graph, fused_ln_int8_mlp also at path B's width; fused_ln_int8_matmul also
from a graph; the t2i kernels at the t2i path's shapes, fused_int8_mlp_postln
at 8 x 1280 and 8 x 768 rows, it and fused_int8_diffusion_block also from a
CUDA graph; int8_linear at every (M, N) of the t2i int8 call, by events and
from a graph), and times the pipelines
(p50 of 3 calls: t2i int8 at batch 4 after a 2-step calibration, the
flagship at batch 128 after a 2-step calibration, the per-point float and
int8 paths at batch 8). It prints one line, ``AB {json}``, and saves to
``build/ab/LABEL.pt`` under the directory it is run in the outputs of
fused_ln_int8_mlp, fused_attention_block and fused_int8_mlp_postln on fixed
inputs, and fused_int8_mlp_postln's int8 mid rows (fc1's q2, caught where
the wrapper allocates them), and under ``build/ab/LABEL_linear.pt`` the
outputs of int8_linear at every (M, N) of the t2i int8 call (and with an
f32 output, and without a bias), of fused_ln_int8_matmul at path B's 2x and
1x batch and a ragged row count, and of int8_matmul_residual at path B's 2x
and 1x batch in the four x / residual dtype pairs (its row pass is the one
without LayerNorm), and under ``build/ab/LABEL_f32.pt`` the f32 flash
backward's dq, dk and dv at the training shape (8, 16, 1280, 64) with no
bias, a key bias and a full bias (the f32 route and forward are timed too,
and one t2i training step, p50 of 5). ``--compare`` (run where
both were saved, after
copying one next to the other) prints the largest |A - B| of each, whether
they are bitwise equal, and whether each output is within phase 3's
tolerance of the other (max <= 2^-6 max|y|, mean <= 2^-10 mean|y|). To
compare two trees, run both in one job on one card, alternating: A, B, B,
A. ``--row1`` builds fused_attention_block alone and does only its part:
the registers and spill bytes of its hd-64 QKV + core kernel (ptxas), its
flagship variant's ms per launch at the flagship's 2x and 1x batch (events
and a CUDA graph), and its outputs on fixed inputs (the bf16 core's four
variants at both batches) under ``build/ab/LABEL_row1.pt``; ``--flash``
builds the three flash libraries alone and does only their part: the
registers and spill bytes (ptxas) of every head-dim-64 and bf16 instance
(FLASH_INSTANCES), their ms by events and from a CUDA graph at their
paths' shapes, and their outputs on fixed inputs under
``build/ab/LABEL_flash.pt`` (forward o and lse, the static attention's two
cores, the bf16 and f32 backward at both head dims through autograd;
their dq comes from atomic adds except at head dim 96, whose dQ sums take
a fixed order, so at head dim 64 only their dk and dv can be bitwise
across trees); ``--compare`` reads whichever of the saved files both
labels have, and holds the head-dim-96 gradients to phase 3e's
tolerances (bf16 2^-6 / 2^-8, f32 1e-4 / 1e-5 relative). ``--xl-steps``
runs chip_smoke's phases 4t and 4x (the NOVA-1.4B training step in bf16
compute and its f32 twin, with their launch and gradient gates) and prints
their step times.
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())  # the tree this is run in, wherever the script lies
import chip_smoke as cs  # noqa: E402

AB_DIR = os.path.join("build", "ab")
# int8_linear's rows in the t2i int8 call (chip_smoke.T2I_LINEAR_M, kept
# here: the script also runs against trees whose chip_smoke lacks it)
LINEAR_M = (8 * 288, 8 * 384, 8 * 512, 8 * 768, 8 * 1280)


def _linear_operands(gen, m, n):
    """x (m, 1024), f32 for qkv (n = 3072), bf16 for the out-projection
    (n = 1024); the K-major int8 weight, its scales, a bf16 bias."""
    x = torch.randn((m, cs.D), generator=gen, device="cuda")
    if n == cs.D:
        x = x.to(torch.bfloat16)
    w, ws = cs.quantize_weight_kmajor(torch.randn((n, cs.D), generator=gen, device="cuda")
                                      * cs.D ** -0.5)
    b = (torch.randn((n,), generator=gen, device="cuda") * 0.1).to(torch.bfloat16)
    return x, w, ws, b


def main(label: str) -> None:
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cs._build.build_all()
    res = {"label": label, "build_s": time.perf_counter() - t0}
    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, (kind, kernel, plain) in cs._kernels().items():
        kw = dict(cs._variants(kind)[0][1])  # the flagship variant
        for n in (cs.FLAGSHIP_SHAPE[kind], cs.FLAGSHIP_SHAPE[kind] // 2):
            ops = cs._kernel_operands(gen, n, kind)
            err = (kernel(*ops, **kw).float() - plain(*ops, **kw).float()).abs()
            res[f"{name}_{n}_err"] = [err.max().item(), err.mean().item()]
            res[f"{name}_{n}_ms"] = cs.sync_ms(lambda: kernel(*ops, **kw), 20)
            if kind == "attention":
                res[f"{name}_{n}_graph_ms"] = cs.graph_ms(lambda: kernel(*ops, **kw))
            del ops, err
    mlp_kw = dict(cs._variants("mlp")[0][1])
    for n in (cs.FLAGSHIP_SHAPE["mlp"], cs.FLAGSHIP_SHAPE["mlp"] // 2):
        ops = cs._kernel_operands(gen, n, "mlp")
        res[f"fused_ln_int8_mlp_{n}_graph_ms"] = cs.graph_ms(
            lambda: cs.fb.fused_ln_int8_mlp(*ops, **mlp_kw))
        del ops
    n = 2 * cs.PP_BATCH * cs.PP_T  # path B's width, the CFG steps' 2x batch
    ops = cs._pp_mlp_operands(gen, n)
    res[f"fused_ln_int8_mlp_{n}x{cs.PP_D}_ms"] = cs.sync_ms(
        lambda: cs.fb.fused_ln_int8_mlp(*ops, **mlp_kw), 20)
    res[f"fused_ln_int8_mlp_{n}x{cs.PP_D}_graph_ms"] = cs.graph_ms(
        lambda: cs.fb.fused_ln_int8_mlp(*ops, **mlp_kw))
    del ops
    _save_mlp_outputs(label)
    d, t = cs.PP_D, cs.PP_T
    for b in (2 * cs.PP_BATCH, cs.PP_BATCH):
        x, lns, lnb, wq, ws, bias, _ = cs._proj_operands(gen, (b, t), d, 3 * d)
        res[f"fused_ln_int8_matmul_{b * t}_ms"] = cs.sync_ms(
            lambda: cs.fb.fused_ln_int8_matmul(x, lns, lnb, wq, ws, bias), 20)
        res[f"fused_ln_int8_matmul_{b * t}_graph_ms"] = cs.graph_ms(
            lambda: cs.fb.fused_ln_int8_matmul(x, lns, lnb, wq, ws, bias))
        x, _, _, wq, ws, bias, r = cs._proj_operands(gen, (b, t), d, d)
        res[f"int8_matmul_residual_{b * t}_ms"] = cs.sync_ms(
            lambda: cs.fb.int8_matmul_residual(x, r, wq, ws, bias), 20)
        res[f"int8_matmul_residual_{b * t}_graph_ms"] = cs.graph_ms(
            lambda: cs.fb.int8_matmul_residual(x, r, wq, ws, bias))
        q, k, v = cs._flash_operands(gen, b, cs.PP_HEADS, t, t, cs.PP_HD)
        res[f"flash_attention_{b}_ms"] = cs.sync_ms(
            lambda: cs.fa.flash_attention_with_lse(q, k, v), 20)
        del x, r, q, k, v
    _save_int8_outputs(label)
    for m in LINEAR_M:
        for n in (3 * cs.D, cs.D):
            x, w, ws, bias = _linear_operands(gen, m, n)
            call = lambda: cs.fb.int8_linear(x, w, ws, bias, torch.bfloat16)  # noqa: E731
            res[f"int8_linear_{m}x{n}_ms"] = cs.sync_ms(call, 20)
            res[f"int8_linear_{m}x{n}_graph_ms"] = cs.graph_ms(call)
            del x
    _save_linear_outputs(label)
    _flash_f32(res, label)
    L = cs.T2I_L["full"]
    kw = cs._t2i_variants("mlp")[0][1]
    for rows in (L, 768):  # the decoder half's 8 x 1280 rows, the largest bucket's 8 x 768
        ops = cs._t2i_mlp_operands(gen, (cs.T2I_ROWS, rows))
        key = "fused_int8_mlp_postln" + ("" if rows == L else f"_{cs.T2I_ROWS * rows}")
        res[f"{key}_ms"] = cs.sync_ms(
            lambda: cs.fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw), 20)
        res[f"{key}_graph_ms"] = cs.graph_ms(
            lambda: cs.fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw))
        del ops
    q, k, v, _ = cs._static_attention_operands(gen, L, "none")
    smax = torch.tensor(9.0, device="cuda")
    res["flash_attention_static_ms"] = cs.sync_ms(
        lambda: cs.fa.flash_attention_static(q, k, v, smax), 20)
    ops = cs._diffusion_operands(gen, cs.T2I_ROWS * cs.T2I_PAD_P)
    kw = cs._t2i_variants("diffusion")[0][1]
    res["fused_int8_diffusion_block_ms"] = cs.sync_ms(
        lambda: cs.fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw), 200)
    res["fused_int8_diffusion_block_graph_ms"] = cs.graph_ms(
        lambda: cs.fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw))
    del ops, q, k, v
    pipe = cs._make_t2i_pipeline(quantize=True)
    pipe.calibrate(cs.T2I_PROMPTS, num_inference_steps=2, num_diffusion_steps=2)
    cs._t2i_sample(pipe, ar_steps=4, seed=9)  # warm-up
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        cs._t2i_sample(pipe, seed=20 + i)
        times.append(time.perf_counter() - t0)
    res["t2i_int8_p50_s"] = float(np.percentile(times, 50))
    res["t2i_int8_samples_per_s"] = cs.T2I_BATCH / res["t2i_int8_p50_s"]
    del pipe
    pipe = cs._make_pipeline()
    pipe.calibrate(prompt_embeds=pipe.encode_prompt(cs.PROMPTS), num_points=cs.POINTS,
                   num_diffusion_steps=2)
    res["pipeline_p50_s"] = _p50(pipe, cs.PROMPTS)
    res["samples_per_s"] = cs.BATCH / res["pipeline_p50_s"]
    del pipe
    for label, quantize in (("path_a", False), ("path_b", True)):
        pipe = cs._make_per_point_pipeline(quantize)
        if quantize:
            pipe.calibrate(prompt_embeds=pipe.encode_prompt(cs.PP_PROMPTS),
                           num_points=cs.POINTS, num_diffusion_steps=2)
        res[f"{label}_p50_s"] = _p50(pipe, cs.PP_PROMPTS)
        res[f"{label}_samples_per_s"] = cs.PP_BATCH / res[f"{label}_p50_s"]
        del pipe
    torch.cuda.empty_cache()
    pipe = cs._train_pipe(cs._train_model())
    data = iter([cs._train_batch(4)] * 8)
    pipe.train(data, pipe.trainer.step + 2)  # warm-ups
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe.train(data, pipe.trainer.step + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    res["t2i_train_p50_s"] = float(np.percentile(times, 50))
    res["t2i_train_samples_per_s"] = cs.TRAIN_BATCH / res["t2i_train_p50_s"]
    del pipe
    print("AB " + json.dumps(res), flush=True)


def row1(label: str) -> None:
    """--row1 (see the module docstring)."""
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
    t0 = time.perf_counter()
    cs._build.build_all(["fused_attention_block"])
    res = {"label": label, "build_s": time.perf_counter() - t0}
    # the hd-64 instance's mangled name: templated on the head dim, or not
    for name in ("attn_qkv_core_kernelILi64E", "attn_qkv_core_kernelE"):
        regs, spills, serial = cs._ptxas_numbers(name, "fused_attention_block")
        if regs is not None:
            res["qkv_core_hd64_ptxas"] = dict(registers=regs, spill_bytes=spills, c7514=serial)
            break
    gen = torch.Generator(device="cuda").manual_seed(5)
    kw = dict(cs._variants("attention")[0][1])
    for n in (cs.FLAGSHIP_SHAPE["attention"], cs.FLAGSHIP_SHAPE["attention"] // 2):
        ops = cs._kernel_operands(gen, n, "attention")
        res[f"row1_{n}_ms"] = cs.sync_ms(lambda: cs.fb.fused_attention_block(*ops, **kw), 20)
        res[f"row1_{n}_graph_ms"] = cs.graph_ms(lambda: cs.fb.fused_attention_block(*ops, **kw))
        del ops
    outs = _row1_outputs(torch.Generator(device="cuda").manual_seed(78))
    os.makedirs(AB_DIR, exist_ok=True)
    torch.save(outs, os.path.join(AB_DIR, f"{label}_row1.pt"))
    print("AB " + json.dumps(res), flush=True)


# the head-dim-64 and bf16 instances of the flash libraries by label: the
# mangled names (templated on the head dim since the f32 head-dim-96 slice,
# or not) whose ptxas report --flash records
FLASH_INSTANCES = {
    "flash_attention": {
        "f32 no bias": ("flash_fwd_f32_kernelILi64ELb0ELb0E", "flash_fwd_f32_kernelILb0ELb0E"),
        "f32 key bias": ("flash_fwd_f32_kernelILi64ELb1ELb0E", "flash_fwd_f32_kernelILb1ELb0E"),
        "f32 full bias": ("flash_fwd_f32_kernelILi64ELb0ELb1E", "flash_fwd_f32_kernelILb0ELb1E"),
        **{f"bf16 hd {d} {b}": (f"attn_fwd_kernelILi{d}ELb0ELb0E{m}",)
           for d in (64, 96) for b, m in (("no bias", "Lb0ELb0E"), ("key bias", "Lb1ELb0E"),
                                          ("full bias", "Lb0ELb1E"))}},
    "flash_attention_static": {
        **{f"{core} hd {d} {b}": (f"attn_fwd_kernelILi{d}ELb1E{c}{m}",)
           for core, c, ds in (("bf16", "Lb0E", (64, 96)), ("int8", "Lb1E", (64,))) for d in ds
           for b, m in (("no bias", "Lb0ELb0E"), ("key bias", "Lb1ELb0E"))},
        "quant hd 64": ("static_qk_quant_kernelILi64E", "static_qk_quant_kernelEPKv")},
    "flash_attention_bwd": {
        **{f"{k} {b}": (f"{k}ILb{i}E",) for k in ("flash_bwd_f32_kernel", "flash_bwd_dkvq_kernel",
                                                   "flash_bwd_dkvq96_kernel",
                                                   "flash_bwd_f32_96_kernel")
           for i, b in ((0, "no bias"), (1, "full bias"))},
        "prep bf16 hd 64": ("flash_bwd_prep_kernelI13__nv_bfloat16Li64E",),
        "prep f32 hd 64": ("flash_bwd_prep_kernelIfLi64E",),
        "prep bf16 hd 96": ("flash_bwd_prep_kernelI13__nv_bfloat16Li96E",),
        "prep f32 hd 96": ("flash_bwd_prep_kernelIfLi96E",),
        # templated on the head dim since the one-pass head-dim-96 backward
        "cast": ("flash_bwd_dq_cast_kernelILi64E", "flash_bwd_dq_cast_kernelEPKf"),
        "cast hd 96": ("flash_bwd_dq_cast_kernelILi96E",)}}


def flash(label: str) -> None:
    """--flash (see the module docstring)."""
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cs._build.build_all(list(FLASH_INSTANCES))
    res = {"label": label, "build_s": time.perf_counter() - t0, "ptxas": {}}
    for lib, instances in FLASH_INSTANCES.items():
        for name, mangled in instances.items():
            for m in mangled:
                regs, spills, _ = cs._ptxas_numbers(m, lib)
                if regs is not None:
                    res["ptxas"][f"{lib} {name}"] = (regs, spills)
                    break
    gen = torch.Generator(device="cuda").manual_seed(90)
    outs, fa = {}, cs.fa
    smax = torch.tensor(9.0, device="cuda")
    # (label, b, h, L, d, dtype): the t2i step's and the 1024px calls' shapes
    for tag, b, h, L, d, dt in (("f32", 8, 16, 1280, 64, torch.float32),
                                ("bf16 hd 64", 2, 16, 5120, 64, torch.bfloat16),
                                ("bf16 hd 96", 2, 16, 5120, 96, torch.bfloat16),
                                ("f32 hd 96", 2, 16, 5120, 96, torch.float32)):
        q, k, v = cs._flash_operands(gen, b, h, L, L, d, dt)
        for kind in ("none", "key"):
            bias = cs._flash_bias(gen, kind, b, L, L)
            o, lse = fa.flash_attention_with_lse(q, k, v, bias)
            outs[f"fwd {tag} {kind} o"], outs[f"fwd {tag} {kind} lse"] = o.cpu(), lse.cpu()
        res[f"fwd {tag} ms"] = cs.sync_ms(lambda: fa.flash_attention(q, k, v), 10)
        res[f"fwd {tag} graph_ms"] = cs.graph_ms(lambda: fa.flash_attention(q, k, v), n=10, reps=3)
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = fa.flash_attention(*ins)
        do = torch.randn(o.shape, generator=gen, device="cuda").to(dt)
        for name, g in zip(("dq", "dk", "dv"), torch.autograd.grad(o, ins, do, retain_graph=True)):
            outs[f"bwd {tag} {name}"] = g.cpu()
        res[f"bwd {tag} ms"] = cs.sync_ms(
            lambda: torch.autograd.grad(o, ins, do, retain_graph=True), 5 if d == 64 else 3)
        del q, k, v, ins, o, do
        torch.cuda.empty_cache()
    for tag, rows, L, d, core in (("bf16 hd 64", 8, 1280, 64, "bf16"),
                                  ("int8 hd 64", 8, 1280, 64, "int8"),
                                  ("bf16 hd 96", 2, 5120, 96, "bf16")):
        for kind in ("none", "visibility"):
            q, k, v, bias = cs._static_attention_operands(gen, L, kind, rows, d)
            kw = dict(a_q=torch.tensor(4.5, device="cuda"),
                      a_k=torch.tensor(4.0, device="cuda")) if core == "int8" else {}
            outs[f"static {tag} {kind}"] = fa.flash_attention_static(q, k, v, smax, bias,
                                                                     **kw).cpu()
        res[f"static {tag} ms"] = cs.sync_ms(lambda: fa.flash_attention_static(q, k, v, smax,
                                                                              **kw), 10)
        res[f"static {tag} graph_ms"] = cs.graph_ms(
            lambda: fa.flash_attention_static(q, k, v, smax, **kw), n=10, reps=3)
        del q, k, v
    os.makedirs(AB_DIR, exist_ok=True)
    torch.save(outs, os.path.join(AB_DIR, f"{label}_flash.pt"))
    print("AB " + json.dumps(res), flush=True)


def xl_steps(label: str) -> None:
    """--xl-steps (see the module docstring)."""
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
    cs._build.build_all(["flash_attention", "flash_attention_bwd"])
    cs.xl_train()
    cs.xl_train_f32()
    res = {"label": label, "failures": list(cs.failures),
           "xl_train_p50_s": cs.report.get("xl_train", {}).get("p50_s"),
           "xl_train_f32_step_s": cs.report.get("xl_train_f32", {}).get("step_s")}
    print("AB " + json.dumps(res), flush=True)


def _row1_outputs(gen):
    """Row 1's outputs at the flagship's 2x and 1x batch, the bf16 core's
    four variants, on inputs drawn from ``gen``."""
    outs = {}
    for n in (cs.FLAGSHIP_SHAPE["attention"], cs.FLAGSHIP_SHAPE["attention"] // 2):
        ops = cs._kernel_operands(gen, n, "attention")
        for variant, kw in cs._variants("attention")[:4]:  # the bf16 core's four
            outs[f"row1 {n} {variant}"] = cs.fb.fused_attention_block(*ops, **kw).cpu()
        del ops
    return outs


def _flash_f32(res, label: str) -> None:
    """The f32 route of the flash backward at the training shape (8, 16,
    1280, 64), no bias: the whole backward through autograd (the route's
    kernels, whatever they are in the tree) from a graph built once, and
    the f32 forward kernel (events and a CUDA graph); its dq, dk and dv on
    inputs drawn from a fixed seed with no bias, a key bias with -inf keys
    and a full bias saved for --compare."""
    gen = torch.Generator(device="cuda").manual_seed(80)
    L = cs.T2I_L["full"]
    outs = {}
    for kind in ("none", "visibility", "full"):
        q, k, v, bias = cs._static_attention_operands(
            gen, L, "visibility" if kind == "visibility" else "none")
        q, k, v = q.float(), k.float(), v.float()
        if kind == "full":
            bias = cs._flash_bias(gen, "full", cs.T2I_ROWS, L, L)
        ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        o = cs.fa.flash_attention(*ins, bias)
        do = torch.randn(o.shape, generator=gen, device="cuda")
        grads = torch.autograd.grad(o, ins, do, retain_graph=True)
        for name, g in zip(("dq", "dk", "dv"), grads):
            outs[f"f32 bwd {kind} {name}"] = g.cpu()
        if kind == "none":
            res["flash_f32_bwd_ms"] = cs.sync_ms(
                lambda: torch.autograd.grad(o, ins, do, retain_graph=True), 5)
            res["flash_f32_fwd_ms"] = cs.sync_ms(lambda: cs.fa.flash_attention_with_lse(q, k, v), 5)
            res["flash_f32_fwd_graph_ms"] = cs.graph_ms(
                lambda: cs.fa.flash_attention_with_lse(q, k, v), n=5, reps=3)
        del q, k, v, bias, ins, o, do, grads
        torch.cuda.empty_cache()
    os.makedirs(AB_DIR, exist_ok=True)
    torch.save(outs, os.path.join(AB_DIR, f"{label}_f32.pt"))


def _save_mlp_outputs(label: str) -> None:
    """fused_ln_int8_mlp's outputs on inputs drawn from a fixed seed (the
    flagship's 2x and 1x batch, path B's width, static and per-row scales),
    for --compare."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    outs = {}
    for case, n in (("flagship", cs.FLAGSHIP_SHAPE["mlp"]), ("flagship",
                                                             cs.FLAGSHIP_SHAPE["mlp"] // 2),
                    ("path_b", 2 * cs.PP_BATCH * cs.PP_T)):
        ops = (cs._kernel_operands(gen, n, "mlp") if case == "flagship"
               else cs._pp_mlp_operands(gen, n))
        for variant, kw in cs._variants("mlp"):
            outs[f"{case} {n} {variant}"] = cs.fb.fused_ln_int8_mlp(*ops, **kw).cpu()
        del ops
    os.makedirs(AB_DIR, exist_ok=True)
    torch.save(outs, os.path.join(AB_DIR, f"{label}.pt"))


def _save_int8_outputs(label: str) -> None:
    """Rows 1 and 5's outputs on inputs drawn from a fixed seed (row 1 at
    the flagship's 2x and 1x batch, the bf16 core, static and per-row
    scales; row 5 at 8 x 1280 and 8 x 768 rows, f32 x, static and per row),
    and row 5's int8 mid rows (fc1's q2: the (M, F) int8 tensor its wrapper
    allocates), for --compare."""
    gen = torch.Generator(device="cuda").manual_seed(78)
    outs = _row1_outputs(gen)
    real_empty = torch.empty
    for rows in (cs.T2I_L["full"], 768):
        m = cs.T2I_ROWS * rows
        ops = cs._t2i_mlp_operands(gen, (cs.T2I_ROWS, rows))
        for variant, kw in cs._t2i_variants("mlp"):
            made = []

            def empty(*a, **k):
                t = real_empty(*a, **k)
                made.append(t)
                return t
            torch.empty = empty
            try:
                y = cs.fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw)
            finally:
                torch.empty = real_empty
            q2, = [t for t in made if t.dtype == torch.int8 and tuple(t.shape) == (m, cs.F)]
            outs[f"row5 {m} {variant}"] = y.cpu()
            outs[f"row5 {m} {variant} q2"] = q2.cpu()
        del ops
    os.makedirs(AB_DIR, exist_ok=True)
    torch.save(outs, os.path.join(AB_DIR, f"{label}_int8.pt"))


def _save_linear_outputs(label: str) -> None:
    """int8_linear's outputs on inputs drawn from a fixed seed at every (M,
    N) of the t2i int8 call (bf16 out), with an f32 output and without a
    bias at 8 x 1280 rows; fused_ln_int8_matmul's at path B's 2x and 1x
    batch and 16461 rows; int8_matmul_residual's at path B's 2x and 1x
    batch with x and the residual in each pair of f32 and bf16; for
    --compare."""
    gen = torch.Generator(device="cuda").manual_seed(79)
    outs = {}
    for m in LINEAR_M:
        for n in (3 * cs.D, cs.D):
            x, w, ws, b = _linear_operands(gen, m, n)
            outs[f"int8_linear {m}x{n}"] = cs.fb.int8_linear(x, w, ws, b, torch.bfloat16).cpu()
            if m == LINEAR_M[-1]:
                outs[f"int8_linear {m}x{n} f32 out"] = cs.fb.int8_linear(
                    x, w, ws, b, torch.float32).cpu()
                outs[f"int8_linear {m}x{n} no bias"] = cs.fb.int8_linear(
                    x, w, ws, None, torch.bfloat16).cpu()
            del x
    d, t = cs.PP_D, cs.PP_T
    for lead in ((2 * cs.PP_BATCH, t), (cs.PP_BATCH, t), (16461,)):
        x, lns, lnb, wq, ws, b, _ = cs._proj_operands(gen, lead, d, 3 * d)
        outs[f"row3 {lead}"] = cs.fb.fused_ln_int8_matmul(x, lns, lnb, wq, ws, b).cpu()
    f32, bf16 = torch.float32, torch.bfloat16
    for lead in ((2 * cs.PP_BATCH, t), (cs.PP_BATCH, t)):
        for xdt, rdt in ((bf16, bf16), (f32, f32), (bf16, f32), (f32, bf16)):
            x, _, _, wq, ws, b, r = cs._proj_operands(gen, lead, d, d, xdt, rdt)
            key = "row4 (16, 2048)" if lead[0] == 2 * cs.PP_BATCH and xdt == rdt == bf16 else (
                f"row4 {lead} x={str(xdt)[6:]} res={str(rdt)[6:]}")
            outs[key] = cs.fb.int8_matmul_residual(x, r, wq, ws, b).cpu()
            del x, r
    os.makedirs(AB_DIR, exist_ok=True)
    torch.save(outs, os.path.join(AB_DIR, f"{label}_linear.pt"))


def compare(a: str, b: str) -> None:
    """The largest |A - B| of each saved output, whether they are bitwise
    equal, and whether B is within phase 3's tolerance of A (the f32
    gradients: phase 3e's, 1e-4 / 1e-5 relative; the bf16 head-dim-96
    gradients 3e's 2^-6 / 2^-8)."""
    res = {}
    for suffix in ("", "_int8", "_linear", "_f32", "_row1", "_flash"):
        paths = [os.path.join(AB_DIR, f"{x}{suffix}.pt") for x in (a, b)]
        if not all(os.path.exists(path) for path in paths):
            continue
        oa, ob = (torch.load(path) for path in paths)
        for key in oa:
            rel = ((1e-4, 1e-5) if suffix == "_f32" or key.startswith("bwd f32 hd 96")
                   else (2.0 ** -6, 2.0 ** -8) if key.startswith("bwd bf16 hd 96")
                   else (2.0 ** -6, 2.0 ** -10))
            ya, yb = oa[key].float(), ob[key].float()
            err = (ya - yb).abs()
            within = bool(err.max() <= rel[0] * ya.abs().max()
                          and err.mean() <= rel[1] * ya.abs().mean())
            res[key] = dict(max=err.max().item(), bitwise=torch.equal(oa[key], ob[key]),
                            within_tolerance=within)
            print(f"  {key}: max |{a} - {b}| = {res[key]['max']} (bitwise equal: "
                  f"{res[key]['bitwise']}, within phase 3's tolerance: {within})")
    print("AB_COMPARE " + json.dumps(res), flush=True)


def _p50(pipe, prompts) -> float:
    cs._sample(pipe, seed=9, prompts=prompts)  # warm-up
    times = []
    for i in range(3):
        t0 = time.perf_counter()
        cs._sample(pipe, seed=20 + i, prompts=prompts)
        times.append(time.perf_counter() - t0)
    return float(np.percentile(times, 50))


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--compare":
        compare(sys.argv[2], sys.argv[3])
    elif len(sys.argv) == 3 and sys.argv[1] == "--row1":
        row1(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--flash":
        flash(sys.argv[2])
    elif len(sys.argv) == 3 and sys.argv[1] == "--xl-steps":
        xl_steps(sys.argv[2])
    else:
        main(sys.argv[1] if len(sys.argv) > 1 else "tree")

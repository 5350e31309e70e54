"""Where the time of the redesigned int8 kernels goes, on one GPU.

    python3 chip_int8_probe.py

Run from the root of a tree. It builds copies of ``csrc/`` under
``build/int8_probe/``, each with one edit, and times each against the
source as built, in turns (as built, the copy, the copy, as built; CUDA
events and a CUDA graph of 20 launches, ``chip_smoke.graph_ms``):

- ``fused_ln_int8_mlp`` (row 2) at the flagship's 32768 / 16384 rows and
  path B's width (32768 x 768), static scales:
  - ``products only``: the GEMM's epilogue stores nothing (the branch
    around it is never taken), so the two products, the LN row pass and
    the loads ahead of the epilogue remain;
  - ``lockstep``: the two consumer warpgroups meet at one named barrier of
    256 threads each tile, as a first version did, in place of one each;
  - ``inverse per element``: the int8 output's 1 / scale computed in the
    epilogue of every element pair, as the mma.sync GEMM's epilogue did,
    in place of once a launch (the same value);
- ``fused_int8_diffusion_block`` (row 6) at the head's 200 rows, static
  scales:
  - ``phase stamps``: ``%globaltimer`` read by each block after each phase
    (before the grid barrier that ends it) and at the start, reduced over
    the blocks (the earliest start, the latest end of each phase) into a
    device array; printed as microseconds from the start, and timed too.

- ``fused_int8_mlp_postln`` (row 5) at 8 x 1280 and 8 x 768 rows, static
  scales:
  - ``no gelu``: fc1's epilogue quantizes and stores its values without the
    gelu (the identity in its place);
  - ``no exchange``: fc2 normalizes each block's columns by their own
    sums, without the two exchanges over the cluster;
  and each kernel's device time (torch.profiler) in rows 5 and 1 (the
  flagship's 2x and 1x batch) as built.

``python3 chip_int8_probe.py rows15`` runs the rows 1 and 5 part alone.
The copies ``products only``, ``no gelu`` and ``no exchange`` compute wrong
outputs on purpose; they are timed, not checked.

``python3 chip_int8_probe.py linear`` probes the two kernels on the wgmma
GEMM's store epilogues, ``int8_linear`` at every (M, N) of the t2i int8
call (chip_smoke.T2I_LINEAR_M: M = 2304, 3072, 4096, 6144, 10240; qkv N =
3072 with f32 x, the out-projection N = 1024 with bf16 x; K = 1024; bf16
out) and ``fused_ln_int8_matmul`` (row 3) at path B's 32768 and 16384 rows
(768 -> 2304, bf16):

- as built: each kernel's device time by kernel (torch.profiler), so the
  row pass's and the GEMM's time apart, beside the event and graph times;
- ``direct stores``: copies whose bf16 output goes out from the
  accumulator's registers by the threads (the f32 output's path, the first
  wgmma design's), not through shared memory by TMA, in the same shared
  memory layout; outputs bitwise as built's;
- ``no output stores``: copies that stage the output tile but issue no TMA
  store (wrong outputs, timed only): the products, the row pass and the
  epilogue's arithmetic;
- ``block per row`` (``int8_linear``): a copy whose row pass without
  LayerNorm is the first design's (one 128-thread block a row, scalar
  loads, byte stores) in place of one warp a row, also split by the
  profiler; outputs bitwise as built's (and row 5's at 8 x 1280 rows,
  static and per row, whose x quant pass it is too);
- the tile widths: both kernels with 128 x 256 and with 128 x 128 tiles
  (``gemm_plan(..., block_n, tma_store)`` in place of ``store_plan``'s
  choice), the narrow tiles' outputs bitwise the wide tiles'.

Each variant is timed in turns against as built (as built, the variant,
the variant, as built; CUDA events and a graph of 20 launches). The copies
build in parallel.

``python3 chip_int8_probe.py row4`` probes ``int8_matmul_residual`` (row 4:
the row pass without LayerNorm, the wgmma GEMM with the residual epilogue)
at path B's 32768 and 16384 rows (768 -> 768), x and the residual both
bf16 and both f32:

- as built: the row pass's and the GEMM's device time (torch.profiler);
- bf16, ``direct residual``: a copy that takes the f32 residual's path
  for a bf16 one too (the residual prefetched into L2 and loaded by the
  threads after the products, y stored from the registers), not the
  residual tile loaded and the sum stored by TMA; outputs bitwise as
  built's;
- f32, ``no residual loads``: a copy whose epilogue adds zeros in place of
  the residual (wrong outputs, timed only): what reading it costs;
- f32, ``products only``: the copy of row 2's probe whose epilogue stores
  nothing (wrong outputs, timed only): the row pass, the products and the
  loads ahead of the epilogue;
- the tile widths: 128 x 256 and 128 x 128 tiles in turns, the narrow
  tiles' outputs bitwise the wide tiles'.

The last line is ``PROBE {json}``.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "int8_probe"
SRC = cs._build.CSRC

PRODUCTS_ONLY = [
    ("int8_wgmma.cuh", "        if (row0 < M)\n          epilogue_sx<EPI>(",
     "        if (row0 < M && acc[4 * j] == 0x7f7f7f7f)\n          epilogue_sx<EPI>(", 1),
    ("int8_wgmma.cuh", "        if (row0 + 8 < M)\n          epilogue_sx<EPI>(",
     "        if (row0 + 8 < M && acc[4 * j + 2] == 0x7f7f7f7f)\n          epilogue_sx<EPI>(", 1)]
# (the third occurrence is the TMA-store epilogue's, which row 2 does not run)
LOCKSTEP = [("int8_wgmma.cuh", "named_sync(1 + c, 128);", "named_sync(1, 256);", 3)]
PER_ELEMENT = [("int8_epilogue.cuh", "    q.x = q8_rint(epi_act<EPI>(v0) * out_inv);\n"
                "    q.y = q8_rint(epi_act<EPI>(v1) * out_inv);",
                "    const float inv = 1.0f / static_scale(ep.out_amax);\n"
                "    q.x = q8_rint(epi_act<EPI>(v0) * inv);\n    q.y = q8_rint(epi_act<EPI>(v1) * inv);",
                1)]
# row 5's fc1 with its gelu replaced by the identity (the int8 quant and
# stores stay): what the gelu costs in the epilogue (wrong outputs, timed only)
NO_GELU = [("int8_epilogue.cuh",
            "  if (EPI == EPI_GELU_Q8 || EPI == EPI_GELU_F32) return gelu_as(v);",
            "  if (EPI == EPI_GELU_Q8 || EPI == EPI_GELU_F32) return v;", 1)]
# row 5's fc2 without its two cluster exchanges (each block normalizes with
# its own columns' sums: wrong outputs, timed only)
NO_EXCHANGE = [
    ("fused_int8_mlp_postln.cu", "      exchange(0, sum0, sum1, mu0, mu1);\n",
     "      mu0 = sum0;\n      mu1 = sum1;\n", 1),
    ("fused_int8_mlp_postln.cu", "      exchange(1, d0, d1, var0, var1);\n",
     "      var0 = d0;\n      var1 = d1;\n", 1)]
# the no-LN row pass as the first design ran it: one block a row
BLOCK_PER_ROW = [("quant.cuh", "  if (ln_w == nullptr && K <= kQuantMaxK && K % 16 == 0 &&",
                  "  if (false && ln_w == nullptr && K <= kQuantMaxK && K % 16 == 0 &&", 1)]
# the bf16 output of the store epilogues from the registers (epilogue_sx),
# not staged for TMA, in the TMA-store instances' shared memory layout
DIRECT_STORES = [("int8_wgmma.cuh", "    if constexpr (TMA_OUT) {\n      // the bf16 pairs",
                  "    if constexpr (false) {\n      // the bf16 pairs", 1)]
# the residual epilogue adding zeros in place of the residual rows (wrong
# outputs, timed only)
NO_RESIDUAL_LOADS = [("int8_wgmma.cuh", "          if (EPI == EPI_RESIDUAL && row < M && col < N) {",
                      "          if (EPI == EPI_RESIDUAL && row < M && col < 0) {", 1)]
# row 4's bf16 residual on the f32 residual's path (loads and stores by the
# threads) in place of TMA; its plan is patched to match (_direct_plan)
DIRECT_RESIDUAL = [("int8_matmul_residual.cu", "  const int tma_out = res_bf16;",
                    "  const int tma_out = 0;", 1)]
# the staged output tile never stored (wrong outputs, timed only)
NO_OUTPUT_STORES = [
    ("int8_wgmma.cuh",
     "          tma_store_2d(&tm_out, out_s + b * 8192, n0 + 64 * b, mt * BM + 64 * c);",
     "          if (M < 0) tma_store_2d(&tm_out, out_s + b * 8192, n0 + 64 * b, mt * BM);", 1)]
STAMP_FN = """
__device__ unsigned long long nova_int8_probe[16];
// the block's time at mark i: the earliest over the blocks for the start,
// the latest for the end of each phase
__device__ __forceinline__ void stamp(int i) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    if (i == 0)
      atomicMin(&nova_int8_probe[0], t);
    else
      atomicMax(&nova_int8_probe[i], t);
  }
}
"""
STAMPS = [
    ("fused_int8_diffusion_block.cu", "namespace nova {\nnamespace dfb {\n",
     "namespace nova {\nnamespace dfb {\n" + STAMP_FN, 1),
    ("fused_int8_diffusion_block.cu", "  // P1: silu(zc) -> qz (warps 0-3)",
     "  stamp(0);\n  // P1: silu(zc) -> qz (warps 0-3)", 1),
    ("fused_int8_diffusion_block.cu", "  grid_barrier();\n  // P2: stats, gate, h",
     "  stamp(1);\n  grid_barrier();\n  // P2: stats, gate, h", 1),
    ("fused_int8_diffusion_block.cu",
     "  gemm_phase<PH_STATS, STATIC, BF16>(p, p.qz, 0, g0, ng, r0, r1, wbar, smem);\n"
     "  grid_barrier();",
     "  gemm_phase<PH_STATS, STATIC, BF16>(p, p.qz, 0, g0, ng, r0, r1, wbar, smem);\n  stamp(2);\n"
     "  grid_barrier();", 1),
    ("fused_int8_diffusion_block.cu",
     "  gemm_phase<PH_FC1, STATIC, BF16>(p, p.qh, 3 * p.gpb, g0, ng, r0, r1, wbar + 8, smem);\n"
     "  grid_barrier();",
     "  gemm_phase<PH_FC1, STATIC, BF16>(p, p.qh, 3 * p.gpb, g0, ng, r0, r1, wbar + 8, smem);\n"
     "  stamp(3);\n  grid_barrier();", 1),
    ("fused_int8_diffusion_block.cu",
     "  gemm_phase<PH_FC2, STATIC, BF16>(p, p.qa, 4 * p.gpb, g0, ng, r0, r1, wbar + 16, smem);\n"
     "  grid_barrier();",
     "  gemm_phase<PH_FC2, STATIC, BF16>(p, p.qa, 4 * p.gpb, g0, ng, r0, r1, wbar + 16, smem);\n"
     "  stamp(4);\n  grid_barrier();", 1),
    ("fused_int8_diffusion_block.cu", "  row_phase<ROW_POSTLN_GATE>(p, ry, srow);\n}",
     "  row_phase<ROW_POSTLN_GATE>(p, ry, srow);\n  stamp(5);\n}", 1),
    ("fused_int8_diffusion_block.cu", '\n// workspace: ws_bytes at a 256-byte boundary',
     '\nextern "C" int nova_int8_probe_read(unsigned long long* out, int reset) {\n'
     "  if (reset) {\n    unsigned long long init[16];\n"
     "    for (int i = 0; i < 16; ++i) init[i] = i == 0 ? ~0ull : 0ull;\n"
     "    return cudaMemcpyToSymbol(nova::dfb::nova_int8_probe, init, sizeof(init));\n  }\n"
     "  return cudaMemcpyFromSymbol(out, nova::dfb::nova_int8_probe, 16 * sizeof(*out));\n}\n"
     "\n// workspace: ws_bytes at a 256-byte boundary", 1)]
PHASES = ["P1 silu(zc) + x's statistics", "P2 stats + AdaLN", "P4 fc1", "P5 fc2",
          "P6 post-LN, gate, residual"]


def _prebuild(jobs):
    """Build the library of each (name, csrc copy) not yet built, one nvcc
    each, all at once."""
    procs = []
    for name, csrc in jobs:
        cs._build.CSRC = csrc
        out = cs._build._library_path(name)
        cs._build.CSRC = SRC
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cs._build.nvcc_path(), *cs._build._flags(name), "-o", str(out),
               str(csrc / cs._build.SOURCES[name])]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} copy failed to build:\n{log}")


def _copy(tag, edits):
    """csrc/ copied to build/int8_probe/<tag>/ with the edits; each edit's
    text must occur in the source as often as stated (the script fails when
    the source moves on)."""
    dst = OUT / tag / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(SRC, dst)
    for fname, old, new, count in edits:
        f = dst / fname
        text = f.read_text()
        if text.count(old) != count:
            raise AssertionError(f"{tag}: {old[:60]!r} occurs {text.count(old)} times in "
                                 f"{fname}, not {count}")
        f.write_text(text.replace(old, new))
    return dst


def _load(name, csrc):
    """The library of kernel ``name`` built from ``csrc``; the loaded one
    stays as it was."""
    keep = cs._build._loaded.pop(name, None)
    cs._build.CSRC = csrc
    try:
        return cs._build.load(name)
    finally:
        cs._build.CSRC = SRC
        cs._build._loaded[name] = keep


def _turns(name, libs, call, iters):
    """Event and graph ms of ``call`` with each library in turns (A, B, B, A):
    {tag: [events, graph]} as the mean of the two readings."""
    out = {tag: [0.0, 0.0] for tag in libs}
    for tag in list(libs) + list(libs)[::-1]:
        cs._build._loaded[name] = libs[tag]
        out[tag][0] += cs.sync_ms(call, iters) / 2
        out[tag][1] += cs.graph_ms(call) / 2
    return out


def _breakdown(call, calls=20):
    """Device us a call of each kernel ``call()`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
            out[e.key.split("(")[0][:60]] = us / calls
    return out


def rows_1_5(res):
    """Each kernel's device time in rows 1 and 5 as built (torch.profiler);
    row 5 against its copies without the gelu and without the cluster
    exchanges (the profiler runs after the timed turns: its hooks slow
    later launches' host side)."""
    name = "fused_int8_mlp_postln"
    libs = {"as built": cs._build.load(name),
            "no gelu": _load(name, _copy("nogelu", NO_GELU)),
            "no exchange": _load(name, _copy("noexchange", NO_EXCHANGE))}
    gen = torch.Generator(device="cuda").manual_seed(9)
    kw5 = dict(cs._t2i_variants("mlp")[0][1], ln_eps=1e-5)
    calls = []
    for L in (cs.T2I_L["full"], 768):
        ops = cs._t2i_mlp_operands(gen, (cs.T2I_ROWS, L))
        call = lambda ops=ops: cs.fb.fused_int8_mlp_postln(*ops, **kw5)  # noqa: E731
        label = f"row5 {cs.T2I_ROWS * L}"
        for tag in ("no gelu", "no exchange"):
            t = _turns(name, {"as built": libs["as built"], tag: libs[tag]}, call, 20)
            res[f"{label} {tag}"] = t
            print(f"{label}: as built {t['as built'][0]:.4f} ms (graph "
                  f"{t['as built'][1]:.4f}), {tag} {t[tag][0]:.4f} (graph {t[tag][1]:.4f})")
        calls.append((label, call))
    cs._build._loaded[name] = libs["as built"]
    kw1 = cs._variants("attention")[0][1]
    for n in (2 * cs.BATCH, cs.BATCH):
        ops = cs._kernel_operands(gen, n, "attention")
        calls.append((f"row1 {n}", lambda ops=ops: cs.fb.fused_attention_block(*ops, **kw1)))
    for label, call in calls:
        b = _breakdown(call)
        res[f"{label} kernels us"] = b
        print(f"  {label}: " + ", ".join(f"{k} {v:.1f} us" for k, v in b.items()))


LINEAR_N = {"qkv": 3 * cs.D, "proj": cs.D}


def _bitwise(a, b):
    return bool(torch.equal(a, b))


def _force_width(fb, w):
    """store_plan replaced by the plan of w-wide tiles."""
    return lambda m, n, k, sms, tma: fb.gemm_plan(m, n, k, sms, w, tma)


def _tile_turns(fb, call):
    """Event and graph ms of ``call`` with 256- and 128-wide tiles in turns,
    and the outputs of each."""
    keep = fb.store_plan
    tt, ys = {w: [0.0, 0.0] for w in (256, 128)}, {}
    try:
        for w in (256, 128, 128, 256):
            fb.store_plan = _force_width(fb, w)
            ys[w] = call()
            tt[w][0] += cs.sync_ms(call, 20) / 2
            tt[w][1] += cs.graph_ms(call) / 2
    finally:
        fb.store_plan = keep
    return tt, ys


def _variant_turns(name, libs, call):
    """as built against each other variant in turns: {variant: {tag: [events,
    graph]}}."""
    return {tag: _turns(name, {"as built": libs["as built"], tag: libs[tag]}, call, 20)
            for tag in libs if tag != "as built"}


def linear(res):
    """int8_linear and row 3: the row pass / GEMM split as built, the
    variants and the tile widths in turns against as built."""
    fb = cs.fb
    name1, name3, name5 = "int8_linear", "fused_ln_int8_matmul", "fused_int8_mlp_postln"
    copies = {"direct stores": _copy("direct", DIRECT_STORES),
              "no output stores": _copy("nostores", NO_OUTPUT_STORES),
              "block per row": _copy("blockrow", BLOCK_PER_ROW)}
    _prebuild([(n, copies[tag]) for n, tags in ((name1, copies), (name3, list(copies)[:2]),
                                                (name5, ["block per row"])) for tag in tags])
    libs = {"as built": cs._build.load(name1),
            **{tag: _load(name1, copies[tag]) for tag in copies}}
    libs3 = {"as built": cs._build.load(name3),
             **{tag: _load(name3, copies[tag]) for tag in list(copies)[:2]}}
    gen = torch.Generator(device="cuda").manual_seed(11)
    calls = []
    for m in cs.T2I_LINEAR_M:
        for which in LINEAR_N:
            n = LINEAR_N[which]
            x, w, ws, b = cs._linear_operands(gen, m, n)
            call = lambda x=x, w=w, ws=ws, b=b: fb.int8_linear(  # noqa: E731
                x, w, ws, b, torch.bfloat16)
            label = f"int8_linear {m}x{cs.D}->{n}"
            y = call()
            ref = fb.int8_linear_plain(x, w, ws, b, torch.bfloat16)
            err = (y.float() - ref.float()).abs()
            ok = bool(err.max() <= 2.0 ** -6 * ref.float().abs().max()
                      and err.mean() <= 2.0 ** -10 * ref.float().abs().mean())
            bitwise = {}
            for tag in ("direct stores", "block per row"):
                cs._build._loaded[name1] = libs[tag]
                bitwise[tag] = _bitwise(y, call())
            cs._build._loaded[name1] = libs["as built"]
            t = _variant_turns(name1, libs, call)
            tt, ys = _tile_turns(fb, call)
            bitwise["128 x 128 tiles"] = _bitwise(ys[256], ys[128])
            plan = fb.store_plan(m, n, cs.D, 132, True)
            res[label] = dict(turns=t, tile_256=tt[256], tile_128=tt[128], within_tolerance=ok,
                              max_err=err.max().item(), block_n=plan["block_n"],
                              bitwise=bitwise,
                              waves_256=fb.gemm_plan(m, n, cs.D, 132, 256, True)["waves"],
                              waves_128=fb.gemm_plan(m, n, cs.D, 132, 128, True)["waves"])
            _print_variants(label, res[label])
            calls.append((label, call))
            del y, ref, ys
    built5 = cs._build.load(name5)
    rows5 = _load(name5, copies["block per row"])
    ops = cs._t2i_mlp_operands(gen, (cs.T2I_ROWS, cs.T2I_L["full"]))
    for variant, kw in cs._t2i_variants("mlp"):
        y = fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw)
        cs._build._loaded[name5] = rows5
        y2 = fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw)
        cs._build._loaded[name5] = built5
        res[f"row5 {variant} block_per_row_bitwise"] = _bitwise(y, y2)
        print(f"row 5 {variant}: block per row bitwise as built: {_bitwise(y, y2)}")
    del ops
    d = cs.PP_D
    for lead in ((2 * cs.PP_BATCH, cs.PP_T), (cs.PP_BATCH, cs.PP_T)):
        x, lns, lnb, wq, ws, bias, _ = cs._proj_operands(gen, lead, d, 3 * d)
        call = lambda x=x, lns=lns, lnb=lnb, wq=wq, ws=ws, bias=bias: (  # noqa: E731
            fb.fused_ln_int8_matmul(x, lns, lnb, wq, ws, bias))
        m = lead[0] * lead[1]
        label = f"row3 {m}x{d}->{3 * d}"
        y = call()
        ref = fb.fused_ln_int8_matmul_plain(x, lns, lnb, wq, ws, bias)
        err = (y.float() - ref.float()).abs()
        ok = bool(err.max() <= 2.0 ** -6 * ref.float().abs().max()
                  and err.mean() <= 2.0 ** -10 * ref.float().abs().mean())
        cs._build._loaded[name3] = libs3["direct stores"]
        bitwise = {"direct stores": _bitwise(y, call())}
        cs._build._loaded[name3] = libs3["as built"]
        t = _variant_turns(name3, libs3, call)
        tt, ys = _tile_turns(fb, call)
        bitwise["128 x 128 tiles"] = _bitwise(ys[256], ys[128])
        plan = fb.store_plan(m, 3 * d, d, 132, True)
        res[label] = dict(turns=t, tile_256=tt[256], tile_128=tt[128], within_tolerance=ok,
                          max_err=err.max().item(), block_n=plan["block_n"], bitwise=bitwise,
                          waves_256=fb.gemm_plan(m, 3 * d, d, 132, 256, True)["waves"],
                          waves_128=fb.gemm_plan(m, 3 * d, d, 132, 128, True)["waves"])
        _print_variants(label, res[label])
        calls.append((label, call))
        del y, ref, ys
    for label, call in calls:  # the profiler last: its hooks slow later launches
        b = _breakdown(call)
        res[f"{label} kernels us"] = b
        print(f"  {label}: " + ", ".join(f"{k} {v:.1f} us" for k, v in b.items()))
        if label.startswith(name1):
            cs._build._loaded[name1] = libs["block per row"]
            b = _breakdown(call)
            cs._build._loaded[name1] = libs["as built"]
            res[f"{label} block per row kernels us"] = b
            print(f"  {label}, block per row: "
                  + ", ".join(f"{k} {v:.1f} us" for k, v in b.items()))


def _direct_plan(fb, keep):
    """store_plan with the threads' stores for every output."""
    return lambda m, n, k, sms, tma: keep(m, n, k, sms, False)


def row4(res):
    """Row 4 as built (its row pass / GEMM split); bf16 against the copy on
    the direct residual path, f32 against the copies without its residual
    loads and without its epilogue's stores; both tile widths; each in
    turns against as built."""
    fb, name = cs.fb, "int8_matmul_residual"
    copies = {"direct residual": _copy("direct_res", DIRECT_RESIDUAL),
              "no residual loads": _copy("nores", NO_RESIDUAL_LOADS),
              "products only": _copy("products", PRODUCTS_ONLY)}
    _prebuild([(name, c) for c in copies.values()])
    libs = {"as built": cs._build.load(name), **{tag: _load(name, c) for tag, c in copies.items()}}
    keep = fb.store_plan
    gen = torch.Generator(device="cuda").manual_seed(12)
    d, calls = cs.PP_D, []
    for lead in ((2 * cs.PP_BATCH, cs.PP_T), (cs.PP_BATCH, cs.PP_T)):
        for dt in (torch.bfloat16, torch.float32):
            x, _, _, wq, ws, b, r = cs._proj_operands(gen, lead, d, d, dt, dt)
            call = lambda x=x, r=r, wq=wq, ws=ws, b=b: fb.int8_matmul_residual(  # noqa: E731
                x, r, wq, ws, b)
            m = lead[0] * lead[1]
            bf16 = dt == torch.bfloat16
            label = f"row4 {m}x{d}->{d} {str(dt)[6:]}"
            y = call()
            ref = fb.int8_matmul_residual_plain(x, r, wq, ws, b)
            err = (y.float() - ref.float()).abs()
            ok = bool(err.max() <= 2.0 ** -6 * ref.float().abs().max()
                      and err.mean() <= 2.0 ** -10 * ref.float().abs().mean())
            bitwise = {}
            if bf16:
                t = {"as built": [0.0, 0.0], "direct residual": [0.0, 0.0]}
                try:
                    for tag in ("as built", "direct residual", "direct residual", "as built"):
                        cs._build._loaded[name] = libs[tag]
                        fb.store_plan = keep if tag == "as built" else _direct_plan(fb, keep)
                        if tag != "as built":
                            bitwise[tag] = _bitwise(y, call())
                        t[tag][0] += cs.sync_ms(call, 20) / 2
                        t[tag][1] += cs.graph_ms(call) / 2
                finally:
                    fb.store_plan = keep
                    cs._build._loaded[name] = libs["as built"]
                turns = {"direct residual": t}
            else:
                turns = _variant_turns(name, {tag: libs[tag] for tag in (
                    "as built", "no residual loads", "products only")}, call)
            tt, ys = _tile_turns(fb, call)
            bitwise["128 x 128 tiles"] = _bitwise(ys[256], ys[128])
            plan = fb.store_plan(m, d, d, 132, bf16)
            res[label] = dict(turns=turns, tile_256=tt[256], tile_128=tt[128],
                              within_tolerance=ok, max_err=err.max().item(),
                              block_n=plan["block_n"], bitwise=bitwise,
                              waves_256=fb.gemm_plan(m, d, d, 132, 256, bf16)["waves"],
                              waves_128=fb.gemm_plan(m, d, d, 132, 128, bf16)["waves"])
            _print_variants(label, res[label])
            calls.append((label, call))
            del y, ref, ys
    for label, call in calls:  # the profiler last: its hooks slow later launches
        b = _breakdown(call)
        res[f"{label} kernels us"] = b
        print(f"  {label}: " + ", ".join(f"{k} {v:.1f} us" for k, v in b.items()))


def _print_variants(label, r):
    parts = [f"{tag} {v[tag][0]:.4f} (graph {v[tag][1]:.4f}) against as built "
             f"{v['as built'][0]:.4f} (graph {v['as built'][1]:.4f})"
             for tag, v in r["turns"].items()]
    print(f"{label} ({r['block_n']}-wide tiles, plain tolerance {r['within_tolerance']}): "
          + "; ".join(parts)
          + f"; tiles 128 x 256 {r['tile_256'][0]:.4f} (graph {r['tile_256'][1]:.4f}, "
          f"{r['waves_256']:.2f} waves), 128 x 128 {r['tile_128'][0]:.4f} (graph "
          f"{r['tile_128'][1]:.4f}, {r['waves_128']:.2f} waves); bitwise {r['bitwise']}")


def main():
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
    res = {}
    if sys.argv[1:] == ["linear"]:
        cs._build.build_all()
        linear(res)
        _card(res)
        return
    if sys.argv[1:] == ["row4"]:
        cs._build.build_all(["int8_matmul_residual"])
        row4(res)
        _card(res)
        return
    if sys.argv[1:] == ["rows15"]:
        cs._build.build_all(["fused_attention_block", "fused_int8_mlp_postln"])
        rows_1_5(res)
        _card(res)
        return
    cs._build.build_all(["fused_ln_int8_mlp", "fused_int8_diffusion_block",
                         "fused_attention_block", "fused_int8_mlp_postln"])
    mlp = {"as built": cs._build.load("fused_ln_int8_mlp"),
           "products only": _load("fused_ln_int8_mlp", _copy("products", PRODUCTS_ONLY)),
           "lockstep": _load("fused_ln_int8_mlp", _copy("lockstep", LOCKSTEP)),
           "inverse per element": _load("fused_ln_int8_mlp", _copy("inverse", PER_ELEMENT))}
    gen = torch.Generator(device="cuda").manual_seed(9)
    kw = cs._variants("mlp")[0][1]
    for label, ops in (("32768", cs._kernel_operands(gen, 32768, "mlp")),
                       ("16384", cs._kernel_operands(gen, 16384, "mlp")),
                       ("32768x768", list(cs._pp_mlp_operands(gen, 32768)))):
        for tag in ("products only", "lockstep", "inverse per element"):
            t = _turns("fused_ln_int8_mlp", {"as built": mlp["as built"], tag: mlp[tag]},
                       lambda: cs.fb.fused_ln_int8_mlp(*ops, **kw), 20)
            res[f"row2 {label} {tag}"] = t
            print(f"row 2 at {label}: as built {t['as built'][0]:.3f} ms (graph "
                  f"{t['as built'][1]:.3f}), {tag} {t[tag][0]:.3f} (graph {t[tag][1]:.3f})")
        del ops
        torch.cuda.empty_cache()
    cs._build._loaded["fused_ln_int8_mlp"] = mlp["as built"]

    name = "fused_int8_diffusion_block"
    built = cs._build.load(name)
    stamped = _load(name, _copy("stamps", STAMPS))
    read = stamped.nova_int8_probe_read
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    ops = cs._diffusion_operands(gen, cs.T2I_ROWS * cs.T2I_PAD_P)
    kw = cs._t2i_variants("diffusion")[0][1]
    call = lambda: cs.fb.fused_int8_diffusion_block(*ops, n2_eps=1e-5, **kw)  # noqa: E731
    t = _turns(name, {"as built": built, "phase stamps": stamped}, call, 200)
    res["row6 200"] = t
    print(f"row 6 at 200 rows: as built {t['as built'][0]:.4f} ms (graph "
          f"{t['as built'][1]:.4f}), with phase stamps {t['phase stamps'][0]:.4f} (graph "
          f"{t['phase stamps'][1]:.4f})")
    cs._build._loaded[name] = stamped
    marks = []
    for _ in range(5):
        call()
        torch.cuda.synchronize()
        read(None, 1)
        call()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 16)()
        read(buf, 0)
        marks.append([(buf[i] - buf[0]) / 1e3 for i in range(1, 6)])
    cs._build._loaded[name] = built
    ends = [sorted(m[i] for m in marks)[2] for i in range(5)]  # the median of 5 calls
    res["row6 phase ends us"] = dict(zip(PHASES, ends))
    prev = 0.0
    for label, end in zip(PHASES, ends):
        print(f"  {label}: ends at {end:.2f} us ({end - prev:.2f} us after the last phase)")
        prev = end
    rows_1_5(res)
    _card(res)


def _card(res):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card (nvidia-smi name, power limit): {smi}")
    res["card"] = smi
    print("PROBE " + json.dumps(res))


if __name__ == "__main__":
    main()

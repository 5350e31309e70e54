"""Where the time of the forward flash kernels goes, on one GPU.

    python3 chip_fwd_probe.py

Run from the root of a tree. It builds copies of ``csrc/`` under
``build/fwd_probe/``, each with one edit to ``flash_fwd.cuh`` (the main
loop of the bf16 ``flash_attention`` forward and of
``flash_attention_static``), and times each copy (CUDA graph of 20
launches, ``chip_smoke.graph_ms``) at path A's (16, 12, 2048, 64) and the t2i
(8, 16, 1280, 64), no bias, in turns (as built, the copies, then the same in
reverse order; the mean of the two readings):

- ``two warpgroups``: items of 128 rows in two consumer warpgroups;
- ``no turns``: the warpgroups issue their products without taking turns;
- ``no exponentials``: the softmax without its ex2 (every other step kept);
- ``products only``: no softmax and no copies after the first stages (the
  wgmma products, the packing of p, the loop's waits and barriers);
- ``probe``: ``clock64`` read at the boundaries of the loop's steps, the
  cycles of each step summed per warpgroup by lane 0 of its first warp
  into a device counter; printed as cycles per tile per warpgroup (their
  sum is a warpgroup's cycles per key tile; the warpgroups run at once).
  The step that opens an item also waits for the last p v of the item
  before and writes its output there.

The copies compute wrong outputs on purpose (except ``two warpgroups``,
``no turns`` and ``probe``): they are timed, not checked. The last line is
``PROBE {json}``.

``python3 chip_fwd_probe.py f32`` does the same for the f32 route's kernel
(``flash_fwd_f32_kernel`` in ``flash_attention.cu``) at (8, 16, 1280, 64) f32,
no bias, each copy timed from a CUDA graph in turns against the source as
built, its ptxas registers and spills printed: without the exponentials;
with ``exp2f`` of log2e-scaled logits in place of ``expf``; without the
softmax (the products and P's stores kept); without Q Kᵀ; without P V;
the Q Kᵀ loop unrolled by 2 and by 4; the P V loop unrolled by 2; and a
probed copy whose warps add the ``clock`` cycles of each step of a key tile
into shared memory, printed per tile per warp (the probes' own cost is in
the probed copy's time).
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

NOTURN = [("    named_sync(turn, TURN);\n", "", 2), ("  named_sync(turn, TURN);\n", "", 1),
          ("  if (w == NWG - 1) named_arrive(1, TURN);  // warpgroup 0 takes the first turn\n", "",
           1),
          ("    named_arrive(next_turn, TURN);\n", "", 2),
          ("  if (w != NWG - 1) named_arrive(next_turn, TURN);\n", "", 1)]
NOEXP = [("          sf[i] = ex2(x);", "          sf[i] = x;", 1)] + [
    (f"      sf[i{o}] = ex2(fmaf(sf[i{o}], mul, -mn{r}));",
     f"      sf[i{o}] = fmaf(sf[i{o}], mul, -mn{r});", 1)
    for o, r in (("", 0), (" + 1", 0), (" + 2", 1), (" + 3", 1))]
PRODUCTS = [("    const int kvalid = p.Lk - kt * BK;  // keys of this tile below Lk\n",
             "    if (kt >= 0) return;\n    const int kvalid = p.Lk - kt * BK;\n", 1),
            ("      issue_kv(s, kt_r, b_r, h_r);\n", "      mbar_expect_tx(bar_full + 8 * s, 0);\n", 1)]
STEPS = ["wait for the turn", "S and PV issued", "release, next K / V, wait for S",
         "softmax", "wait for PV", "p packed, O rescaled", "loop, item start"]
PROBE = [
    ("namespace nova {\nnamespace fwd {\n",
     "namespace nova {\nnamespace fwd {\n__device__ unsigned long long nova_fwd_probe[3][8];\n"
     "#define PROBE(k) { const long long c_ = clock64(); probe_acc[k] += c_ - probe_t; "
     "probe_t = c_; }\n", 1),
    ("  bool prev_first = true;  // tile gi - 1 opened its item\n",
     "  bool prev_first = true;\n  long long probe_acc[8] = {}, probe_t = clock64();\n", 1),
    ("    named_sync(turn, TURN);\n    float sf[64];\n    int si[64];\n    wgmma_fence();\n"
     "    issue_s(sf, si, j, s);\n",
     "    PROBE(6)\n    named_sync(turn, TURN);\n    PROBE(0)\n    float sf[64];\n    int si[64];\n"
     "    wgmma_fence();\n    issue_s(sf, si, j, s);\n", 1),
    ("    named_arrive(next_turn, TURN);\n    // while S runs",
     "    named_arrive(next_turn, TURN);\n    PROBE(1)\n    // while S runs", 1),
    ("    softmax(sf, si, j, kt, s);\n",
     "    PROBE(2)\n    softmax(sf, si, j, kt, s);\n    PROBE(3)\n", 1),
    ("    keep_p(sf, kt);\n    prev_first = opens;\n",
     "    PROBE(4)\n    keep_p(sf, kt);\n    PROBE(5)\n    prev_first = opens;\n", 1),
    ("  // the last tile's p v\n",
     "  if (lt == 0 && wi == 0) {\n    for (int k = 0; k < 7; ++k) "
     "atomicAdd(&nova_fwd_probe[w][k], (unsigned long long)probe_acc[k]);\n"
     "    atomicAdd(&nova_fwd_probe[w][7], (unsigned long long)(G - 1));\n  }\n"
     "  // the last tile's p v\n", 1)]
VARIANTS = {"two warpgroups": ([("static constexpr int NWG = HD == 64 ? 3 : 2;",
                                 "static constexpr int NWG = 2;", 1)],
                               dict(FWD_TILING={64: (2, 4), 96: (2, 3)})),
            "no turns": (NOTURN, {}),
            "no exponentials": (NOEXP, {}),
            "products only": (PRODUCTS, {}),
            "probe": (PROBE, {})}
LIBS = ("flash_attention", "flash_attention_static")
PROBE_READ = ('\nextern "C" int nova_fwd_probe_read(unsigned long long* out, int reset) {\n'
              "  unsigned long long zero[24] = {};\n"
              "  if (reset) return cudaMemcpyToSymbol(nova::fwd::nova_fwd_probe, zero, sizeof(zero));\n"
              "  return cudaMemcpyFromSymbol(out, nova::fwd::nova_fwd_probe, sizeof(zero));\n}\n")


def _build_variants(root: Path) -> dict:
    """Each variant's copy of csrc/ built into its own libraries, one nvcc
    per library, all at once -> {(variant, library): CDLL}."""
    build = cs._build
    procs = []
    for name, (edits, _) in VARIANTS.items():
        d = root / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        text = (d / "flash_fwd.cuh").read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} found {text.count(old)} times, not {count}")
            text = text.replace(old, new)
        if name == "probe":
            text += PROBE_READ
        (d / "flash_fwd.cuh").write_text(text)
        for lib in LIBS:
            out = d / f"lib{lib}.so"
            cmd = [build.nvcc_path(), *build._flags(lib), "-o", str(out), str(d / build.SOURCES[lib])]
            procs.append((name, lib, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                           stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, out, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name} {lib}: nvcc failed\n{log[-3000:]}")
        libs[(name, lib)] = ctypes.CDLL(str(out))
    return libs


F32_SRC = "flash_attention.cu"
F32_INSTANCE = "flash_fwd_f32_kernelILb0ELb0E"
F32_SOFTMAX = "    // online softmax of the tile's scores, once a tile\n#pragma unroll\n"
F32_STEPS = [("wait for K", "+    mbar_wait(bar_k, kt & 1);\n"),
             ("Q K^T", "    // the additive term of the thread's keys"),
             ("key bias, barrier, next K issued", F32_SOFTMAX),
             ("softmax", "    // P[r_i][tj + 8 j] = f32_at("),
             ("P stored, __syncwarp", "+    __syncwarp();  // the warp's P rows are written\n"),
             ("wait for V", "+    mbar_wait(bar_v, kt & 1);\n"),
             ("P V", "    __syncthreads();  // V is read\n"),
             ("barrier, next V issued", "  // l over the row's 8 lanes")]
F32_VARIANTS = {
    "no exponentials": [("        s[i][j] = expf(s[i][j] - mn);",
                         "        s[i][j] = s[i][j] - mn;", 1),
                        ("      const float alpha = expf(m[i] - mn);",
                         "      const float alpha = m[i] - mn;", 1)],
    "exp2f": [("        s[i][j] = expf(s[i][j] - mn);",
               "        s[i][j] = exp2f((s[i][j] - mn) * 1.44269504088896341f);", 1),
              ("      const float alpha = expf(m[i] - mn);",
               "      const float alpha = exp2f((m[i] - mn) * 1.44269504088896341f);", 1)],
    "no softmax": [(F32_SOFTMAX + "    for (int i = 0; i < 8; ++i) {",
                    "    for (int i = 0; i < 0; ++i) {", 1)],
    "no Q K^T": [("    for (int c = 0; c < 16; ++c) {", "    for (int c = 0; c < 0; ++c) {", 1)],
    "no P V": [("    for (int cc = 0; cc < 8; ++cc) {", "    for (int cc = 0; cc < 0; ++cc) {", 1)],
    "Q K^T unrolled by 2": [("#pragma unroll 1\n    for (int c = 0; c < 16; ++c) {",
                             "#pragma unroll 2\n    for (int c = 0; c < 16; ++c) {", 1)],
    "Q K^T unrolled by 4": [("#pragma unroll 1\n    for (int c = 0; c < 16; ++c) {",
                             "#pragma unroll 4\n    for (int c = 0; c < 16; ++c) {", 1)],
    "P V unrolled by 2": [("#pragma unroll 1\n    for (int cc = 0; cc < 8; ++cc) {",
                           "#pragma unroll 2\n    for (int cc = 0; cc < 8; ++cc) {", 1)],
}


def _f32_probe_edits(text: str) -> str:
    """flash_attention.cu with clock probes at the f32 kernel's steps: each
    warp's lane 0 adds a step's cycles into shared memory, and at the end
    into a device counter (the last slot counts warps x tiles)."""
    text = text.replace("namespace nova {\n", (
        "__device__ unsigned long long nova_fwd32_probe[9];\n"
        "#define PROBE(k) { const unsigned c_ = static_cast<unsigned>(clock64()); "
        "if (lane == 0) atomicAdd(&probe_sm[warp][k], c_ - probe_t); probe_t = c_; }\n"
        "namespace nova {\n"), 1)
    kernel = text.index("    flash_fwd_f32_kernel(")
    head, body = text[:kernel], text[kernel:]
    edits = [("  extern __shared__ unsigned char smem_raw[];\n",
              "  extern __shared__ unsigned char smem_raw[];\n"
              "  __shared__ unsigned probe_sm[4][8];\n"
              "  if (threadIdx.x < 32) probe_sm[threadIdx.x >> 3][threadIdx.x & 7] = 0;\n"),
             ("  for (int kt = 0; kt < nk; ++kt) {\n",
              "  unsigned probe_t = static_cast<unsigned>(clock64());\n"
              "  for (int kt = 0; kt < nk; ++kt) {\n"),
             ("  // l over the row's 8 lanes",
              "  if (lane == 0) {\n    for (int k = 0; k < 8; ++k) "
              "atomicAdd(&nova_fwd32_probe[k], (unsigned long long)probe_sm[warp][k]);\n"
              "    atomicAdd(&nova_fwd32_probe[8], (unsigned long long)nk);\n  }\n"
              "  // l over the row's 8 lanes")]
    for n, (_, anchor) in enumerate(F32_STEPS):
        after = anchor.startswith("+")
        anchor = anchor.lstrip("+")
        probe = f"    PROBE({n})\n" if n < 7 else "    PROBE(7)\n  }\n\n"
        if n == 7:  # the loop's last line
            anchor = "    if (tid == 0 && kt + 1 < nk) load_v(kt + 1);\n  }\n\n"
            edits.append((anchor, anchor[:-5] + probe))
        else:
            edits.append((anchor, anchor + probe if after else probe + anchor))
    for old, new in edits:
        if body.count(old) != 1:
            raise RuntimeError(f"probe: {old!r} found {body.count(old)} times, not 1")
        body = body.replace(old, new)
    return head + body + (
        '\nextern "C" int nova_fwd32_probe_read(unsigned long long* out, int reset) {\n'
        "  unsigned long long zero[9] = {};\n"
        "  if (reset) return cudaMemcpyToSymbol(nova_fwd32_probe, zero, sizeof(zero));\n"
        "  return cudaMemcpyFromSymbol(out, nova_fwd32_probe, sizeof(zero));\n}\n")


def _ptxas(log: str, kernel: str) -> str:
    """The registers and spill line of ``kernel`` in an nvcc -Xptxas -v log."""
    lines, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and ("registers" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return "; ".join(lines)


def f32_main() -> None:
    """The f32 mode (module docstring)."""
    fa, build = cs.fa, cs._build
    lib = "flash_attention"
    build.build_all([lib])
    base = build.load(lib)
    root = Path(build.BUILD_DIR).parent / "fwd_probe_f32"
    procs, libs, ptxas = [], {}, {"as built": _ptxas(build.build_log(lib), F32_INSTANCE)}
    for name, edits in [*F32_VARIANTS.items(), ("probe", None)]:
        d = root / name.replace(" ", "_").replace("^", "")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        text = (d / F32_SRC).read_text()
        if edits is None:
            text = _f32_probe_edits(text)
        for old, new, count in edits or []:
            if text.count(old) != count:
                raise RuntimeError(f"{name}: {old!r} found {text.count(old)} times, not {count}")
            text = text.replace(old, new)
        (d / F32_SRC).write_text(text)
        out = d / f"lib{lib}.so"
        cmd = [build.nvcc_path(), *build._flags(lib), "-o", str(out), str(d / F32_SRC)]
        procs.append((name, out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                  stderr=subprocess.STDOUT, text=True)))
    for name, out, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(out))
        ptxas[name] = _ptxas(log, F32_INSTANCE)
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((8, 16, 1280, 64), generator=gen, device="cuda") for _ in range(3))

    def call():
        fa.flash_attention_with_lse(q, k, v)

    times = {}
    for name in ["as built", *libs, *reversed(list(libs)), "as built"]:
        build._loaded[lib] = base if name == "as built" else libs[name]
        times.setdefault(name, []).append(cs.graph_ms(call))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"card": smi, "shape": [8, 16, 1280, 64, "f32"],
           "graph_ms": {n: sum(t) / len(t) for n, t in times.items()}, "ptxas": ptxas}
    for name, ms in res["graph_ms"].items():
        print(f"  {name:<22} {ms:.4f} ms from a graph; ptxas: {ptxas[name]}")
    read = libs["probe"].nova_fwd32_probe_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    build._loaded[lib] = libs["probe"]
    counts = (ctypes.c_ulonglong * 9)()
    torch.cuda.synchronize()
    read(None, 1)
    call()
    torch.cuda.synchronize()
    read(ctypes.addressof(counts), 0)
    build._loaded[lib] = base
    res["cycles_per_tile_per_warp"] = {step: counts[n] / max(counts[8], 1)
                                       for n, (step, _) in enumerate(F32_STEPS)}
    print("  cycles per key tile per warp (probed copy):")
    for step, cyc in res["cycles_per_tile_per_warp"].items():
        print(f"    {step:<36} {cyc:8.1f}")
    print(f"    {'sum':<36} {sum(res['cycles_per_tile_per_warp'].values()):8.1f}")
    print(f"card: {smi}")
    print("PROBE " + json.dumps(res))


def main() -> None:
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
    if sys.argv[1:] == ["f32"]:
        return f32_main()
    fa, build = cs.fa, cs._build
    build.build_all(list(LIBS))
    base = {lib: build.load(lib) for lib in LIBS}
    libs = _build_variants(Path(build.BUILD_DIR).parent / "fwd_probe")
    gen = torch.Generator(device="cuda").manual_seed(9)
    cases = {}
    for shape in ((16, 12, 2048, 64), (8, 16, 1280, 64)):
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(3))
        cases[f"forward {shape}"] = ("flash_attention",
                                     lambda q=q, k=k, v=v: fa.flash_attention_with_lse(q, k, v))
    q, k, v, _ = cs._static_attention_operands(gen, 1280, "none")
    smax = torch.tensor(9.0, device="cuda")
    cases["static (8, 16, 1280, 64)"] = ("flash_attention_static",
                                         lambda: fa.flash_attention_static(q, k, v, smax))
    defaults = {"FWD_TILING": fa.FWD_TILING}
    order = ["as built", *VARIANTS, *reversed(VARIANTS), "as built"]
    times = {}
    for name in order:
        for key, val in {**defaults, **VARIANTS.get(name, ({}, {}))[1]}.items():
            setattr(fa, key, val)
        for case, (lib, fn) in cases.items():
            build._loaded[lib] = base[lib] if name == "as built" else libs[(name, lib)]
            times.setdefault(case, {}).setdefault(name, []).append(cs.graph_ms(fn))
    for key, val in defaults.items():
        setattr(fa, key, val)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"card": smi, "ms": {c: {n: sum(t) / len(t) for n, t in v.items()} for c, v in
                               times.items()}}
    for case, row in res["ms"].items():
        print(f"{case}: " + ", ".join(f"{n} {ms:.4f} ms" for n, ms in row.items()))

    res["cycles_per_tile"] = {}
    for case, (lib, fn) in cases.items():
        read = libs[("probe", lib)].nova_fwd_probe_read
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        build._loaded[lib] = libs[("probe", lib)]
        counts = (ctypes.c_ulonglong * 24)()
        torch.cuda.synchronize()
        read(None, 1)
        fn()
        torch.cuda.synchronize()
        read(ctypes.addressof(counts), 0)
        per_wg = [{step: counts[8 * w + n] / max(counts[8 * w + 7], 1)
                   for n, step in enumerate(STEPS)} for w in range(3)]
        res["cycles_per_tile"][case] = per_wg
        print(f"{case}, cycles per key tile (warpgroups 0, 1, 2):")
        for step in STEPS:
            print(f"  {step:<44} " + "  ".join(f"{wg[step]:7.0f}" for wg in per_wg))
        print(f"  {'sum':<44} " + "  ".join(f"{sum(wg.values()):7.0f}" for wg in per_wg))
    for lib in LIBS:
        build._loaded[lib] = base[lib]
    print(f"card: {smi}")
    print("PROBE " + json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())

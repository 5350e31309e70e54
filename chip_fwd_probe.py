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
VARIANTS = {"two warpgroups": ([("constexpr int NWG = 3;", "constexpr int NWG = 2;", 1)],
                               dict(FWD_WARPGROUPS=2, FWD_BLOCK_Q=128)),
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


def main() -> None:
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
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
    defaults = {key: getattr(fa, key) for key in ("FWD_WARPGROUPS", "FWD_BLOCK_Q")}
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

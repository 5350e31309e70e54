"""Where the time of the bf16 flash backward goes, on one GPU.

    python3 chip_bwd_probe.py

Run from the root of a tree. At the training shape (8, 16, 1280, 64), no
bias, it times (CUDA events, 50 launches after a warm-up) each kernel of the
bf16 backward (prep, dkvq, cast), the port's whole backward through autograd
from a graph built once, and SDPA's backward beside it. Then it builds a
probed copy of ``csrc/flash_attention_bwd.cu`` under ``build/bwd_probe/``:
the dkvq kernel reads ``clock64`` at the boundaries of its per-tile steps,
and lane 0 of every warp adds the cycles of each step into a device
counter. It prints the cycles per query tile per warp of each step (their
sum is the cycles a warp spends on one tile), and the probed kernel's time
(the probes cost a few percent). The last line is ``PROBE {json}``.
"""

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

L, ROWS = 1280, 8  # the training step's decoder-half attention, (8, 16, 1280, 64)
# (name, the line of the dkvq loop the probe goes before; after it for "+")
STEPS = [("wait for the tile's copies", "+    mbar_wait(bar_full + 8 * s"),
         ("S^T and dP^T issued, wait for S^T", "+    fence_regs(st);"),
         ("p (exp2)", "    unsigned pa[4][4];"),
         ("dV issued, wait for dP^T", "+    fence_regs(dp);"),
         ("dS, hi / lo to shared memory", "    // dK += dS^T Q"),
         ("dK issued, dS barrier", "    float dq[32];"),
         ("dQ issued and waited for", "    fence_regs(dq);"),
         ("dq part out, refill, next tile", None)]


def _probed_source(dst: Path) -> None:
    """A copy of csrc/ with clock64 probes in the dkvq kernel's loop."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(cs._build.CSRC, dst)
    src = dst / "flash_attention_bwd.cu"
    lines = src.read_text().split("\n")
    loop = lines.index("  for (int qt = 0; qt < nq; ++qt) {")
    end = next(i for i in range(loop, len(lines))
               if lines[i].startswith('  if (lt == 0) asm volatile("cp.async.bulk.wait_group 0;"'))
    probes = {loop: ["  unsigned long long probe_t = clock64(), probe_acc[8] = {};"],
              end: ["  PROBE(7)", "  if (lane == 0)",
                    "    for (int n = 0; n < 8; ++n) atomicAdd(&nova_bwd_probe[n], probe_acc[n]);"]}
    for n, (_, anchor) in enumerate(STEPS[:-1]):
        after = anchor.startswith("+")
        i = next(i for i in range(loop, end) if lines[i].startswith(anchor.lstrip("+")))
        probes.setdefault(i + after, []).append(f"    PROBE({n})")
    first = next(i for i in range(loop, end) if lines[i].startswith("    mbar_wait(bar_full"))
    probes.setdefault(first, []).insert(0, "    PROBE(7)")  # the previous tile's tail
    out = []
    for i, line in enumerate(lines):
        out += probes.get(i, [])
        out.append(line)
    text = "\n".join(out).replace("namespace nova {", (
        "__device__ unsigned long long nova_bwd_probe[8];\n"
        "#define PROBE(n) { const unsigned long long c_ = clock64(); "
        "probe_acc[n] += c_ - probe_t; probe_t = c_; }\n"
        "namespace nova {"), 1)
    text += ('\nextern "C" int nova_bwd_probe_read(unsigned long long* out, int reset) {\n'
             "  unsigned long long zero[8] = {};\n"
             "  if (reset) return cudaMemcpyToSymbol(nova_bwd_probe, zero, sizeof(zero));\n"
             "  return cudaMemcpyFromSymbol(out, nova_bwd_probe, sizeof(zero));\n}\n")
    src.write_text(text)


def main() -> None:
    if not torch.cuda.is_available():
        cs._fail("CUDA is not available: this script runs on the GPU only", 2)
    fa, build = cs.fa, cs._build
    build.build_all(["flash_attention", "flash_attention_bwd"])
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, _ = cs._static_attention_operands(gen, L, "none", rows=ROWS)
    o, lse = fa.flash_attention_with_lse(q, k, v)
    do = torch.randn(o.shape, generator=gen, device="cuda").to(torch.bfloat16)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    res = {"card": smi, "shape": [ROWS, cs.HEADS, L, 64]}
    o_lib = torch.nn.functional.scaled_dot_product_attention(*ins)
    res["sdpa_bwd_ms"] = cs.sync_ms(lambda: torch.autograd.grad(o_lib, ins, do,
                                                                retain_graph=True), 50)
    o_port = fa.flash_attention(*ins)
    res["autograd_bwd_ms"] = cs.sync_ms(lambda: torch.autograd.grad(o_port, ins, do,
                                                                    retain_graph=True), 50)
    launches, _ = fa._bwd_operands(q, k, v, None, None, o, lse, do)
    for name in fa.BWD_KERNELS:
        res[f"{name}_ms"] = cs.sync_ms(lambda: fa.run_bwd(launches, (name,)), 50)

    probe_dir = Path(build.BUILD_DIR).parent / "bwd_probe"
    _probed_source(probe_dir)
    build.CSRC = probe_dir
    build._loaded.pop("flash_attention_bwd", None)
    so = build.load("flash_attention_bwd")
    read = so.nova_bwd_probe_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    res["probed_dkvq_ms"] = cs.sync_ms(
        lambda: fa.run_bwd(launches, ("flash_attention_bwd_dkvq",)), 50)
    counts = (ctypes.c_ulonglong * 8)()
    torch.cuda.synchronize()
    read(None, 1)
    fa.run_bwd(launches, ("flash_attention_bwd_dkvq",))
    torch.cuda.synchronize()
    read(ctypes.addressof(counts), 0)
    plan = fa.bwd_plan(ROWS, cs.HEADS, L, L)
    tiles = 8 * plan["key_tiles"] * ROWS * cs.HEADS * plan["q_tiles"]  # warps x blocks x tiles
    res["cycles_per_tile_per_warp"] = {name: counts[n] / tiles for n, (name, _) in enumerate(STEPS)}
    res["cycles_per_tile"] = sum(counts) / tiles
    for name, cyc in res["cycles_per_tile_per_warp"].items():
        print(f"  {name:<36} {cyc:8.1f} cycles per tile per warp")
    print(f"card: {smi}")
    print("PROBE " + json.dumps(res))


if __name__ == "__main__":
    sys.exit(main())

"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source in ``nova_pointcloud_tpu_torch/csrc/*.cu`` becomes one shared
library with a plain C interface, compiled by ``nvcc`` for ``sm_90a`` into
``build/kernels/`` at the repository root (listed in ``.gitignore``). The
library's file name carries a hash of its sources and flags, so an edited
source is rebuilt and a stale library is never loaded. ``build_all`` starts
one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and a
machine without CUDA has no ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = {
    "fused_attention_block": "fused_attention_block.cu",
    "fused_ln_int8_mlp": "fused_ln_int8_mlp.cu",
    "fused_ln_int8_matmul": "fused_ln_int8_matmul.cu",
    "int8_matmul_residual": "int8_matmul_residual.cu",
    "flash_attention": "flash_attention.cu",
    "fused_int8_mlp_postln": "fused_int8_mlp_postln.cu",
    "fused_int8_diffusion_block": "fused_int8_diffusion_block.cu",
    "flash_attention_static": "flash_attention_static.cu",
    "int8_linear": "int8_linear.cu",
    "flash_attention_bwd": "flash_attention_bwd.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# The int8 kernels round a*b+c twice, as their plain versions do (every int8
# code agrees); the attention cores have no such identity to keep (the static
# kernel's int8 quant pass only multiplies, so contraction leaves its codes).
FMAD = {"flash_attention": "-fmad=true", "flash_attention_bwd": "-fmad=true",
        "flash_attention_static": "-fmad=true"}

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = Path("/usr/local/cuda/bin/nvcc")
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _flags(name: str):
    return [*NVCC_FLAGS, FMAD.get(name, "-fmad=false")]


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        if src.suffix == ".cuh" or src.name == SOURCES[name]:
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every (or the named) kernel library not yet built, one
    ``nvcc`` per source in parallel. Returns seconds per library built;
    raises with the compiler's output if any build fails."""
    names = list(SOURCES if names is None else names)
    todo = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(n), "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        seconds[n] = time.perf_counter() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {p.returncode}) ---\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, shared memory,
    spills) from the last build of ``name`` in this checkout."""
    p = BUILD_DIR / f"{name}.log"
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib

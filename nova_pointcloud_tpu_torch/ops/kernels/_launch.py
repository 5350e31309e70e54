"""What every kernel wrapper of the port shares: the launch counts, the
choice between a kernel and its plain version, and the ctypes call.

A wrapper runs its plain version for a CPU tensor and launches its CUDA
kernel for a CUDA tensor; it never falls back from one to the other.
``use_plain_kernels()`` routes CUDA tensors to the plain versions too, to run
a whole path with and without its kernels; no pipeline turns it on.
``LAUNCHES[name]`` goes up by one each time a wrapper launches its kernel and
nowhere else.
"""

import contextlib
import ctypes
import functools
from typing import Optional

import torch

LAUNCHES = {"fused_attention_block": 0, "fused_ln_int8_mlp": 0,
            "fused_ln_int8_matmul": 0, "int8_matmul_residual": 0,
            "flash_attention": 0, "fused_int8_mlp_postln": 0,
            "fused_int8_diffusion_block": 0, "flash_attention_static": 0,
            "int8_linear": 0, "flash_attention_bwd_f32": 0,
            "flash_attention_bwd_prep": 0, "flash_attention_bwd_dkvq": 0,
            "flash_attention_bwd_dq_cast": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv_f32": 0,
            "flash_attention_bwd_dq_f32": 0}


class _Route:
    plain_on_cuda = False


_route = _Route()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def use_plain_kernels():
    """Inside this block the wrappers run their plain versions on CUDA
    tensors too (and count nothing)."""
    prev = _route.plain_on_cuda
    _route.plain_on_cuda = True
    try:
        yield
    finally:
        _route.plain_on_cuda = prev


def plain_route(x: torch.Tensor) -> bool:
    """True when the wrapper given ``x`` runs its plain version."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device} for a fused kernel")
    return _route.plain_on_cuda


def lib(name: str, argtypes, library: Optional[str] = None):
    """The built library of kernel ``name`` (or the named ``library``, which
    holds several kernels) and its entry point ``nova_<name>``."""
    from nova_pointcloud_tpu_torch.ops.kernels import _build

    so = _build.load(library or name)
    fn = getattr(so, "nova_" + name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        so.nova_error_string.argtypes = [ctypes.c_int]
        so.nova_error_string.restype = ctypes.c_char_p
    return so, fn


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def dtype_flag(t: torch.Tensor, what: str) -> int:
    """1 for bfloat16, 0 for float32; anything else raises."""
    if t.dtype == torch.bfloat16:
        return 1
    if t.dtype == torch.float32:
        return 0
    raise TypeError(f"{what} must be float32 or bfloat16, got {t.dtype}")


def run(so, fn, args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel launch failed: "
                           f"{so.nova_error_string(rc).decode()} (error {rc})")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sms(dev) -> int:
    """Streaming multiprocessors of the card that holds ``dev``."""
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


def stream(dev) -> int:
    """The current CUDA stream of ``dev`` as a pointer (the raw query:
    ``torch.cuda.current_stream`` takes about 10 us of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)

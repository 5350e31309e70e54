"""The pieces around the CUDA code of ``int8_matmul_residual`` (row 4, the
split int8 path's attention out-projection), whose product runs on the
wgmma + TMA GEMM (``csrc/int8_wgmma.cuh``) with the residual epilogue, on
the CPU: its launch plan (``store_plan``: a bf16 residual loaded and the
sum stored through shared memory by TMA, an f32 one by the threads) at path
B's row counts and ragged ones; the launch arguments the
wrapper hands over in all four x / residual dtype pairs (the launch and the
card's SM count replaced by a recorder and a constant, so CPU tensors take
the CUDA route up to the recorded launch); every argument check raising
before a launch; and unaligned x, residual and weight views copied before
the launch (TMA and the row pass read 16-byte-aligned addresses).

Tolerances: none; the plans and the recorded arguments are exact.
"""

import numpy as np
import pytest
import torch

from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nova_pointcloud_tpu_torch.ops.kernels import fused_block as fb
from nova_pointcloud_tpu_torch.ops.quantization import quantize_weight_kmajor

SMS = 132  # the H100's streaming multiprocessors
SMEM_LIMIT = 232448  # a block's shared memory on the H100
D = 768  # path B's width (pc_d8w768)
F32, BF16 = torch.float32, torch.bfloat16


def wg_smem(block_n, tma):
    """csrc/int8_wgmma.cuh: 4 stages (3 for 256-wide tiles with a TMA
    output) of a 128 x 128-byte A tile and a block_n x 128-byte W tile, a
    full and an empty mbarrier a stage; with a TMA output (a bf16 residual
    and y) an mbarrier a consumer for its residual tile; the tile's block_n
    f32 column scales and biases for each of the two consumer warpgroups;
    with a TMA output, at the next 1 KB boundary, each consumer's 64 x
    block_n bf16 tile (the residual in, the sum out); 1 KB to align."""
    stages = 3 if tma and block_n == 256 else 4
    end = stages * (128 + block_n) * 128 + stages * 2 * 8 + 2 * 2 * block_n * 4
    if tma:
        end = (end + 2 * 8 + 1023) // 1024 * 1024 + 2 * 64 * block_n * 2
    return end + 1024


RESIDUAL_PLANS = [  # m (K = N = 768): m tiles, n tiles, grid, tiles a block, tile width
    # path B at the CFG steps' 2x batch (16 x 2048 points): 5.82 waves of
    # wide tiles keep them (12 narrow rounds take as many columns as 6 wide)
    (32768, (256, 3, 132, 6, 256)),
    (16384, (128, 3, 132, 3, 256)),   # after guidance truncation: 2.91 waves
    (16461, (129, 3, 132, 3, 256)),   # ragged rows
    (2048, (16, 6, 96, 1, 128)),      # one sample: 48 wide tiles, 96 narrow busy more SMs
    (100, (1, 6, 6, 1, 128)),         # fewer tiles than SMs
]


@pytest.mark.parametrize("tma", [True, False], ids=["bf16 residual", "f32 residual"])
@pytest.mark.parametrize("m,want", RESIDUAL_PLANS, ids=[str(m) for m, _ in RESIDUAL_PLANS])
def test_residual_plan(m, want, tma):
    plan = fb.store_plan(m, D, D, SMS, tma)
    assert (plan["m_tiles"], plan["n_tiles"]) == want[:2]
    assert plan["grid"] == (want[2],) and plan["tiles_per_block"] == want[3]
    assert (plan["block_n"], plan["k_tiles"], plan["tma_store"]) == (want[4], 6, tma)
    assert plan["smem_bytes"] == wg_smem(want[4], tma) <= SMEM_LIMIT
    assert plan["stages"] == (3 if tma and want[4] == 256 else 4)
    assert plan == fb.gemm_plan(m, D, D, SMS, want[4], tma)


def test_gemm_layouts_keep_their_bytes():
    """The residual's mbarriers fit in the TMA layout's padding: the shared
    memory of every layout is what it was before them (int8_linear's and
    row 3's plans are unchanged)."""
    assert [wg_smem(256, False), wg_smem(128, False), wg_smem(256, True),
            wg_smem(128, True)] == [201792, 134208, 219136, 167936]
    for block_n in (256, 128):
        for tma in (False, True):
            assert fb.gemm_plan(4096, 768, 768, SMS, block_n, tma)["smem_bytes"] == wg_smem(
                block_n, tma)


class _Recorder:
    """Stands in for the ctypes launch: records each call's name and
    arguments."""

    def __init__(self):
        self.calls = []

    def lib(self, name, argtypes):
        return name, argtypes

    def run(self, so, fn, args):
        name, argtypes = so, fn
        assert len(args) == len(argtypes), name
        for a, t in zip(args, argtypes):  # each argument fits its ctypes type
            if a is not None:
                t(a)
        self.calls.append((name, args))


@pytest.fixture
def rec(monkeypatch):
    r = _Recorder()
    monkeypatch.setattr(fb, "_load_lib", r.lib)
    monkeypatch.setattr(fb, "_run", r.run)
    monkeypatch.setattr(fb, "_plain_route", lambda x: False)  # CPU tensors take the CUDA route
    monkeypatch.setattr(fb, "_stream", lambda dev: 12345)
    monkeypatch.setattr(fb, "_sms", lambda dev: SMS)
    reset_launch_counts()
    yield r
    reset_launch_counts()


def _w(rng, n_in, n_out):
    """An int8 weight (n_in, n_out) in the K-major layout the serving path
    pre-quantizes to, and its per-channel scales."""
    w = torch.from_numpy(rng.standard_normal((n_out, n_in)).astype(np.float32)) * n_in ** -0.5
    return quantize_weight_kmajor(w)


def _vec(rng, n, dtype=BF16):
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)


def _x(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


RESIDUAL_CASES = [  # (lead, k, n, x dtype, residual dtype, bias dtype)
    # path B at both batches; the four x / residual dtype pairs
    ((16, 2048), D, D, BF16, BF16, BF16),
    ((8, 2048), D, D, BF16, BF16, BF16),
    ((8, 2048), D, D, F32, F32, F32),
    ((8, 2048), D, D, BF16, F32, BF16),
    ((8, 2048), D, D, F32, BF16, F32),
    # ragged rows, narrow tiles, another width
    ((3, 77), 256, 384, BF16, F32, F32),
    ((100,), 128, 256, F32, BF16, BF16),
]


@pytest.mark.parametrize("lead,k,n,xdt,rdt,bdt", RESIDUAL_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{c[4]}-{c[5]}"
                              for c in RESIDUAL_CASES])
def test_residual_launch_follows_the_plan(rec, lead, k, n, xdt, rdt, bdt):
    rng = np.random.default_rng(k + n)
    x = torch.zeros(lead + (k,), dtype=xdt)
    res = torch.zeros(lead + (n,), dtype=rdt)
    wq, s = _w(rng, k, n)
    b = _vec(rng, n, bdt)
    y = fb.int8_matmul_residual(x, res, wq, s, b)
    (name, args), = rec.calls
    m = int(np.prod(lead))
    plan = fb.store_plan(m, n, k, SMS, rdt == BF16)  # a bf16 residual: in and out by TMA
    assert name == "int8_matmul_residual" and LAUNCHES["int8_matmul_residual"] == 1
    assert args[0] == x.data_ptr() and args[1:5] == [int(xdt == BF16), m, k, n]
    assert args[5:9] == [res.data_ptr(), int(rdt == BF16), b.data_ptr(), int(bdt == BF16)]
    # the weight reaches the kernel K-major (n, k), in place
    assert args[9] == wq.t().data_ptr() and args[10] == s.data_ptr()
    assert args[13] == y.data_ptr()
    assert args[14:17] == [plan["grid"][0], plan["block_n"], plan["smem_bytes"]]
    assert args[17] == 12345  # the stream from _stream
    assert y.shape == res.shape and y.dtype == rdt  # y takes the residual's dtype


def _raises_before_launch(rec, exc, fn):
    with pytest.raises(exc):
        fn()
    assert rec.calls == []
    assert LAUNCHES["int8_matmul_residual"] == 0


def test_residual_argument_checks_raise_before_any_launch(rec):
    rng = np.random.default_rng(7)
    x, res = _x(rng, (40, 256), BF16), _x(rng, (40, 384), BF16)
    wq, s = _w(rng, 256, 384)
    b = _vec(rng, 384)
    call = fb.int8_matmul_residual
    # widths off the GEMM's 128; an in width over the row pass's shared memory
    _raises_before_launch(rec, NotImplementedError, lambda: call(
        _x(rng, (40, 192), BF16), res, *_w(rng, 192, 384), b))
    _raises_before_launch(rec, NotImplementedError, lambda: call(
        x, _x(rng, (40, 320), BF16), *_w(rng, 256, 320), _vec(rng, 320)))
    _raises_before_launch(rec, NotImplementedError, lambda: call(
        _x(rng, (1, fb.ROW_MAX_K + 128), BF16), _x(rng, (1, 128), BF16),
        *_w(rng, fb.ROW_MAX_K + 128, 128), _vec(rng, 128)))
    # a weight of the wrong type, shape or device
    _raises_before_launch(rec, ValueError, lambda: call(x, res, wq.float(), s, b))
    _raises_before_launch(rec, ValueError, lambda: call(x, res, wq[:-1], s, b))
    _raises_before_launch(rec, ValueError, lambda: call(x, res, wq.to("meta"), s, b))
    # scales and bias of another width than the weight's: the kernel reads N
    _raises_before_launch(rec, ValueError, lambda: call(x, res, wq, s[:-1], b))
    _raises_before_launch(rec, ValueError, lambda: call(x, res, wq, s, b[:-128]))
    # a residual with other rows, another width or on another device
    _raises_before_launch(rec, ValueError, lambda: call(x, res[:-1], wq, s, b))
    _raises_before_launch(rec, ValueError, lambda: call(x, _x(rng, (20, 768), BF16), wq, s, b))
    _raises_before_launch(rec, ValueError, lambda: call(x, res.reshape(-1), wq, s, b))
    _raises_before_launch(rec, ValueError, lambda: call(x, res.to("meta"), wq, s, b))
    # x, the residual and the bias: float32 or bfloat16
    _raises_before_launch(rec, TypeError, lambda: call(x.half(), res, wq, s, b))
    _raises_before_launch(rec, TypeError, lambda: call(x, res.half(), wq, s, b))
    _raises_before_launch(rec, TypeError, lambda: call(x, res, wq, s, b.half()))


def test_residual_bias_off_the_device_raises_before_any_launch(rec):
    """A bias on another device than x: the kernel would get that device's
    pointer."""
    rng = np.random.default_rng(8)
    x, res = _x(rng, (40, 256), BF16), _x(rng, (40, 384), BF16)
    wq, s = _w(rng, 256, 384)
    _raises_before_launch(rec, ValueError, lambda: fb.int8_matmul_residual(
        x, res, wq, s, _vec(rng, 384).to("meta")))


def _unaligned(t):
    """A contiguous copy of ``t`` one element off a 16-byte boundary."""
    store = torch.zeros(t.numel() + 1, dtype=t.dtype)
    store[1:] = t.reshape(-1)
    out = store[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("which", ["x", "residual", "weight", "all"])
def test_residual_unaligned_views_are_copied_before_the_launch(rec, which):
    rng = np.random.default_rng(9)
    x, res = _x(rng, (40, 256), BF16), _x(rng, (40, 384), F32)
    wq, s = _w(rng, 256, 384)
    if which in ("x", "all"):
        x = _unaligned(x)
    if which in ("residual", "all"):
        res = _unaligned(res)
    if which in ("weight", "all"):
        wq = _unaligned(wq.t().contiguous()).t()
    y = fb.int8_matmul_residual(x, res, wq, s, _vec(rng, 384))
    (_, args), = rec.calls
    assert args[0] % 16 == 0 and args[5] % 16 == 0 and args[9] % 16 == 0
    assert (args[0] != x.data_ptr()) == (which in ("x", "all"))
    assert (args[5] != res.data_ptr()) == (which in ("residual", "all"))
    assert (args[9] != wq.t().data_ptr()) == (which in ("weight", "all"))
    assert y.shape == res.shape and y.dtype == res.dtype and y.data_ptr() % 16 == 0

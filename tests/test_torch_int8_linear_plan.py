"""The pieces around the CUDA code of ``int8_linear`` and
``fused_ln_int8_matmul`` (row 3), whose products run on the wgmma + TMA GEMM
(``csrc/int8_wgmma.cuh``) with a store epilogue (a bf16 output stored by
TMA from shared memory), on the CPU: their launch plans (``store_plan``
over ``gemm_plan``: the tile width, the stages and shared memory of the
TMA-store layout) at every (M, N) of the t2i int8 call's ViT projections
and of the per-point int8 path's QKV projection, and at ragged row counts;
the
launch arguments both wrappers hand over (the launch and the card's SM
count replaced by a recorder and a constant, so CPU tensors take the CUDA
route up to the recorded launch), with out dtypes f32 and bf16 and with and
without a bias; every argument check raising before a launch; and unaligned
x and weight views copied before the launch (TMA reads 16-byte-aligned
addresses only).

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


def wg_smem(block_n, tma_store=False):
    """csrc/int8_wgmma.cuh: 4 stages (3 for 256-wide tiles with a TMA-store
    output) of a 128 x 128-byte A tile and a block_n x 128-byte W tile, a
    full and an empty mbarrier a stage, the tile's block_n f32 column scales
    and biases for each of the two consumer warpgroups; with a TMA-store
    output, at the next 1 KB boundary, each consumer's 64 x block_n bf16
    output tile; 1 KB to align."""
    stages = 3 if tma_store and block_n == 256 else 4
    end = stages * (128 + block_n) * 128 + stages * 2 * 8 + 2 * 2 * block_n * 4
    if tma_store:
        end = (end + 1023) // 1024 * 1024 + 2 * 64 * block_n * 2
    return end + 1024


def test_gemm_layouts():
    assert [wg_smem(256), wg_smem(128), wg_smem(256, True), wg_smem(128, True)] == [
        201792, 134208, 219136, 167936]
    for block_n in (256, 128):
        for tma in (False, True):
            plan = fb.gemm_plan(4096, 1024, 1024, SMS, block_n, tma)
            assert plan["smem_bytes"] == wg_smem(block_n, tma) <= SMEM_LIMIT
            assert plan["stages"] == (3 if tma and block_n == 256 else 4)
            assert plan["tma_store"] == tma
    assert fb.WG_SMEM == wg_smem(256)


LINEAR_PLANS = [  # (m, n): m tiles, n tiles, grid, tiles a block, tile width
    # the video encoder's 8 x 288 rows: qkv (N = 3D) and the out-projection (N
    # = D); 1.64 and 0.55 waves of wide tiles: the narrow ones take as many
    # columns of rounds
    ((2304, 3072), (18, 12, 132, 2, 256)),
    ((2304, 1024), (18, 4, 72, 1, 256)),
    # the image encoder at 8 x (256 + the bucket of 128, 256 and 512 tokens):
    # 2.18, 4.36 and 1.45 waves of wide tiles take the narrow ones
    ((3072, 3072), (24, 24, 132, 5, 128)),
    ((3072, 1024), (24, 4, 96, 1, 256)),
    ((4096, 3072), (32, 12, 132, 3, 256)),
    ((4096, 1024), (32, 4, 128, 1, 256)),
    ((6144, 3072), (48, 24, 132, 9, 128)),
    ((6144, 1024), (48, 8, 132, 3, 128)),
    # 8 x 1280: the image encoder's full phase and every decoder layer: 7.27
    # waves of wide tiles keep them (15 narrow rounds save 1/16 of 8 wide
    # ones, under a tenth), 2.42 take the narrow ones
    ((10240, 3072), (80, 12, 132, 8, 256)),
    ((10240, 1024), (80, 8, 132, 5, 128)),
    # ragged rows; fewer wide tiles than SMs (the narrow ones busy twice
    # as many SMs for half the columns each)
    ((2301, 3072), (18, 12, 132, 2, 256)),
    ((77, 1024), (1, 8, 8, 1, 128)),
]


@pytest.mark.parametrize("tma", [True, False], ids=["bf16 out", "f32 out"])
@pytest.mark.parametrize("shape,want", LINEAR_PLANS, ids=[str(s) for s, _ in LINEAR_PLANS])
def test_linear_plan(shape, want, tma):
    m, n = shape
    plan = fb.store_plan(m, n, 1024, SMS, tma)
    assert (plan["m_tiles"], plan["n_tiles"]) == want[:2]
    assert plan["grid"] == (want[2],) and plan["tiles_per_block"] == want[3]
    assert plan["block_n"] == want[4] and plan["tma_store"] == tma
    assert plan["smem_bytes"] == wg_smem(want[4], tma) <= SMEM_LIMIT
    assert plan == fb.gemm_plan(m, n, 1024, SMS, want[4], tma)
    assert plan["k_tiles"] == 1024 // 128
    assert plan["tiles"] == plan["m_tiles"] * plan["n_tiles"] >= plan["grid"][0]
    assert plan["grid"][0] == min(SMS, plan["tiles"])
    assert plan["waves"] == plan["tiles"] / plan["grid"][0]
    assert plan["m_tiles"] * 128 >= m > (plan["m_tiles"] - 1) * 128
    assert plan["n_tiles"] * plan["block_n"] >= n > (plan["n_tiles"] - 1) * plan["block_n"]
    # the narrow tiles where their columns of rounds, a tenth dearer each,
    # come under the wide tiles'
    wide = fb.gemm_plan(m, n, 1024, SMS, 256, tma)
    narrow = fb.gemm_plan(m, n, 1024, SMS, 128, tma)
    assert (plan["block_n"] == 128) == (
        1.1 * narrow["tiles_per_block"] * 128 < wide["tiles_per_block"] * 256)


ROW3_PLANS = [  # m (K = 768 -> N = 2304): m tiles, n tiles, grid, tiles a block, tile width
    # path B's QKV at the CFG steps' 2x batch (16 x 2048): 17.45 waves of
    # wide tiles keep them (35 narrow rounds save 1/36 of 18 wide ones)
    (32768, (256, 9, 132, 18, 256)),
    (16384, (128, 9, 132, 9, 256)),   # after guidance truncation: 8.73 waves
    (16461, (129, 9, 132, 9, 256)),   # ragged rows
    (100, (1, 18, 18, 1, 128)),       # fewer tiles than SMs
]


@pytest.mark.parametrize("m,want", ROW3_PLANS, ids=[str(m) for m, _ in ROW3_PLANS])
def test_row3_plan(m, want):
    plan = fb.store_plan(m, 2304, 768, SMS, True)
    assert (plan["m_tiles"], plan["n_tiles"]) == want[:2]
    assert plan["grid"] == (want[2],) and plan["tiles_per_block"] == want[3]
    assert (plan["block_n"], plan["k_tiles"]) == (want[4], 6)
    assert plan["smem_bytes"] == wg_smem(want[4], True)


@pytest.mark.parametrize("block_n", [64, 192, 512])
def test_gemm_plan_refuses_other_tile_widths(block_n):
    with pytest.raises(ValueError):
        fb.gemm_plan(1024, 1024, 1024, SMS, block_n)


def test_narrow_tile_plan():
    plan = fb.gemm_plan(3072, 3072, 1024, SMS, 128)
    assert (plan["n_tiles"], plan["tiles"], plan["tiles_per_block"]) == (24, 576, 5)
    assert plan["smem_bytes"] == wg_smem(128) < fb.WG_SMEM
    assert fb.store_plan(3072, 3072, 1024, SMS, True) == fb.gemm_plan(
        3072, 3072, 1024, SMS, 128, True)


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


def _vec(rng, n, dtype=torch.bfloat16):
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)


def _x(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


LINEAR_CASES = [  # (lead, k, n, x dtype, out dtype, bias dtype or None)
    ((8, 288), 1024, 3072, torch.float32, torch.bfloat16, torch.bfloat16),  # the ViT's qkv
    ((8, 288), 1024, 1024, torch.bfloat16, torch.bfloat16, torch.bfloat16),  # its out-projection
    ((3, 77), 256, 384, torch.float32, torch.float32, torch.float32),
    ((3, 77), 256, 384, torch.bfloat16, torch.float32, None),
    ((100,), 128, 256, torch.float32, torch.bfloat16, None),
    ((100,), 128, 256, torch.float32, None, torch.bfloat16),  # out dtype: x's
]


@pytest.mark.parametrize("lead,k,n,xdt,odt,bdt", LINEAR_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}-{c[4]}-{c[5]}" for c in LINEAR_CASES])
def test_int8_linear_launch_follows_the_plan(rec, lead, k, n, xdt, odt, bdt):
    rng = np.random.default_rng(k + n)
    x = _x(rng, lead + (k,), xdt)
    wq, s = _w(rng, k, n)
    b = None if bdt is None else _vec(rng, n, bdt)
    y = fb.int8_linear(x, wq, s, b, odt)
    (name, args), = rec.calls
    m = int(np.prod(lead))
    want = odt or xdt
    plan = fb.store_plan(m, n, k, SMS, want == torch.bfloat16)
    assert name == "int8_linear" and LAUNCHES["int8_linear"] == 1
    assert args[0] == x.data_ptr() and args[1:5] == [int(xdt == torch.bfloat16), m, k, n]
    assert args[5] == (None if b is None else b.data_ptr())
    assert args[6] == int(bdt == torch.bfloat16)
    # the weight reaches the kernel K-major (n, k), in place
    assert args[7] == wq.t().data_ptr() and args[8] == s.data_ptr()
    assert args[11] == y.data_ptr() and args[12] == int(want == torch.bfloat16)
    assert args[13:16] == [plan["grid"][0], plan["block_n"], plan["smem_bytes"]]
    assert args[16] == 12345  # the stream from _stream
    assert y.shape == lead + (n,) and y.dtype == want


@pytest.mark.parametrize("lead,d,xdt", [((2, 2048), 768, torch.bfloat16),
                                        ((3, 77), 256, torch.float32),
                                        ((100,), 128, torch.bfloat16)])
def test_ln_matmul_launch_follows_the_plan(rec, lead, d, xdt):
    rng = np.random.default_rng(d)
    n = 3 * d
    x = _x(rng, lead + (d,), xdt)
    wq, s = _w(rng, d, n)
    lns, lnb, b = _vec(rng, d), _vec(rng, d), _vec(rng, n)
    y = fb.fused_ln_int8_matmul(x, lns, lnb, wq, s, b)
    (name, args), = rec.calls
    m = int(np.prod(lead))
    plan = fb.store_plan(m, n, d, SMS, xdt == torch.bfloat16)
    assert name == "fused_ln_int8_matmul" and LAUNCHES["fused_ln_int8_matmul"] == 1
    assert args[0] == x.data_ptr() and args[1:5] == [int(xdt == torch.bfloat16), m, d, n]
    assert args[5:9] == [lns.data_ptr(), lnb.data_ptr(), b.data_ptr(), 1]
    assert args[9] == wq.t().data_ptr() and args[10] == s.data_ptr()
    assert args[13] == y.data_ptr() and y.shape == lead + (n,) and y.dtype == xdt
    assert args[14:17] == [plan["grid"][0], plan["block_n"], plan["smem_bytes"]]
    assert plan["smem_bytes"] == wg_smem(plan["block_n"], xdt == torch.bfloat16)
    assert args[17] == 12345


def _raises_before_launch(rec, exc, fn):
    with pytest.raises(exc):
        fn()
    assert rec.calls == []
    assert LAUNCHES["int8_linear"] == LAUNCHES["fused_ln_int8_matmul"] == 0


def test_int8_linear_argument_checks_raise_before_any_launch(rec):
    rng = np.random.default_rng(7)
    x = _x(rng, (40, 256), torch.float32)
    wq, s = _w(rng, 256, 384)
    b = _vec(rng, 384)
    # widths off the GEMM's 128; an in width over the row pass's shared memory
    _raises_before_launch(rec, NotImplementedError, lambda: fb.int8_linear(
        _x(rng, (40, 192), torch.float32), *_w(rng, 192, 384)))
    _raises_before_launch(rec, NotImplementedError, lambda: fb.int8_linear(
        x, *_w(rng, 256, 320)))
    _raises_before_launch(rec, NotImplementedError, lambda: fb.int8_linear(
        _x(rng, (1, fb.ROW_MAX_K + 128), torch.bfloat16), *_w(rng, fb.ROW_MAX_K + 128, 128)))
    # a weight of the wrong type, shape or device
    _raises_before_launch(rec, ValueError, lambda: fb.int8_linear(x, wq.float(), s, b))
    _raises_before_launch(rec, ValueError, lambda: fb.int8_linear(x, wq[:-1], s, b))
    _raises_before_launch(rec, ValueError, lambda: fb.int8_linear(x, wq.to("meta"), s, b))
    # scales and bias of another width than the weight's
    _raises_before_launch(rec, ValueError, lambda: fb.int8_linear(x, wq, s[:-1], b))
    _raises_before_launch(rec, ValueError, lambda: fb.int8_linear(x, wq, s, b[:-128]))
    # x, the bias and the out dtype: float32 or bfloat16
    _raises_before_launch(rec, TypeError, lambda: fb.int8_linear(x.half(), wq, s, b))
    _raises_before_launch(rec, TypeError, lambda: fb.int8_linear(x, wq, s, b.half()))
    _raises_before_launch(rec, TypeError, lambda: fb.int8_linear(x, wq, s, b, torch.float16))


def test_ln_matmul_argument_checks_raise_before_any_launch(rec):
    rng = np.random.default_rng(8)

    def operands(m, d, n, dtype=torch.bfloat16):
        wq, s = _w(rng, d, n)
        return [_x(rng, (m, d), dtype), _vec(rng, d), _vec(rng, d), wq, s, _vec(rng, n)]

    ops = operands(40, 256, 768)
    # widths off the GEMM's 128
    _raises_before_launch(rec, NotImplementedError,
                          lambda: fb.fused_ln_int8_matmul(*operands(8, 192, 576)))
    _raises_before_launch(rec, NotImplementedError,
                          lambda: fb.fused_ln_int8_matmul(*operands(8, 256, 320)))
    # a weight of the wrong type or shape
    bad = list(ops)
    bad[3] = ops[3].to(torch.uint8)
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_matmul(*bad))
    bad = list(ops)
    bad[3] = ops[3][:-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_matmul(*bad))
    # scales, bias or LN params of another width than the weight's
    for i, cut in ((4, 1), (5, 128), (1, 1), (2, 128)):
        bad = list(ops)
        bad[i] = ops[i][:-cut]
        _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_matmul(*bad))
    # x and the vectors: float32 or bfloat16, the vectors of one dtype
    bad = list(ops)
    bad[0] = ops[0].half()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_ln_int8_matmul(*bad))
    bad = list(ops)
    bad[5] = ops[5].float()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_ln_int8_matmul(*bad))
    bad = list(ops)
    bad[1], bad[2], bad[5] = ops[1].half(), ops[2].half(), ops[5].half()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_ln_int8_matmul(*bad))


def test_int8_linear_bias_off_the_device_raises_before_any_launch(rec):
    """A bias on another device than x: the kernel would get that device's
    pointer."""
    rng = np.random.default_rng(11)
    x = _x(rng, (40, 256), torch.float32)
    wq, s = _w(rng, 256, 384)
    _raises_before_launch(rec, ValueError,
                          lambda: fb.int8_linear(x, wq, s, _vec(rng, 384).to("meta")))


@pytest.mark.parametrize("which", [1, 2, 5], ids=["ln_scale", "ln_bias", "b"])
def test_ln_matmul_vector_off_the_device_raises_before_any_launch(rec, which):
    rng = np.random.default_rng(12)
    wq, s = _w(rng, 256, 768)
    ops = [_x(rng, (40, 256), torch.bfloat16), _vec(rng, 256), _vec(rng, 256), wq, s,
           _vec(rng, 768)]
    ops[which] = ops[which].to("meta")
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_matmul(*ops))


def _unaligned(t):
    """A contiguous copy of ``t`` one element off a 16-byte boundary."""
    store = torch.zeros(t.numel() + 1, dtype=t.dtype)
    store[1:] = t.reshape(-1)
    out = store[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0
    return out


def _unaligned_weight(wq):
    """The (k, n) view of a K-major weight whose (n, k) rows lie one byte
    off a 16-byte boundary."""
    return _unaligned(wq.t().contiguous()).t()


@pytest.mark.parametrize("which", ["x", "weight", "both"])
def test_int8_linear_unaligned_views_are_copied_before_the_launch(rec, which):
    rng = np.random.default_rng(9)
    x = _x(rng, (40, 256), torch.bfloat16)
    wq, s = _w(rng, 256, 384)
    if which in ("x", "both"):
        x = _unaligned(x)
    if which in ("weight", "both"):
        wq = _unaligned_weight(wq)
    fb.int8_linear(x, wq, s, None, torch.float32)
    (_, args), = rec.calls
    assert args[0] % 16 == 0 and args[7] % 16 == 0
    assert (args[0] != x.data_ptr()) == (which in ("x", "both"))
    assert (args[7] != wq.t().data_ptr()) == (which in ("weight", "both"))


@pytest.mark.parametrize("which", ["x", "weight"])
def test_ln_matmul_unaligned_views_are_copied_before_the_launch(rec, which):
    rng = np.random.default_rng(10)
    x = _x(rng, (40, 256), torch.bfloat16)
    wq, s = _w(rng, 256, 768)
    if which == "x":
        x = _unaligned(x)
    else:
        wq = _unaligned_weight(wq)
    fb.fused_ln_int8_matmul(x, _vec(rng, 256), _vec(rng, 256), wq, s, _vec(rng, 768))
    (_, args), = rec.calls
    assert args[0] % 16 == 0 and args[9] % 16 == 0
    assert (args[0] != x.data_ptr()) == (which == "x")
    assert (args[9] != wq.t().data_ptr()) == (which == "weight")

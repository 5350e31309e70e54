"""The int8 serving kernels' pieces around their CUDA code, on the CPU: the
launch plan of ``fused_ln_int8_mlp``'s two products on the wgmma GEMM
(``csrc/int8_wgmma.cuh``) at the flagship's and the per-point path's widths
and at ragged row counts; the plan of ``fused_int8_diffusion_block``'s one
launch (``csrc/fused_int8_diffusion_block.cu``: grid, phases, grid
barriers, shared memory, the workspace's offsets); the launch arguments the
two wrappers hand over (with the launch replaced by a recorder); every
argument check raising before a launch; and the diffusion block's output
and workspace coming from one allocation.

Tolerances: none; the plans are integer arithmetic.
"""

import ctypes

import numpy as np
import pytest
import torch

from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nova_pointcloud_tpu_torch.ops.kernels import fused_block as fb
from nova_pointcloud_tpu_torch.ops.quantization import quantize_weight_kmajor

SMS = 132  # the H100's streaming multiprocessors
SMEM_LIMIT = 232448  # a block's shared memory on the H100
# csrc/int8_wgmma.cuh: 4 stages of a 128 x 128-byte A tile and a 256 x
# 128-byte W tile, a full and an empty mbarrier a stage, the tile's 256 f32
# column scales and biases for each of the two consumer warpgroups, 1 KB to
# align
WG_SMEM = 4 * (128 + 256) * 128 + 4 * 2 * 8 + 2 * 2 * 256 * 4 + 1024

GEMM_PLANS = [  # (m, n, k): m tiles, n tiles, k tiles, grid, tiles a block
    ((32768, 4096, 1024), (256, 16, 8, 132, 32)),   # flagship fc1, the CFG steps' 2x batch
    ((32768, 1024, 4096), (256, 4, 32, 132, 8)),    # flagship fc2
    ((16384, 4096, 1024), (128, 16, 8, 132, 16)),   # after guidance truncation
    ((16384, 1024, 4096), (128, 4, 32, 132, 4)),
    ((32768, 3072, 768), (256, 12, 6, 132, 24)),    # path B fc1 (D = 768, F = 3072)
    ((32768, 768, 3072), (256, 3, 24, 132, 6)),     # path B fc2
    ((16461, 3072, 768), (129, 12, 6, 132, 12)),    # ragged rows
    ((77, 4096, 1024), (1, 16, 8, 16, 1)),          # fewer tiles than SMs
    ((77, 1024, 4096), (1, 4, 32, 4, 1)),
    ((300, 640, 1280), (3, 3, 10, 9, 1)),           # N not a multiple of the tile
]


@pytest.mark.parametrize("shape,want", GEMM_PLANS, ids=[str(s) for s, _ in GEMM_PLANS])
def test_gemm_plan(shape, want):
    m, n, k = shape
    plan = fb.gemm_plan(m, n, k, SMS)
    got = tuple(plan[key] for key in ("m_tiles", "n_tiles", "k_tiles"))
    assert got == want[:3]
    assert plan["grid"] == (want[3],) and plan["tiles_per_block"] == want[4]
    assert plan["tiles"] == plan["m_tiles"] * plan["n_tiles"] >= plan["grid"][0]
    assert plan["smem_bytes"] == fb.WG_SMEM == WG_SMEM <= SMEM_LIMIT
    assert plan["stages"] == fb.WG_STAGES == 4
    assert plan["m_tiles"] * fb.WG_BLOCK_M >= m > (plan["m_tiles"] - 1) * fb.WG_BLOCK_M
    assert plan["n_tiles"] * fb.WG_BLOCK_N >= n > (plan["n_tiles"] - 1) * fb.WG_BLOCK_N
    assert plan["k_tiles"] * fb.WG_BLOCK_K == k


@pytest.mark.parametrize("m,d,f", [(32768, 1024, 4096), (16384, 1024, 4096),
                                   (32768, 768, 3072), (16461, 768, 3072), (77, 1024, 4096)])
def test_mlp_plan_is_its_two_products(m, d, f):
    plan = fb.mlp_plan(m, d, f, SMS)
    assert plan["fc1"] == fb.gemm_plan(m, f, d, SMS)
    assert plan["fc2"] == fb.gemm_plan(m, d, f, SMS)


DIFFUSION_PLANS = [  # (m, d): grid, groups a block, blocks with columns, row parts, rows a part
    ((200, 1024), (128, 2, 128, 2, 112)),  # the t2i head: 4 x CFG 2 x 25 tokens, mlp_d6w1024
    ((77, 1024), (128, 2, 128, 2, 48)),    # ragged rows
    ((20, 1024), (128, 1, 128, 1, 20)),    # too few rows to split
    ((200, 768), (96, 2, 96, 2, 112)),     # mlp_d6w768
    ((200, 1280), (132, 2, 80, 1, 200)),   # mlp_d3w1280: two parts would need 3 groups a block
    ((200, 1536), (132, 2, 96, 1, 200)),   # mlp_d6w1536
    ((200, 128), (16, 2, 16, 2, 112)),     # mlp_d3w128
    ((1000, 1024), (128, 2, 128, 2, 512)),  # more rows than a chunk
]


@pytest.mark.parametrize("static", [True, False], ids=["static", "per-row"])
@pytest.mark.parametrize("shape,want", DIFFUSION_PLANS, ids=[str(s) for s, _ in DIFFUSION_PLANS])
def test_diffusion_plan(shape, want, static):
    m, d = shape
    plan = fb.diffusion_plan(m, d, SMS, static)
    assert plan["grid"] == (want[0],) and plan["grid"][0] <= SMS
    assert plan["groups_per_block"] == want[1] <= fb.DFB_MAX_GROUPS
    assert plan["busy_blocks"] == want[2] <= plan["grid"][0]
    assert (plan["row_parts"], plan["part_rows"]) == want[3:]
    # the column units times the groups a unit cover every group; the row
    # parts cover every row, in multiples of 16 but the last
    units = plan["grid"][0] // plan["row_parts"]
    assert units * plan["groups_per_block"] >= d // 8 == plan["groups"]
    assert plan["row_parts"] * plan["part_rows"] >= m > (plan["row_parts"] - 1) * plan["part_rows"]
    assert plan["row_parts"] == 1 or plan["part_rows"] % 16 == 0
    assert plan["row_chunks"] == -(-plan["part_rows"] // 128)
    # weight rows of the three products (scale, shift, gate, fc1, fc2: 5 x 8 a
    # group) at D + 16 bytes, then the ring or the staged rows, then 3
    # mbarriers (32 bytes), then 10 column vectors of 2 groups
    slab = 5 * want[1] * 8 * (d + 16)
    assert plan["weight_slab_bytes"] == slab
    ring = 4 * 128 * (128 + 16)
    assert plan["smem_bytes"] == (-(-slab // 128) * 128 + max(ring, 8 * d * 4) + 32
                                  + 10 * 2 * 8 * 4) <= SMEM_LIMIT
    # the phases: the per-row path quantizes h and silu(a) in row passes of
    # their own, each after a grid barrier
    base = ["silu_quant_z+ln_stats_x", "stats+adaln", "fc1", "fc2", "postln_gate"]
    if static:
        assert plan["phases"] == base and plan["barriers"] == 4
    else:
        assert plan["phases"] == (base[:2] + ["quant_h"] + base[2:3] + ["quant_a"] + base[3:])
        assert plan["barriers"] == 6
    # the workspace: every array at a 256-byte boundary, in order, none
    # overlapping, mid on the per-row path only
    ws = plan["workspace"]
    sizes = {"qz": m * d, "qh": m * d, "qa": m * d, "sz": 4 * m, "sh": 4 * m, "sa": 4 * m,
             "mu": 4 * m, "rstd": 4 * m, "gate": 4 * m * d, "o": 4 * m * d, "mid": 4 * m * d}
    names = [n for n in sizes if n != "mid" or not static]
    assert list(ws) == names
    end = 0
    for n in names:
        assert ws[n] % 256 == 0 and ws[n] >= end
        end = ws[n] + sizes[n]
    assert plan["workspace_bytes"] == end


def test_diffusion_plan_refuses_what_the_kernel_cannot_hold():
    plan = fb.diffusion_plan(200, 2048, SMS, True)  # 2 groups a block of 2064-byte rows
    assert plan["groups_per_block"] == 2 and plan["smem_bytes"] > SMEM_LIMIT
    assert fb.diffusion_plan(200, 4096, SMS, True)["groups_per_block"] == 4


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
    monkeypatch.setattr(fb, "_stream", lambda dev: 0)
    monkeypatch.setattr(fb, "_sms", lambda dev: SMS)
    reset_launch_counts()
    yield r
    reset_launch_counts()


def _w(rng, n_out, n_in):
    """An int8 weight (n_in, n_out) in the K-major layout the serving path
    pre-quantizes to, and its per-channel scales."""
    w = torch.from_numpy(rng.standard_normal((n_out, n_in)).astype(np.float32)) * n_in ** -0.5
    return quantize_weight_kmajor(w)


def _mlp_operands(rng, m, d, f, dtype=torch.bfloat16):
    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(dtype)
    w1, s1 = _w(rng, f, d)
    w2, s2 = _w(rng, d, f)
    return [x, vec(d), vec(d), w1, s1, vec(f), w2, s2, vec(d)]


@pytest.mark.parametrize("m,d,f", [(300, 256, 512), (77, 128, 384)])
@pytest.mark.parametrize("static", [True, False], ids=["static", "per-row"])
def test_mlp_launch_follows_the_plan(rec, m, d, f, static):
    rng = np.random.default_rng(m + d)
    ops = _mlp_operands(rng, m, d, f)
    kw = dict(a_in=torch.tensor(4.0), a_mid=torch.tensor(3.0)) if static else {}
    y = fb.fused_ln_int8_mlp(*ops, **kw)
    (name, args), = rec.calls
    plan = fb.mlp_plan(m, d, f, SMS)
    assert name == "fused_ln_int8_mlp" and LAUNCHES["fused_ln_int8_mlp"] == 1
    assert args[0] == ops[0].data_ptr() and args[1:5] == [1, m, d, f]
    # the weights reach the kernel K-major: w1t (F, D), w2t (D, F), in place
    assert args[10] == ops[3].data_ptr() and args[12] == ops[6].data_ptr()
    assert (args[14] is not None, args[15] is not None) == (static, static)
    assert (args[19] is None) == static  # the f32 mid rows on the per-row path only
    assert args[22:25] == [plan["fc1"]["grid"][0], plan["fc2"]["grid"][0], fb.WG_SMEM]
    assert args[21] == y.data_ptr() and y.shape == ops[0].shape and y.dtype == ops[0].dtype


@pytest.mark.parametrize("m,d", [(200, 1024), (77, 256)])
@pytest.mark.parametrize("static", [True, False], ids=["static", "per-row"])
def test_diffusion_launch_is_one_allocation(rec, monkeypatch, m, d, static):
    rng = np.random.default_rng(m * d)
    x, zc = (torch.from_numpy(rng.standard_normal((1, m, d)).astype(np.float32))
             .to(torch.bfloat16) for _ in range(2))
    rows = m
    ws, ss = _w(rng, 3 * d, d)
    w1, s1 = _w(rng, d, d)
    w2, s2 = _w(rng, d, d)

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
    kw = (dict(a_z=torch.tensor(4.0), a_h=torch.tensor(6.0), a_silu=torch.tensor(3.0))
          if static else {})
    empties = []
    real_empty = torch.empty

    def counting_empty(*a, **k):
        t = real_empty(*a, **k)
        empties.append(t)
        return t
    monkeypatch.setattr(torch, "empty", counting_empty)
    y = fb.fused_int8_diffusion_block(x, zc, ws, ss, vec(3 * d), w1, s1, vec(d), w2, s2,
                                      vec(d), vec(d), vec(d), n2_eps=1e-5, **kw)
    monkeypatch.setattr(torch, "empty", real_empty)
    (name, args), = rec.calls
    assert name == "fused_int8_diffusion_block" and LAUNCHES["fused_int8_diffusion_block"] == 1
    plan = fb.diffusion_plan(rows, d, SMS, static)
    assert args[4:6] == [rows, d] and args[12] == 1e-5
    assert args[13] == ws.data_ptr() and args[15] == w1.data_ptr() and args[17] == w2.data_ptr()
    assert (args[19] is not None) == static
    assert args[23] == plan["workspace_bytes"] and args[25:27] == [plan["grid"][0],
                                                                     plan["smem_bytes"]]
    # one allocation: y first, the workspace after it at a 256-byte offset
    buf, = empties
    assert buf.dtype == torch.uint8 and args[24] == y.data_ptr() == buf.data_ptr()
    y_bytes = rows * d * 2
    assert args[22] - buf.data_ptr() == -(-y_bytes // 256) * 256
    assert args[22] + plan["workspace_bytes"] == buf.data_ptr() + buf.numel()
    assert y.shape == x.shape and y.dtype == x.dtype


def _raises_before_launch(rec, exc, fn):
    with pytest.raises(exc):
        fn()
    assert rec.calls == []
    assert LAUNCHES["fused_ln_int8_mlp"] == LAUNCHES["fused_int8_diffusion_block"] == 0


def test_mlp_argument_checks_raise_before_any_launch(rec):
    rng = np.random.default_rng(3)
    ops = _mlp_operands(rng, 64, 256, 512)
    s = torch.tensor(4.0)
    # widths off the GEMM's 128
    _raises_before_launch(rec, NotImplementedError,
                          lambda: fb.fused_ln_int8_mlp(*_mlp_operands(rng, 64, 192, 512)))
    _raises_before_launch(rec, NotImplementedError,
                          lambda: fb.fused_ln_int8_mlp(*_mlp_operands(rng, 64, 256, 320)))
    # static scales all or none
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_mlp(*ops, a_in=s))
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_mlp(*ops, a_mid=s))
    # a weight of the wrong type or shape
    bad = list(ops)
    bad[3] = ops[3].float()
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_mlp(*bad))
    bad = list(ops)
    bad[6] = ops[6][:-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_mlp(*bad))
    # x and the vectors: float32 or bfloat16, the vectors of one dtype
    bad = list(ops)
    bad[0] = ops[0].half()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_ln_int8_mlp(*bad))
    bad = list(ops)
    bad[5] = ops[5].float()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_ln_int8_mlp(*bad))


def test_diffusion_argument_checks_raise_before_any_launch(rec):
    rng = np.random.default_rng(4)

    def operands(m, d, dtype=torch.bfloat16):
        def vec(n):
            return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
        x, zc = (torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(dtype)
                 for _ in range(2))
        ws, ss = _w(rng, 3 * d, d)
        w1, s1 = _w(rng, d, d)
        w2, s2 = _w(rng, d, d)
        return [x, zc, ws, ss, vec(3 * d), w1, s1, vec(d), w2, s2, vec(d), vec(d), vec(d)]

    ops = operands(40, 256)
    s = torch.tensor(4.0)
    # widths: off the 128 of the GEMM phases; too wide for a block's shared memory
    _raises_before_launch(rec, NotImplementedError,
                          lambda: fb.fused_int8_diffusion_block(*operands(8, 192)))
    _raises_before_launch(rec, NotImplementedError,
                          lambda: fb.fused_int8_diffusion_block(*operands(8, 2048)))
    # static scales all or none
    for kw in (dict(a_z=s), dict(a_z=s, a_h=s), dict(a_silu=s)):
        _raises_before_launch(rec, ValueError,
                              lambda: fb.fused_int8_diffusion_block(*ops, **kw))
    # zc's rows
    bad = list(ops)
    bad[1] = ops[1][:-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_diffusion_block(*bad))
    # a weight of the wrong shape or type
    bad = list(ops)
    bad[2] = ops[5]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_diffusion_block(*bad))
    bad = list(ops)
    bad[8] = ops[8].to(torch.uint8)
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_diffusion_block(*bad))
    # dtypes
    bad = list(ops)
    bad[0] = ops[0].half()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_int8_diffusion_block(*bad))
    bad = list(ops)
    bad[11] = ops[11].float()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_int8_diffusion_block(*bad))


# the per-channel vectors of the wrappers' operands, by their index in
# _mlp_operands / _diffusion_operands: the kernels read D, F or 3D of each
MLP_VECTORS = {"ln_scale": 1, "ln_bias": 2, "s1": 4, "b1": 5, "s2": 7, "b2": 8}
MLP_DEVICE_VECTORS = ("ln_scale", "ln_bias", "b1", "b2")  # the LN params and biases
DIFFUSION_VECTORS = {"stats_s": 3, "stats_b": 4, "s1": 6, "b1": 7, "s2": 9, "b2": 10,
                     "n2_scale": 11, "n2_bias": 12}
DIFFUSION_DEVICE_VECTORS = ("stats_b", "b1", "b2", "n2_scale", "n2_bias")


def _diffusion_operands(rng, m, d, dtype=torch.bfloat16):
    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)
    x, zc = (torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(dtype)
             for _ in range(2))
    ws, ss = _w(rng, 3 * d, d)
    w1, s1 = _w(rng, d, d)
    w2, s2 = _w(rng, d, d)
    return [x, zc, ws, ss, vec(3 * d), w1, s1, vec(d), w2, s2, vec(d), vec(d), vec(d)]


@pytest.mark.parametrize("which", list(MLP_VECTORS))
def test_mlp_short_vector_raises_before_any_launch(rec, which):
    """A vector one value short: the kernel would read past its end."""
    ops = _mlp_operands(np.random.default_rng(12), 64, 256, 512)
    ops[MLP_VECTORS[which]] = ops[MLP_VECTORS[which]][:-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_mlp(*ops))


@pytest.mark.parametrize("which", MLP_DEVICE_VECTORS)
def test_mlp_vector_off_the_device_raises_before_any_launch(rec, which):
    """An LN param or bias on another device than x: the kernel would get
    that device's pointer."""
    ops = _mlp_operands(np.random.default_rng(13), 64, 256, 512)
    ops[MLP_VECTORS[which]] = ops[MLP_VECTORS[which]].to("meta")
    _raises_before_launch(rec, ValueError, lambda: fb.fused_ln_int8_mlp(*ops))


@pytest.mark.parametrize("which", list(DIFFUSION_VECTORS))
def test_diffusion_short_vector_raises_before_any_launch(rec, which):
    ops = _diffusion_operands(np.random.default_rng(14), 40, 256)
    ops[DIFFUSION_VECTORS[which]] = ops[DIFFUSION_VECTORS[which]][:-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_diffusion_block(*ops))


@pytest.mark.parametrize("which", DIFFUSION_DEVICE_VECTORS)
def test_diffusion_vector_off_the_device_raises_before_any_launch(rec, which):
    ops = _diffusion_operands(np.random.default_rng(15), 40, 256)
    ops[DIFFUSION_VECTORS[which]] = ops[DIFFUSION_VECTORS[which]].to("meta")
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_diffusion_block(*ops))


def _unaligned(t):
    """A contiguous copy of ``t`` one element off a 16-byte boundary."""
    store = torch.zeros(t.numel() + 1, dtype=t.dtype)
    store[1:] = t.reshape(-1)
    out = store[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


def test_mlp_unaligned_x_is_copied_before_the_launch(rec):
    """The direct residual epilogue reads x in bf16 or f32 pairs: a
    contiguous view off a 16-byte boundary reaches the kernel as an aligned
    copy."""
    ops = _mlp_operands(np.random.default_rng(16), 64, 256, 512)
    ops[0] = _unaligned(ops[0])
    y = fb.fused_ln_int8_mlp(*ops)
    (_, args), = rec.calls
    assert args[0] % 16 == 0 and args[0] != ops[0].data_ptr()
    assert y.shape == ops[0].shape and y.dtype == ops[0].dtype


@pytest.mark.parametrize("which", ["x", "zc", "both"])
def test_diffusion_unaligned_x_and_zc_are_copied_before_the_launch(rec, which):
    """Row 6 reads x and zc in pairs (ld2_any): contiguous views off a
    16-byte boundary reach the kernel as aligned copies."""
    ops = _diffusion_operands(np.random.default_rng(17), 40, 256)
    if which in ("x", "both"):
        ops[0] = _unaligned(ops[0])
    if which in ("zc", "both"):
        ops[1] = _unaligned(ops[1])
    y = fb.fused_int8_diffusion_block(*ops)
    (_, args), = rec.calls
    assert args[0] % 16 == 0 and args[2] % 16 == 0
    assert (args[0] != ops[0].data_ptr()) == (which in ("x", "both"))
    assert (args[2] != ops[1].data_ptr()) == (which in ("zc", "both"))
    assert y.shape == ops[0].shape and y.dtype == ops[0].dtype


def test_unaligned_weights_are_copied_before_the_launch(rec):
    """TMA and bulk copies read from 16-byte-aligned addresses: a weight
    view off that boundary reaches the kernel as an aligned copy."""
    rng = np.random.default_rng(5)
    ops = _mlp_operands(rng, 64, 256, 512)
    w1t = ops[3].t()  # the K-major (F, D) rows the kernel reads
    store = torch.zeros(w1t.numel() + 1, dtype=torch.int8)
    store[1:] = w1t.reshape(-1)
    ops[3] = store[1:].view(w1t.shape).t()  # one byte off
    assert ops[3].t().data_ptr() % 16 != 0
    fb.fused_ln_int8_mlp(*ops)
    (_, args), = rec.calls
    assert args[10] % 16 == 0 and args[10] != ops[3].t().data_ptr()
    assert ctypes.c_void_p(args[10]).value == args[10]

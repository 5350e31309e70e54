"""The pieces around the CUDA code of ``fused_attention_block`` and
``fused_int8_mlp_postln``, on the CPU: their launch plans at the ported
paths' shapes (the flagship's 2x and 1x batch; the t2i ViT's 8 x 1280 and 8 x
768 rows) and at ragged ones; the plans refusing what the kernels cannot take
(head dims other than 64 and 96, T above the fused rule's bound, D off 128
or 256, a cluster over 8); the launch arguments
both wrappers hand over (the launch, the card's SM count and its cluster
count replaced by recorders and constants, so CPU tensors take the CUDA route
up to the recorded launch); every argument check raising before a launch;
an unaligned weight view copied before the launch; and the bf16 core
allocating no (M, 3D) qkv tensor.

Tolerances: none; the plans and the recorded arguments are exact.
"""

import ctypes

import numpy as np
import pytest
import torch

from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nova_pointcloud_tpu_torch.ops.kernels import fused_block as fb
from nova_pointcloud_tpu_torch.ops.quantization import quantize_weight_kmajor

SMS = 132  # the H100's streaming multiprocessors
CLUSTERS = 33  # clusters of 4 fc2 blocks an H100 runs at once (the occupancy query's count varies)
SMEM_LIMIT = 232448  # a block's shared memory on the H100
# csrc/fused_attention_block.cu, by head dim: 4 stages (3 at head dim 96) of a
# 128 x 128-byte A tile and three hd x 128-byte weight boxes, K and V (128 x
# hd bf16 each), a full and an empty mbarrier a stage, 3 hd column scales and
# biases for each of two consumers, 1 KB to align
QKVC_SMEM = {64: 4 * (128 + 192) * 128 + 2 * 128 * 64 * 2 + 4 * 2 * 8 + 2 * 2 * 192 * 4 + 1024,
             96: 3 * (128 + 288) * 128 + 2 * 128 * 96 * 2 + 3 * 2 * 8 + 2 * 2 * 288 * 4 + 1024}
# csrc/fused_int8_mlp_postln.cu: the wgmma GEMM's ring, 4 column vectors of
# 256 for each consumer, 64 row sums x 2 rounds x 2 tile parities x 2
# consumers and their mbarriers, 1 KB to align
PLN_SMEM = 4 * (128 + 256) * 128 + 4 * 2 * 8 + 2 * 4 * 256 * 4 + 2 * 2 * 2 * 64 * 4 + 8 * 8 + 1024

ATTN_PLANS = [  # (b, t, d, heads): tiles, grid, tiles a block
    ((256, 128, 1024, 16), (4096, 132, 32)),  # flagship, the CFG steps' 2x batch
    ((128, 128, 1024, 16), (2048, 132, 16)),  # after guidance truncation
    ((3, 128, 1024, 16), (48, 48, 1)),        # fewer tiles than SMs
    ((9, 128, 768, 12), (108, 108, 1)),       # pc_d*w768's width
    ((100, 128, 1024, 16), (1600, 132, 13)),  # a ragged last round
    ((256, 128, 1536, 16), (4096, 132, 32)),  # pc_d48w1536: 16 heads of 96
    ((5, 128, 768, 8), (40, 40, 1)),          # head dim 96 at D = 768
]


@pytest.mark.parametrize("shape,want", ATTN_PLANS, ids=[str(s) for s, _ in ATTN_PLANS])
def test_attn_block_plan(shape, want):
    b, t, d, heads = shape
    hd = d // heads
    plan = fb.attn_block_plan(b, t, d, heads, SMS)
    core = plan["core"]
    assert plan["route"] == "fused" and plan["head_dim"] == hd
    assert (core["tiles"], core["grid"], core["tiles_per_block"]) == (want[0], (want[1],), want[2])
    assert core["tiles"] == b * heads and core["grid"][0] <= min(SMS, core["tiles"])
    assert core["grid"][0] * core["tiles_per_block"] >= core["tiles"]
    assert (core["block_m"], core["block_n"], core["k_tiles"]) == (128, 3 * hd, d // 128)
    assert core["smem_bytes"] == fb.QKVC_SMEM[hd] == QKVC_SMEM[hd] <= SMEM_LIMIT
    assert core["stages"] == fb.QKVC_STAGES[hd] == (4 if hd == 64 else 3)
    # the f32 and int8 cores' QKV product and every core's out-projection
    # on the wgmma GEMM
    assert plan["qkv"] == fb.gemm_plan(b * t, 3 * d, d, SMS)
    assert plan["out"] == fb.gemm_plan(b * t, d, d, SMS)


# T off 128 (the split route) and head dim 96, up to the fused rule's bound
@pytest.mark.parametrize("t,d,heads,route", [(64, 1024, 16, "split"), (256, 1024, 16, "split"),
                                             (128, 1536, 16, "fused")],
                         ids=["T=64", "T=256", "hd=96"])
def test_attn_block_plan_takes_t_off_128_and_head_dim_96(t, d, heads, route):
    plan = fb.attn_block_plan(8, t, d, heads, SMS)
    assert plan["route"] == route and plan["head_dim"] == d // heads


@pytest.mark.parametrize("t,d,heads", [(2048, 768, 12), (436, 1024, 16), (162, 1536, 16),
                                       (608, 768, 12), (128, 1024, 32), (128, 1280, 16),
                                       (128, 1024, 8), (128, 192, 3), (128, 1024, 0),
                                       (0, 1024, 16)],
                         ids=["T=2048", "T=436 at D=1024", "T=162 at D=1536", "T=608 at D=768",
                              "hd=32", "hd=80", "hd=128", "D%128", "no heads", "T=0"])
def test_attn_block_plan_refuses_what_the_kernel_cannot_take(t, d, heads):
    with pytest.raises(NotImplementedError, match="head dim 64 or 96.*ROADMAP queue 2"):
        fb.attn_block_plan(8, t, d, heads, SMS)


POSTLN_PLANS = [  # (m, d, f, clusters): m tiles, cluster, active clusters, tiles a cluster
    ((8 * 1280, 1024, 4096, CLUSTERS), (80, 4, 33, 3)),  # the t2i decoder half
    ((8 * 768, 1024, 4096, CLUSTERS), (48, 4, 33, 2)),   # the encoder's largest bucket
    ((8 * 288, 1024, 4096, CLUSTERS), (18, 4, 18, 1)),   # the video encoder
    ((8 * 300, 1024, 4096, CLUSTERS), (19, 4, 19, 1)),   # ragged rows
    ((10240, 768, 3072, 44), (80, 3, 44, 2)),            # vit_*w768
    ((10240, 1536, 6144, 22), (80, 6, 22, 4)),           # vit_*w1536
    ((77, 1024, 4096, 1), (1, 4, 1, 1)),
]


@pytest.mark.parametrize("shape,want", POSTLN_PLANS, ids=[str(s) for s, _ in POSTLN_PLANS])
def test_mlp_postln_plan(shape, want):
    m, d, f, clusters = shape
    plan = fb.mlp_postln_plan(m, d, f, SMS, clusters)
    assert plan["fc1"] == fb.gemm_plan(m, f, d, SMS)
    fc2 = plan["fc2"]
    assert (fc2["m_tiles"], fc2["cluster"], fc2["clusters"], fc2["tiles_per_cluster"]) == want
    assert fc2["n_tiles"] == fc2["cluster"] == d // 256 <= 8
    assert fc2["grid"] == (fc2["clusters"] * fc2["cluster"],)
    assert fc2["clusters"] <= min(clusters, fc2["m_tiles"])
    assert fc2["clusters"] * fc2["tiles_per_cluster"] >= fc2["m_tiles"]
    assert fc2["m_tiles"] * 128 >= m > (fc2["m_tiles"] - 1) * 128
    assert fc2["waves"] == fc2["m_tiles"] / fc2["clusters"]
    assert fc2["k_tiles"] * 128 == f and fc2["stages"] == 4
    assert fc2["smem_bytes"] == fb.PLN_SMEM == PLN_SMEM <= SMEM_LIMIT


@pytest.mark.parametrize("d,f,clusters", [(640, 2560, CLUSTERS), (128, 512, CLUSTERS),
                                          (2304, 9216, CLUSTERS), (1024, 4032, CLUSTERS),
                                          (1024, 4096, 0)],
                         ids=["D%256", "D=128", "cluster 9", "F%128", "no cluster"])
def test_mlp_postln_plan_refuses_what_the_kernel_cannot_take(d, f, clusters):
    with pytest.raises(NotImplementedError, match="cluster"):
        fb.mlp_postln_plan(1024, d, f, SMS, clusters)


class _Recorder:
    """Stands in for the ctypes launch: records each call's name and
    arguments, each checked against its ctypes type."""

    def __init__(self):
        self.calls = []

    def lib(self, name, argtypes):
        return name, argtypes

    def run(self, so, fn, args):
        name, argtypes = so, fn
        assert len(args) == len(argtypes), name
        for a, t in zip(args, argtypes):
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
    monkeypatch.setattr(fb, "_clusters", lambda dev, size: CLUSTERS)
    for name in ("fused_attention_block_plain", "fused_int8_mlp_postln_plain"):
        monkeypatch.setattr(fb, name, None)  # never taken on this route
    reset_launch_counts()
    yield r
    reset_launch_counts()


def _w(rng, n_out, n_in):
    """An int8 weight (n_in, n_out) in the K-major layout the serving path
    pre-quantizes to, and its per-channel scales."""
    w = torch.from_numpy(rng.standard_normal((n_out, n_in)).astype(np.float32)) * n_in ** -0.5
    return quantize_weight_kmajor(w)


def _vec(rng, n, dtype=torch.bfloat16):
    return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dtype)


def _attn_operands(rng, b, d, dtype=torch.bfloat16):
    x = torch.from_numpy(rng.standard_normal((b, 128, d)).astype(np.float32)).to(dtype)
    wqkv, sqkv = _w(rng, 3 * d, d)
    wo, so = _w(rng, d, d)
    return [x, _vec(rng, d), _vec(rng, d), wqkv, sqkv, _vec(rng, 3 * d), wo, so, _vec(rng, d)]


def _postln_operands(rng, m, d, f, x_dtype=torch.float32):
    x = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32)).to(x_dtype)
    w1, s1 = _w(rng, f, d)
    w2, s2 = _w(rng, d, f)
    return [x, w1, s1, _vec(rng, f), w2, s2, _vec(rng, d), _vec(rng, d), _vec(rng, d)]


def _counting_empty(monkeypatch):
    """torch.empty, recording every tensor it makes."""
    made, real = [], torch.empty

    def empty(*a, **k):
        t = real(*a, **k)
        made.append(t)
        return t
    monkeypatch.setattr(torch, "empty", empty)
    return made


ATTN_VARIANTS = [(core, static, smax) for core in ("bf16", "f32", "int8")
                 for static in (True, False) for smax in (True, False)]


@pytest.mark.parametrize("core,static,smax", ATTN_VARIANTS,
                         ids=[f"{c}-{'static' if s else 'per-row'}-{'smax' if m else 'softmax'}"
                              for c, s, m in ATTN_VARIANTS])
def test_attention_launch_follows_the_plan(rec, monkeypatch, core, static, smax):
    rng = np.random.default_rng(7)
    b, d, heads = 3, 256, 4
    ops = _attn_operands(rng, b, d)
    kw = dict(num_heads=heads, core=core)
    if static:
        kw.update(a_in=torch.tensor(4.0), a_av=torch.tensor(3.0))
    if smax:
        kw["a_smax"] = torch.tensor(8.0)
    made = _counting_empty(monkeypatch)
    y = fb.fused_attention_block(*ops, **kw)
    (name, args), = rec.calls
    plan = fb.attn_block_plan(b, 128, d, heads, SMS)
    assert name == "fused_attention_block" and LAUNCHES["fused_attention_block"] == 1
    assert args[0] == ops[0].data_ptr() and args[1:6] == [1, b, 128, d, heads]
    # the weights reach the kernel K-major, in place: wqkv_t (3D, D), wo_t (D, D)
    assert args[11] == ops[3].data_ptr() and args[13] == ops[6].data_ptr()
    assert (args[15] is not None, args[16] is not None, args[17] is not None) == (
        static, static, smax)
    assert args[18] == fb.ATTN_CORES.index(core) and args[19] == 64 ** -0.5
    # the bf16 core writes no qkv tensor; the f32 and int8 cores an f32 one
    assert (args[22] is None) == (core == "bf16")
    assert any(tuple(t.shape) == (b * 128, 3 * d) for t in made) == (core != "bf16")
    assert (args[24] is None) == static  # the f32 attention rows on the per-row path only
    assert args[26] == y.data_ptr() and y.shape == ops[0].shape and y.dtype == ops[0].dtype
    # the bf16 core's one kernel, or the f32 / int8 cores' block of T threads a
    # (head, sample); their QKV product on the GEMM's 128 x 256 tiles
    core_grid, core_smem = ((plan["core"]["grid"][0], fb.QKVC_SMEM[64]) if core == "bf16"
                            else (b * heads, 0 if core == "f32" else 2 * 128 * 64 + 8 * 128))
    assert args[27:34] == [core_grid, core_smem, plan["qkv"]["grid"][0], 256, fb.WG_SMEM,
                           plan["out"]["grid"][0], fb.WG_SMEM]
    assert args[34] == 0  # the stream


@pytest.mark.parametrize("m,d,f", [(300, 256, 512), (2400, 1024, 4096), (77, 512, 384)])
@pytest.mark.parametrize("static", [True, False], ids=["static", "per-row"])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mlp_postln_launch_follows_the_plan(rec, m, d, f, static, x_dtype):
    rng = np.random.default_rng(m + d)
    ops = _postln_operands(rng, m, d, f, x_dtype)
    kw = dict(a_x=torch.tensor(4.0), a_gelu=torch.tensor(3.0)) if static else {}
    y = fb.fused_int8_mlp_postln(*ops, ln_eps=1e-5, **kw)
    (name, args), = rec.calls
    plan = fb.mlp_postln_plan(m, d, f, SMS, CLUSTERS)
    assert name == "fused_int8_mlp_postln" and LAUNCHES["fused_int8_mlp_postln"] == 1
    assert args[0] == ops[0].data_ptr() and args[1:5] == [int(x_dtype == torch.bfloat16), m, d, f]
    assert args[9] == 1 and args[10] == pytest.approx(1e-5)
    # the weights reach the kernel K-major, in place: w1t (F, D), w2t (D, F)
    assert args[11] == ops[1].data_ptr() and args[13] == ops[4].data_ptr()
    assert (args[15] is not None, args[16] is not None) == (static, static)
    assert (args[20] is None) == static  # the f32 mid rows on the per-row path only
    assert args[22] == y.data_ptr() and y.shape == ops[0].shape and y.dtype == x_dtype
    assert args[23:28] == [plan["fc1"]["grid"][0], fb.WG_SMEM, plan["fc2"]["grid"][0],
                           d // 256, fb.PLN_SMEM]
    assert args[28] == 0


def test_mlp_postln_asks_for_the_clusters_of_its_width(rec, monkeypatch):
    asked = []
    monkeypatch.setattr(fb, "_clusters", lambda dev, size: asked.append(size) or 5)
    rng = np.random.default_rng(11)
    fb.fused_int8_mlp_postln(*_postln_operands(rng, 2000, 768, 1536))
    (_, args), = rec.calls
    assert asked == [3]
    assert args[25:27] == [5 * 3, 3]  # five clusters of three blocks: 16 m-tiles, 5 at once


def _raises_before_launch(rec, exc, fn, match=None):
    with pytest.raises(exc, match=match):
        fn()
    assert rec.calls == []
    assert LAUNCHES["fused_attention_block"] == LAUNCHES["fused_int8_mlp_postln"] == 0


def test_attention_argument_checks_raise_before_any_launch(rec):
    rng = np.random.default_rng(3)
    ops = _attn_operands(rng, 2, 256)
    s = torch.tensor(4.0)
    # tokens above the fused rule's bound at D = 256 (1059), head dim
    x_long = ops[0][:, :1].expand(2, 1060, 256)
    _raises_before_launch(rec, NotImplementedError,
                          lambda: fb.fused_attention_block(x_long, *ops[1:], num_heads=4),
                          "T=1060")
    _raises_before_launch(rec, NotImplementedError,
                          lambda: fb.fused_attention_block(*ops, num_heads=8), "head dim 64 or 96")
    # static scales all or none; the core's name
    _raises_before_launch(rec, ValueError,
                          lambda: fb.fused_attention_block(*ops, num_heads=4, a_in=s))
    _raises_before_launch(rec, ValueError,
                          lambda: fb.fused_attention_block(*ops, num_heads=4, a_av=s))
    _raises_before_launch(rec, ValueError,
                          lambda: fb.fused_attention_block(*ops, num_heads=4, core="fp8"))
    # weights of the wrong type or shape
    bad = list(ops)
    bad[3] = ops[3].float()
    _raises_before_launch(rec, ValueError, lambda: fb.fused_attention_block(*bad, num_heads=4))
    bad = list(ops)
    bad[6] = ops[6][:, :-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_attention_block(*bad, num_heads=4))
    # x and the vectors: float32 or bfloat16, the vectors of one dtype
    bad = list(ops)
    bad[0] = ops[0].half()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_attention_block(*bad, num_heads=4))
    bad = list(ops)
    bad[5] = ops[5].float()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_attention_block(*bad, num_heads=4))


def test_mlp_postln_argument_checks_raise_before_any_launch(rec, monkeypatch):
    monkeypatch.setattr(fb, "_clusters", None)  # the widths are refused before the query
    rng = np.random.default_rng(4)
    ops = _postln_operands(rng, 64, 256, 512)
    s = torch.tensor(4.0)
    # widths: off the GEMM's 128; off the cluster's 256; a cluster over 8
    for d, f in ((192, 512), (256, 320)):
        _raises_before_launch(rec, NotImplementedError,
                              lambda: fb.fused_int8_mlp_postln(*_postln_operands(rng, 8, d, f)),
                              "multiples of 128")
    for d, f in ((384, 512), (2304, 512)):
        _raises_before_launch(rec, NotImplementedError,
                              lambda: fb.fused_int8_mlp_postln(*_postln_operands(rng, 8, d, f)),
                              "cluster")
    monkeypatch.setattr(fb, "_clusters", lambda dev, size: CLUSTERS)
    # static scales all or none
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_mlp_postln(*ops, a_x=s))
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_mlp_postln(*ops, a_gelu=s))
    # weights of the wrong type or shape
    bad = list(ops)
    bad[1] = ops[1].to(torch.uint8)
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_mlp_postln(*bad))
    bad = list(ops)
    bad[4] = ops[4][:-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_mlp_postln(*bad))
    # x and the vectors
    bad = list(ops)
    bad[0] = ops[0].half()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_int8_mlp_postln(*bad))
    bad = list(ops)
    bad[7] = ops[7].float()
    _raises_before_launch(rec, TypeError, lambda: fb.fused_int8_mlp_postln(*bad))


# the per-channel vectors of the wrappers' operands, by their index in
# _attn_operands / _postln_operands: the kernels read D, F or 3D of each
ATTN_VECTORS = {"ln_scale": 1, "ln_bias": 2, "wqkv_s": 4, "bqkv": 5, "wo_s": 7, "bo": 8}
ATTN_DEVICE_VECTORS = ("ln_scale", "ln_bias", "bqkv", "bo")  # the LN params and biases
POSTLN_VECTORS = {"s1": 2, "b1": 3, "s2": 5, "b2": 6, "ln_scale": 7, "ln_bias": 8}
POSTLN_DEVICE_VECTORS = ("b1", "b2", "ln_scale", "ln_bias")


@pytest.mark.parametrize("which", list(ATTN_VECTORS))
def test_attention_short_vector_raises_before_any_launch(rec, which):
    """A vector one value short: the kernel would read past its end."""
    ops = _attn_operands(np.random.default_rng(12), 2, 256)
    ops[ATTN_VECTORS[which]] = ops[ATTN_VECTORS[which]][:-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_attention_block(*ops, num_heads=4),
                          which)


@pytest.mark.parametrize("which", ATTN_DEVICE_VECTORS)
def test_attention_vector_off_the_device_raises_before_any_launch(rec, which):
    """An LN param or bias on another device than x: the kernel would get
    that device's pointer."""
    ops = _attn_operands(np.random.default_rng(13), 2, 256)
    ops[ATTN_VECTORS[which]] = ops[ATTN_VECTORS[which]].to("meta")
    _raises_before_launch(rec, ValueError, lambda: fb.fused_attention_block(*ops, num_heads=4),
                          "device|meta")


@pytest.mark.parametrize("which", list(POSTLN_VECTORS))
def test_mlp_postln_short_vector_raises_before_any_launch(rec, which):
    ops = _postln_operands(np.random.default_rng(14), 64, 256, 512)
    ops[POSTLN_VECTORS[which]] = ops[POSTLN_VECTORS[which]][:-1]
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_mlp_postln(*ops), which)


@pytest.mark.parametrize("which", POSTLN_DEVICE_VECTORS)
def test_mlp_postln_vector_off_the_device_raises_before_any_launch(rec, which):
    ops = _postln_operands(np.random.default_rng(15), 64, 256, 512)
    ops[POSTLN_VECTORS[which]] = ops[POSTLN_VECTORS[which]].to("meta")
    _raises_before_launch(rec, ValueError, lambda: fb.fused_int8_mlp_postln(*ops), "device|meta")


def _unaligned(t):
    """A contiguous copy of ``t`` one element off a 16-byte boundary."""
    store = torch.zeros(t.numel() + 1, dtype=t.dtype)
    store[1:] = t.reshape(-1)
    out = store[1:].view(t.shape)
    assert out.data_ptr() % 16 != 0 and out.is_contiguous()
    return out


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_attention_unaligned_x_is_copied_before_the_launch(rec, x_dtype):
    """The direct residual epilogue reads x in bf16 or f32 pairs: a
    contiguous view off a 16-byte boundary reaches the kernel as an aligned
    copy."""
    ops = _attn_operands(np.random.default_rng(16), 2, 256, x_dtype)
    ops[0] = _unaligned(ops[0])
    y = fb.fused_attention_block(*ops, num_heads=4, core="bf16")
    (_, args), = rec.calls
    assert args[0] % 16 == 0 and args[0] != ops[0].data_ptr()
    assert y.shape == ops[0].shape and y.dtype == x_dtype


def test_mlp_postln_unaligned_x_is_copied_before_the_launch(rec):
    ops = _postln_operands(np.random.default_rng(17), 64, 256, 512)
    ops[0] = _unaligned(ops[0])
    y = fb.fused_int8_mlp_postln(*ops)
    (_, args), = rec.calls
    assert args[0] % 16 == 0 and args[0] != ops[0].data_ptr()
    assert y.shape == ops[0].shape and y.dtype == ops[0].dtype


def _off_by_one_byte(w):
    """The same (in, out) int8 weight as a view whose K-major rows start one
    byte past a 16-byte boundary."""
    wt = w.t()
    store = torch.zeros(wt.numel() + 1, dtype=torch.int8)
    store[1:] = wt.reshape(-1)
    out = store[1:].view(wt.shape).t()
    assert out.t().data_ptr() % 16 != 0 and torch.equal(out, w)
    return out


def test_unaligned_weights_are_copied_before_the_launch(rec):
    """TMA reads from 16-byte-aligned addresses only: a weight view off that
    boundary reaches either kernel as an aligned copy."""
    rng = np.random.default_rng(5)
    ops = _attn_operands(rng, 2, 256)
    ops[3], ops[6] = _off_by_one_byte(ops[3]), _off_by_one_byte(ops[6])
    fb.fused_attention_block(*ops, num_heads=4, core="bf16")
    ops = _postln_operands(rng, 64, 256, 512)
    ops[1], ops[4] = _off_by_one_byte(ops[1]), _off_by_one_byte(ops[4])
    fb.fused_int8_mlp_postln(*ops)
    (_, attn), (_, mlp) = rec.calls
    for a in (attn[11], attn[13], mlp[11], mlp[13]):
        assert a % 16 == 0 and ctypes.c_void_p(a).value == a

"""Row 1 (``fused_attention_block``) at head dim 96 and at T != 128, on the
CPU: the port's plain version against the JAX Pallas kernel in interpret
mode on the same numpy inputs, at head dim 96 (D = 192, 2 heads) at T = 128
and 40 and at head dim 64 (D = 128) at T = 1, 40 and 200; the launch plan
(``attn_block_plan``: route, grid, tiles and shared memory) at the driven
shapes (``bench.py --arch pc_d48w1536``, ``bench.py --points 4096``) and
at the fused rule's bounds; the launch arguments of the new routes (the
launch, the card's SM count and the stream replaced by a recorder and
constants, so CPU tensors take the CUDA route up to the recorded launch),
each with its head dim's own softmax scale; and a small pc model at head
dim 96 (the test-only ``pc_d2w192``, added to both packages' registries
with ``monkeypatch.setitem``) against JAX at one step of the calibrated int8
call.

Tolerances: the kernel parity as ``test_torch_pointcloud.py``'s int8
forward, mean |diff| < 1e-3 and max < 5e-2; the model step against the JAX
call's own floor (its test says how). Both sides quantize the same f32 values with the same rounding, but
at these sizes an f32 sum taken in another order flips an int8 code of the
attention output (or a bf16 p) here and there, and a flipped code moves its
row by ~1e-3 (test_torch_fused_block.py's atol 1e-4 holds only where every
code agrees). Measured: the port against JAX mean <= 1.3e-4, max <= 1.1e-2;
JAX against itself with x moved by 1e-6 relative mean <= 6.1e-4, max <=
1.8e-2; hd 64's softmax scale at hd 96 (the fault the wrapper's scale
argument guards against) mean >= 1.2e-1, at hd 64 hd 96's mean >= 4.2e-2
(at T = 1 the scale cannot show: one key). The plans and arguments are
exact.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nova_pointcloud_tpu.models import pointcloud as jpc
from nova_pointcloud_tpu.models.text_encoders.dummy import DummyTextEncoder as JEnc
from nova_pointcloud_tpu.ops import quantization as jq
from nova_pointcloud_tpu.ops.pallas import fused_block as jfb
from nova_pointcloud_tpu.pipelines.pointcloud_gen import (
    NOVAPointCloudGenerationPipeline as JPipe)
from nova_pointcloud_tpu.schedulers.ddpm import DDPMScheduler as JDDPM
from nova_pointcloud_tpu_torch.models import pointcloud as tpc
from nova_pointcloud_tpu_torch.models.convert import convert_params, convert_tree
from nova_pointcloud_tpu_torch.ops.kernels import LAUNCHES, reset_launch_counts
from nova_pointcloud_tpu_torch.ops.kernels import fused_block as tfb
from nova_pointcloud_tpu_torch.ops.quantization import quantize_weight_kmajor

MEAN_ATOL, MAX_ATOL = 1e-3, 5e-2
SMS = 132  # the H100's streaming multiprocessors
SMEM_LIMIT = 232448  # a block's shared memory on the H100


def _t(a):
    return torch.from_numpy(np.array(a))


def _attn_operands(seed, b, t, d):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((b, t, d)) * 0.5).astype(f)
    lns = (rng.standard_normal(d) * 0.1 + 1.0).astype(f)
    lnb = (rng.standard_normal(d) * 0.1).astype(f)
    wqkv = jq.quantize_weight(jnp.asarray(rng.standard_normal((d, 3 * d)) * 0.1, jnp.float32))
    bqkv = (rng.standard_normal(3 * d) * 0.02).astype(f)
    wo = jq.quantize_weight(jnp.asarray(rng.standard_normal((d, d)) * 0.1, jnp.float32))
    bo = (rng.standard_normal(d) * 0.02).astype(f)
    return [x, lns, lnb, np.asarray(wqkv.values), np.asarray(wqkv.scales), bqkv,
            np.asarray(wo.values), np.asarray(wo.scales), bo]


# (T, D, heads) with the core and its variant (static quant, smax): the
# bf16 core in its four quant / smax variants at head dim 96 and T = 128
# (the pc_d48w1536 route); one variant each at head dim 96, T = 40 and head
# dim 64, T = 1, 40, 200 (the split route); the f32 and int8 cores once each
# at head dim 96 (each JAX call in interpret mode takes about a second)
PARITY = ([((128, 192, 2), "bf16", static, smax) for static in (True, False)
           for smax in (True, False)]
          + [((40, 192, 2), "bf16", False, False), ((1, 128, 2), "bf16", True, True),
             ((40, 128, 2), "bf16", False, True), ((200, 128, 2), "bf16", True, False),
             ((128, 192, 2), "f32", True, False), ((40, 192, 2), "int8", False, True)])


@pytest.mark.parametrize(
    "shape,core,static,smax", PARITY,
    ids=[f"T{s[0]}-hd{s[1] // s[2]}-{c}-{'static' if st else 'per-row'}-"
         f"{'smax' if m else 'softmax'}" for s, c, st, m in PARITY])
def test_attention_block_matches_jax(shape, core, static, smax):
    t, d, heads = shape
    ops = _attn_operands(seed=t + d, b=2, t=t, d=d)
    kw = {}
    if static:
        kw.update(a_in=np.float32(4.0), a_av=np.float32(1.5))
    if smax:
        kw["a_smax"] = np.float32(3.0)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jfb.fused_attention_block(
            *[jnp.asarray(o) for o in ops], num_heads=heads, core=core,
            **{k: jnp.asarray(v) for k, v in kw.items()}))
    got = tfb.fused_attention_block(*[_t(o) for o in ops], num_heads=heads, core=core,
                                    **{k: torch.tensor(v) for k, v in kw.items()})
    assert got.dtype == torch.float32 and got.shape == ref.shape
    err = np.abs(got.numpy() - ref)
    assert err.mean() < MEAN_ATOL and err.max() < MAX_ATOL, (err.mean(), err.max())
    assert not any(LAUNCHES.values())


def _qkvc_smem(hd):
    """csrc/fused_attention_block.cu, Layout<hd>: 4 stages at hd 64, 3 at
    96, of a 128 x 128-byte A tile and three hd x 128-byte weight boxes; K
    and V (128 x hd bf16 each); a full and an empty mbarrier a stage; 3 hd
    column scales and biases for each of two consumers; 1 KB to align."""
    stages = 4 if hd == 64 else 3
    return (stages * (128 + 3 * hd) * 128 + 2 * 128 * hd * 2 + 2 * stages * 8
            + 2 * 2 * 3 * hd * 4 + 1024)


def _core16_smem(hd):
    """attn_core_bf16_kernel<hd>: a 64-key chunk of K and of V, rows of hd +
    8 bf16."""
    return 2 * 64 * (hd + 8) * 2


PLANS = [  # (b, t, d, heads): route, core grid
    ((256, 128, 1536, 16), "fused", 132),    # bench.py --arch pc_d48w1536, 2x batch
    ((128, 128, 1536, 16), "fused", 132),    # its 1x batch
    ((3, 128, 1536, 16), "fused", 48),       # fewer tiles than SMs
    ((256, 256, 1024, 16), "split", 256 * 16 * 4),  # bench.py --points 4096
    ((128, 256, 1024, 16), "split", 128 * 16 * 4),
    ((8, 1, 1536, 16), "split", 8 * 16),
    ((8, 161, 1536, 16), "split", 8 * 16 * 3),    # the fused rule's bound at D = 1536
    ((8, 435, 1024, 16), "split", 8 * 16 * 7),    # at D = 1024
    ((8, 607, 768, 12), "split", 8 * 12 * 10),    # at D = 768, head dim 64
    ((8, 607, 768, 8), "split", 8 * 8 * 10),      # and head dim 96
    ((8, 64, 768, 8), "split", 8 * 8),
]


@pytest.mark.parametrize("shape,route,grid", PLANS, ids=[str(s) for s, _, _ in PLANS])
def test_attn_block_plan_at_the_new_shapes(shape, route, grid):
    b, t, d, heads = shape
    hd = d // heads
    plan = tfb.attn_block_plan(b, t, d, heads, SMS)
    assert plan["route"] == route and plan["head_dim"] == hd
    core = plan["core"]
    assert core["grid"] == (grid,)
    if route == "fused":
        tiles = b * heads
        assert (core["tiles"], core["tiles_per_block"]) == (tiles, -(-tiles // grid))
        assert (core["block_m"], core["block_n"], core["k_tiles"]) == (128, 3 * hd, d // 128)
        assert core["stages"] == tfb.QKVC_STAGES[hd] == (4 if hd == 64 else 3)
        assert core["smem_bytes"] == tfb.QKVC_SMEM[hd] == _qkvc_smem(hd) <= SMEM_LIMIT
        assert plan["qkv_bf16"] is None
    else:
        assert core["q_tiles"] == core["key_chunks"] == -(-t // 64)
        assert core["threads"] == 128
        assert core["smem_bytes"] == tfb.CORE16_SMEM[hd] == _core16_smem(hd) <= 48 * 1024
        # the bf16 qkv on the wgmma GEMM, stored by TMA
        assert plan["qkv_bf16"] == tfb.store_plan(b * t, 3 * d, d, SMS, True)
        assert plan["qkv_bf16"]["tma_store"] and plan["qkv_bf16"]["smem_bytes"] <= SMEM_LIMIT
    # the f32 and int8 cores: a block of T threads a (head, sample)
    for c, smem in (("f32", 0), ("int8", 2 * t * hd + 8 * t)):
        assert plan["scalar"][c] == dict(grid=(b * heads,), threads=t, smem_bytes=smem)
        assert t <= 608 and smem <= SMEM_LIMIT  # csrc: a block of at most kScalarMaxT threads
    assert plan["qkv"] == tfb.gemm_plan(b * t, 3 * d, d, SMS)
    assert plan["out"] == tfb.gemm_plan(b * t, d, d, SMS)


@pytest.mark.parametrize("t,d,fused", [(161, 1536, True), (162, 1536, False),
                                       (435, 1024, True), (436, 1024, False),
                                       (607, 768, True), (608, 768, False)])
def test_plan_takes_t_up_to_the_fused_rules_bound(t, d, fused):
    """The plan admits exactly what the JAX model's fused rule sends to the
    fused kernel (above it the model takes the split path)."""
    assert (jfb.attention_block_vmem_bytes(t, d) <= 14 * 2**20) == fused
    if fused:
        assert tfb.attn_block_plan(2, t, d, 16 if d != 768 else 12, SMS)["route"] == "split"
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            tfb.attn_block_plan(2, t, d, 16 if d != 768 else 12, SMS)


class _Recorder:
    """Stands in for the ctypes launch: records each call's arguments, each
    checked against its ctypes type."""

    def __init__(self):
        self.calls = []

    def lib(self, name, argtypes):
        return name, argtypes

    def run(self, so, fn, args):
        assert len(args) == len(fn), so
        for a, typ in zip(args, fn):
            if a is not None:
                typ(a)
        self.calls.append((so, args))


@pytest.fixture
def rec(monkeypatch):
    r = _Recorder()
    monkeypatch.setattr(tfb, "_load_lib", r.lib)
    monkeypatch.setattr(tfb, "_run", r.run)
    monkeypatch.setattr(tfb, "_plain_route", lambda x: False)  # CPU tensors take the CUDA route
    monkeypatch.setattr(tfb, "_stream", lambda dev: 0)
    monkeypatch.setattr(tfb, "_sms", lambda dev: SMS)
    monkeypatch.setattr(tfb, "fused_attention_block_plain", None)  # never taken here
    reset_launch_counts()
    yield r
    reset_launch_counts()


def _kernel_operands(rng, b, t, d):
    def w(n_out, n_in):
        m = torch.from_numpy(rng.standard_normal((n_out, n_in)).astype(np.float32))
        return quantize_weight_kmajor(m * n_in ** -0.5)

    def vec(n):
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)

    x = torch.from_numpy(rng.standard_normal((b, t, d)).astype(np.float32)).to(torch.bfloat16)
    (wqkv, sqkv), (wo, so) = w(3 * d, d), w(d, d)
    return [x, vec(d), vec(d), wqkv, sqkv, vec(3 * d), wo, so, vec(d)]


LAUNCH_CASES = [  # (t, d, heads, core)
    (128, 384, 4, "bf16"),   # head dim 96, the one-kernel route
    (40, 256, 4, "bf16"),    # head dim 64, the split route
    (40, 384, 4, "bf16"),    # head dim 96, the split route
    (200, 768, 8, "f32"),    # head dim 96, the scalar cores
    (40, 384, 4, "int8"),
]


@pytest.mark.parametrize("t,d,heads,core", LAUNCH_CASES,
                         ids=[f"T{t}-hd{d // h}-{c}" for t, d, h, c in LAUNCH_CASES])
def test_launch_carries_the_head_dims_scale(rec, monkeypatch, t, d, heads, core):
    rng = np.random.default_rng(t + d)
    b, hd = 3, d // heads
    ops = _kernel_operands(rng, b, t, d)
    made, real = [], torch.empty

    def empty(*a, **k):
        out = real(*a, **k)
        made.append(out)
        return out
    monkeypatch.setattr(torch, "empty", empty)
    y = tfb.fused_attention_block(*ops, num_heads=heads, core=core,
                                  a_in=torch.tensor(4.0), a_av=torch.tensor(3.0))
    (name, args), = rec.calls
    plan = tfb.attn_block_plan(b, t, d, heads, SMS)
    assert name == "fused_attention_block" and LAUNCHES["fused_attention_block"] == 1
    assert args[1:6] == [1, b, t, d, heads]
    assert args[18] == tfb.ATTN_CORES.index(core)
    assert args[19] == pytest.approx(hd ** -0.5, rel=1e-7)
    if core != "bf16":
        core_plan, qkv_plan, qkv_dtype = plan["scalar"][core], plan["qkv"], torch.float32
    elif t == 128:
        core_plan, qkv_plan, qkv_dtype = plan["core"], plan["qkv"], None
    else:
        core_plan, qkv_plan, qkv_dtype = plan["core"], plan["qkv_bf16"], torch.bfloat16
    qkv = [m for m in made if tuple(m.shape) == (b * t, 3 * d)]
    if qkv_dtype is None:  # q, k and v stay on chip
        assert args[22] is None and qkv == []
    else:
        assert len(qkv) == 1 and qkv[0].dtype == qkv_dtype and args[22] == qkv[0].data_ptr()
    assert args[26] == y.data_ptr() and y.shape == ops[0].shape
    assert args[27:34] == [core_plan["grid"][0], core_plan["smem_bytes"], qkv_plan["grid"][0],
                           qkv_plan["block_n"], qkv_plan["smem_bytes"],
                           plan["out"]["grid"][0], plan["out"]["smem_bytes"]]


@pytest.mark.parametrize("t,d,heads", [(128, 1280, 16), (128, 1024, 8), (128, 1024, 32),
                                       (436, 1024, 16), (0, 1024, 16)],
                         ids=["hd80", "hd128", "hd32", "T over the bound", "T=0"])
def test_launch_refuses_what_the_kernels_do_not_take(rec, t, d, heads):
    ops = _kernel_operands(np.random.default_rng(5), 2, t, d)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        tfb.fused_attention_block(*ops, num_heads=heads, core="bf16")
    assert rec.calls == [] and LAUNCHES["fused_attention_block"] == 0


# -- a small pc model at head dim 96 -------------------------------------------

ARCH, POINTS, TOK_DIM, N_TOK, STEPS = "pc_d2w192", 64, 32, 8, 5
PROMPTS = ["a chair", "a tall lamp"]


@pytest.fixture
def hd96_arch(monkeypatch):
    for mod in (jpc, tpc):
        monkeypatch.setitem(mod.PC_ARCHES, ARCH, (2, 192, 2))


def test_pc_model_at_head_dim_96_matches_jax_int8_step(hd96_arch):
    """One model forward at the first step of the calibrated int8 call (t =
    800, CFG 2x batch), the fused kernel (interpret mode) on the JAX side,
    the plain version on the port's; 64 tokens of 192 wide, 2 heads of 96.
    Through 2 blocks the int8 codes flip here and there (64 tokens x 192
    codes a site): the gate is the JAX call's own floor, its distance from
    itself with x moved by 1e-6, as chip_smoke.py's forward gate (2 x floor
    + 1e-3; measured: the port 1.9e-3, the floor 1.4e-3; hd 64's softmax
    scale in the port's core 1.9e-2)."""
    kw = dict(arch=ARCH, point_cloud_size=POINTS, patch_size=1, text_token_dim=TOK_DIM,
              quantize=True)
    jm = jpc.NOVAPointCloudTransformer(**kw, dropout=0.0)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((2, POINTS, 3)),
                              jnp.zeros((2,), jnp.int32), jnp.zeros((2, N_TOK, TOK_DIM)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree.map(
        lambda p: (np.asarray(p) + rng.normal(0, 0.05, p.shape)).astype(np.float32), params)
    jp = JPipe(jm, params, JDDPM(beta_schedule="squaredcos_cap_v2"),
               text_encoder=JEnc(TOK_DIM, N_TOK))
    scales = jp.calibrate(PROMPTS, num_points=POINTS, num_diffusion_steps=STEPS)
    qp = jq.merge_act_scales(jq.quantize_serving_params(params), scales)
    tm = tpc.NOVAPointCloudTransformer(**kw, device="cpu")
    tm.load_state_dict(convert_params(params))
    text = jp.encode_prompt(PROMPTS)
    x = np.random.default_rng(11).standard_normal((4, POINTS, 3)).astype(np.float32)
    moved = x + 1e-6 * np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    ts = np.full((4,), 800, np.int32)
    apply = jax.jit(jm.apply)  # interpret-mode Pallas runs an eager call op by op
    with pltpu.force_tpu_interpret_mode(), mock.patch.object(jax, "default_backend",
                                                             lambda: "tpu"):
        ref, ref_moved = (np.asarray(apply({"params": params, "qparams": qp}, jnp.asarray(a),
                                           jnp.asarray(ts), jnp.asarray(text)))
                          for a in (x, moved))
    got = tm(torch.from_numpy(x), torch.from_numpy(ts), torch.from_numpy(text),
             qparams=convert_tree(qp)).detach().numpy()
    assert tm.blocks.layers[0].num_heads == 2 and np.abs(ref).max() > 0.1
    floor = np.abs(ref_moved - ref).mean()
    err = np.abs(got - ref)
    assert err.mean() <= 2 * floor + 1e-3 and err.max() < MAX_ATOL, (err.mean(), floor,
                                                                        err.max())
    assert not any(LAUNCHES.values())

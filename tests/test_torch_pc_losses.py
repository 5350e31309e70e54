"""The t2pc training slice's geometry, losses and data vs the JAX package on
the CPU: point ops, Chamfer (plain and density-weighted), Sinkhorn EMD and
its envelope gradient, the AR-consistency and composite losses, the
Hungarian EMD, the partition layout, and the datasets / batcher /
normalizer, on the same numpy inputs.

Tolerances (float32, another summation order): 1e-6 relative for the
direct-difference ops and the Chamfer terms; 1e-5 relative for the
Sinkhorn value and gradient (30-50 log-domain iterations) and the losses
built on it; the kNN indices, the partition layout, the Hungarian EMD and
every data-side array exactly (numpy code, the same seeds).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_pointcloud_tpu.data import shapenet as jdata
from nova_pointcloud_tpu.ops import losses as jloss
from nova_pointcloud_tpu.ops import pointops as jpo
from nova_pointcloud_tpu.schedulers.ddpm import DDPMScheduler as JDDPM
from nova_pointcloud_tpu_torch.data import shapenet as tdata
from nova_pointcloud_tpu_torch.ops import losses as tloss
from nova_pointcloud_tpu_torch.ops import pointops as tpo
from nova_pointcloud_tpu_torch.schedulers.ddpm import DDPMScheduler as TDDPM


def _clouds(seed, b=3, n=96, m=80):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, n, 3)).astype(np.float32) * 0.5,
            rng.standard_normal((b, m, 3)).astype(np.float32) * 0.5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref, rtol, label=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-30)
    assert err <= rtol, f"{label}: relative error {err:.3e} > {rtol:.0e}"


@pytest.mark.parametrize("chunk", [256, 32])
def test_exact_min_sqdist_matches_jax(chunk):
    a, b = _clouds(0)
    ref = jpo.exact_min_sqdist(jnp.asarray(a), jnp.asarray(b), chunk=chunk)
    _rel(tpo.exact_min_sqdist(_t(a), _t(b), chunk=chunk), ref, 1e-6)


def test_knn_and_local_density_match_jax():
    a, b = _clouds(1)
    jd, ji = jpo.knn(jnp.asarray(a), jnp.asarray(b), 5)
    td, ti = tpo.knn(_t(a), _t(b), 5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _rel(td, jd, 1e-6, "knn distances")
    _rel(tpo.local_density(_t(b), 8), jpo.local_density(jnp.asarray(b), 8), 1e-6, "density")


@pytest.mark.parametrize("squared", [True, False])
def test_chamfer_matches_jax(squared):
    a, b = _clouds(2)
    ref = jloss.chamfer_distance(jnp.asarray(a), jnp.asarray(b), squared=squared)
    _rel(tloss.chamfer_distance(_t(a), _t(b), squared=squared), ref, 1e-6)


def test_density_weighted_chamfer_matches_jax():
    a, b = _clouds(3)
    ref = jloss.density_weighted_chamfer(jnp.asarray(a), jnp.asarray(b), k=8)
    _rel(tloss.density_weighted_chamfer(_t(a), _t(b), k=8), ref, 1e-6)


@pytest.mark.parametrize("eps,iters", [(0.05, 30), (0.02, 50)])
def test_sinkhorn_value_and_envelope_gradient_match_jax(eps, iters):
    a, b = _clouds(4, n=64, m=64)
    w = np.random.default_rng(5).uniform(0.5, 1.5, (a.shape[0],)).astype(np.float32)

    def jf(p):
        return jnp.sum(jloss.sinkhorn_emd(p, jnp.asarray(b), eps, iters) * w)

    jval, jgrad = jax.value_and_grad(jf)(jnp.asarray(a))
    p = _t(a).requires_grad_()
    val = torch.sum(tloss.sinkhorn_emd(p, _t(b), eps, iters) * _t(w))
    val.backward()
    _rel(val.detach(), jval, 1e-5, "value")
    _rel(p.grad, jgrad, 1e-5, "envelope gradient")


def _partition(seed, n, k):
    """JAX's dynamic_partition and the permutation / order it draws."""
    key = jax.random.PRNGKey(seed)
    order, ids = jpo.dynamic_partition(key, n, k)
    key_p, key_o = jax.random.split(key)
    return (np.asarray(order), np.asarray(ids), np.asarray(jax.random.permutation(key_p, n)),
            np.asarray(jax.random.permutation(key_o, k)))


@pytest.mark.parametrize("n,k", [(64, 16), (96, 4)])
def test_dynamic_partition_layout_given_jax_draws(n, k):
    order, ids, perm, ordr = _partition(7, n, k)
    t_order, t_ids = tpo.dynamic_partition(None, n, k, perm=_t(perm), order=_t(ordr))
    np.testing.assert_array_equal(t_ids.numpy(), ids)
    np.testing.assert_array_equal(t_order.numpy(), order)
    assert t_ids.dtype == torch.int32 and t_ids.shape == (k, n // k)
    # the port's own draws: a permutation laid out the same way
    o2, ids2 = tpo.dynamic_partition(torch.Generator().manual_seed(0), n, k)
    assert sorted(ids2.flatten().tolist()) == list(range(n)) and sorted(o2.tolist()) == list(range(k))
    with pytest.raises(ValueError):
        tpo.dynamic_partition(torch.Generator(), n + 1, k)


def test_ar_consistency_and_composite_loss_match_jax():
    a, b = _clouds(8, b=2, n=64, m=64)
    _, ids, _, _ = _partition(9, 64, 16)
    rng = np.random.default_rng(10)
    pred, target = (rng.standard_normal((2, 64, 3)).astype(np.float32) for _ in range(2))
    _rel(tloss.ar_consistency_loss(_t(a), _t(ids)),
         jloss.ar_consistency_loss(jnp.asarray(a), jnp.asarray(ids)), 1e-6, "ar")
    for sub in (None, ids):
        ref = jloss.composite_pointcloud_loss(
            jnp.asarray(pred), jnp.asarray(target), jnp.asarray(a), jnp.asarray(b),
            None if sub is None else jnp.asarray(sub), weights={"chamfer": 0.2})
        got = tloss.composite_pointcloud_loss(_t(pred), _t(target), _t(a), _t(b),
                                              None if sub is None else _t(sub),
                                              weights={"chamfer": 0.2})
        assert set(got) == set(ref)
        for name in ref:
            _rel(got[name].detach(), ref[name], 1e-5, name)


def test_hungarian_emd_is_exactly_jax():
    a, b = _clouds(11, b=1, n=50, m=50)
    assert tloss.hungarian_emd_host(a[0], b[0]) == jloss.hungarian_emd_host(a[0], b[0])


def test_ddpm_training_side_matches_jax():
    """sample_timesteps draws uniform integers in [0, T) (statistics: the
    mean within 5 standard errors of (T - 1) / 2); add_noise, get_velocity
    and predict_x0 at given draws within 1e-6 relative."""
    t = TDDPM(beta_schedule="squaredcos_cap_v2").sample_timesteps(
        torch.Generator().manual_seed(0), (4096,))
    assert t.dtype == torch.int64 and int(t.min()) >= 0 and int(t.max()) <= 999
    assert abs(float(t.float().mean()) - 499.5) < 5 * 288.7 / 64
    x, n = _clouds(12, b=2, n=32, m=32)
    ts = np.array([3, 870], np.int32)
    for pt in ("epsilon", "sample", "v_prediction"):
        js, tsch = JDDPM(beta_schedule="squaredcos_cap_v2", prediction_type=pt), \
            TDDPM(beta_schedule="squaredcos_cap_v2", prediction_type=pt)
        xt = js.add_noise(jnp.asarray(x), jnp.asarray(n), jnp.asarray(ts))
        _rel(tsch.add_noise(_t(x), _t(n), _t(ts)), xt, 1e-6, "add_noise")
        _rel(tsch.get_velocity(_t(x), _t(n), _t(ts)),
             js.get_velocity(jnp.asarray(x), jnp.asarray(n), jnp.asarray(ts)), 1e-6, "v")
        _rel(tsch.predict_x0(_t(n), _t(ts), _t(np.asarray(xt))),
             js.predict_x0(jnp.asarray(n), jnp.asarray(ts), xt), 1e-6, "x0")


# -- data -------------------------------------------------------------------------

def test_synthetic_clouds_and_batches_are_bitwise_jax():
    js, ts = jdata.make_synthetic_clouds(7, 128, 3), tdata.make_synthetic_clouds(7, 128, 3)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(a["points"], b["points"])
        assert a["prompt"] == b["prompt"] and a["synset"] == b["synset"]
    jb, tb = jdata.make_batches(js, 3, 100, seed=5), tdata.make_batches(ts, 3, 100, seed=5)
    for _ in range(4):  # past an epoch: the reshuffle too
        a, b = next(jb), next(tb)
        np.testing.assert_array_equal(a["points"], b["points"])
        assert a["prompts"] == b["prompts"]


def test_global_normalizer_is_bitwise_jax(tmp_path):
    clouds = [s["points"] for s in tdata.make_synthetic_clouds(5, 64, 0)]
    jn, tn = jdata.GlobalNormalizer().fit(clouds), tdata.GlobalNormalizer().fit(clouds)
    np.testing.assert_array_equal(tn.mean, jn.mean)
    np.testing.assert_array_equal(tn.std, jn.std)
    x = np.random.default_rng(0).standard_normal((2, 64, 3)).astype(np.float32) * 40
    np.testing.assert_array_equal(tn.normalize(x), jn.normalize(x))
    np.testing.assert_array_equal(tn.denormalize(x), jn.denormalize(x))
    tn.save(str(tmp_path / "stats.json"))
    back = jdata.GlobalNormalizer.load(str(tmp_path / "stats.json"))
    np.testing.assert_array_equal(back.mean, jn.mean)
    assert tdata.GlobalNormalizer.load(str(tmp_path / "stats.json")).clip == 5.0


def _npy_tree(root, subdirs, n_files=3, n_points=300):
    rng = np.random.default_rng(0)
    for sub in subdirs:
        for split in ("train", "test"):
            d = root / sub / split
            d.mkdir(parents=True)
            for i in range(n_files):
                np.save(d / f"m{i}.npy", rng.standard_normal((n_points, 3)).astype(np.float32))


@pytest.mark.parametrize("kind", ["shapenet", "modelnet40", "modelnet10"])
def test_npy_readers_are_bitwise_jax(tmp_path, kind):
    if kind == "shapenet":
        _npy_tree(tmp_path, ["03001627", "04379243"])
        mk = {"j": lambda **kw: jdata.ShapeNet15kPointClouds(str(tmp_path), ["chair", "table"], **kw),
              "t": lambda **kw: tdata.ShapeNet15kPointClouds(str(tmp_path), ["chair", "table"], **kw)}
    else:
        _npy_tree(tmp_path, ["bed", "chair", "desk"])
        cls = "ModelNet40PointClouds" if kind == "modelnet40" else "ModelNet10PointClouds"
        mk = {"j": lambda **kw: getattr(jdata, cls)(str(tmp_path), **kw),
              "t": lambda **kw: getattr(tdata, cls)(str(tmp_path), **kw)}
    norm = tdata.GlobalNormalizer(np.array([0.1, 0.2, -0.1]), np.array([1.1, 0.9, 1.3]))
    for split, kw in (("train", dict(tr_sample_size=200)),
                      ("test", dict(tr_sample_size=200, te_sample_size=80, normalizer=norm)),
                      ("train", dict(tr_sample_size=150, normalize_per_shape=True, max_shapes=4))):
        ds = {side: mk[side](split=split, **kw) for side in "jt"}
        assert len(ds["t"]) == len(ds["j"]) > 0
        for i in range(len(ds["j"])):
            np.random.seed(i)  # the train split's resampling draws from numpy's global state
            a = ds["j"][i]
            np.random.seed(i)
            b = ds["t"][i]
            np.testing.assert_array_equal(b["points"], a["points"])
            assert (b["prompt"], b["synset"]) == (a["prompt"], a["synset"])
        np.random.seed(3)
        ja = next(jdata.make_batches(ds["j"], 2, 64, seed=1))
        np.random.seed(3)
        ta = next(tdata.make_batches(ds["t"], 2, 64, seed=1))
        np.testing.assert_array_equal(ta["points"], ja["points"])
        assert ta["prompts"] == ja["prompts"]

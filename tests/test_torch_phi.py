"""The port's Phi prompt encoder (models/text_encoders/phi.py) vs the JAX
package's on the CPU: the same JAX-initialised weights (through
models/convert.convert_params) and token ids; f32, max |diff| <= 1e-5 x
max |JAX|. Padded prompts, including an all-padding one (an empty prompt
tokenizes to an all-zero mask: every row of its attention is fully masked,
and both plain cores give zeros there). The HF loader against the JAX
loader (bitwise state dicts) and against HF's own PhiModel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nova_pointcloud_tpu.models.text_encoders import phi as jphi
from nova_pointcloud_tpu_torch.models.convert import convert_params
from nova_pointcloud_tpu_torch.models.text_encoders import phi as tphi

SIZES = dict(vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
             num_attention_heads=4, max_position_embeddings=64)
REL_TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _models(seed=0):
    """(jax model, params, port model) on the same weights; built once per
    seed (the tests do not modify them)."""
    jm = jphi.PhiEncoderModel(jphi.PhiConfig(**SIZES))
    ids = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), ids, jnp.ones((1, 8)))["params"]
    params = jax.tree.map(np.asarray, params)
    # every LayerNorm and bias non-trivial, so each counts
    rng = np.random.default_rng(seed + 1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, a: a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        if p[-1].key in ("bias", "scale") else a, params)
    tm = tphi.PhiEncoderModel(tphi.PhiConfig(**SIZES), device="cpu")
    tm.load_state_dict(convert_params(params), strict=True)
    return jm, params, tm


def _inputs(seed, b=4, l=12):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, SIZES["vocab_size"], (b, l))
    mask = np.ones((b, l), np.int64)
    mask[1, l // 2:] = 0  # half padded
    mask[2, :] = 0  # an empty prompt: every key masked
    mask[3, 3:] = 0
    return ids, mask


def _rel_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("masked", [False, True])
def test_encoder_matches_jax(masked):
    jm, params, tm = _models()
    ids, mask = _inputs(3)
    jmask = jnp.asarray(mask) if masked else None
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jmask))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask) if masked else None).numpy()
    assert got.shape == ref.shape == (4, 12, 64) and np.isfinite(got).all()
    assert _rel_err(got, ref) <= REL_TOL, _rel_err(got, ref)


def test_empty_prompt_rows_match_jax_and_are_the_attention_free_path(monkeypatch):
    """An all-padding row: no NaN, equal to JAX, and equal to the model run
    with every attention core giving zeros (the attention output then is
    the out-projection's bias)."""
    jm, params, tm = _models(seed=5)
    ids, mask = _inputs(6)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
        for block in tm.layers:
            bias = block.self_attn.dense.bias
            monkeypatch.setattr(block.self_attn, "forward",
                                lambda x, mask_bias, bias=bias: bias.expand(x.shape))
        alone = tm(torch.from_numpy(ids[2:3]), torch.from_numpy(mask[2:3])).numpy()
    assert np.isfinite(got[2]).all()
    assert _rel_err(got[2], ref[2]) <= REL_TOL
    np.testing.assert_allclose(got[2], alone[0], rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _hf_phi(seed=0):
    transformers = pytest.importorskip("transformers")
    cfg = transformers.PhiConfig(partial_rotary_factor=0.4, attention_dropout=0.0,
                                 embd_pdrop=0.0, resid_pdrop=0.0, **SIZES)
    torch.manual_seed(seed)
    hf = transformers.PhiModel(cfg).eval()
    with torch.no_grad():  # non-trivial LayerNorms
        for name, p in hf.named_parameters():
            if "layernorm" in name:
                p.add_(torch.randn(p.shape) * 0.1)
    return hf


@pytest.mark.parametrize("prefix", ["model.", ""])
def test_hf_loader_matches_the_jax_loader_and_hf(prefix):
    hf = _hf_phi()
    sd = {f"{prefix}{k}": v for k, v in hf.state_dict().items()}
    tm = tphi.PhiEncoderModel(tphi.PhiConfig(**SIZES), device="cpu")
    port_sd = tphi.load_torch_phi_weights(tm, sd)
    # the JAX loader takes the model.-prefixed names only
    jsd = {f"model.{k}": v for k, v in hf.state_dict().items()}
    want = convert_params(jax.tree.map(np.asarray, jphi.load_torch_phi_weights(
        jphi.PhiEncoderModel(jphi.PhiConfig(**SIZES)), jsd)))
    assert port_sd.keys() == want.keys()
    assert all(torch.equal(port_sd[k], want[k]) for k in want)
    tm.load_state_dict(port_sd, strict=True)
    ids = np.array([[5, 17, 42, 99, 3, 64, 1]], np.int64)
    with torch.no_grad():
        ref = hf(torch.from_numpy(ids)).last_hidden_state.numpy()
        got = tm(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4, rtol=1e-3)  # as the JAX package's HF test


def test_text_encoder_pads_and_counts():
    """PhiTextEncoder: the tokenizer's padded ids and mask through the
    model, lengths from the mask; host offload raises."""
    _, _, tm = _models()

    class Tok:  # the HF call signature: pad to max_length, numpy tensors
        def __call__(self, prompts, padding, truncation, max_length, return_tensors):
            assert (padding, truncation, return_tensors) == ("max_length", True, "np")
            ids = np.zeros((len(prompts), max_length), np.int64)
            mask = np.zeros_like(ids)
            for i, p in enumerate(prompts):
                toks = [ord(c) % SIZES["vocab_size"] for c in p][:max_length]
                ids[i, :len(toks)], mask[i, :len(toks)] = toks, 1
            return {"input_ids": ids, "attention_mask": mask}

    enc = tphi.PhiTextEncoder(tm, Tok(), num_tokens=6)
    embeds, lengths = enc.encode(["a cat", "", "a long prompt"])
    assert embeds.shape == (3, 6, 64) and embeds.dtype == np.float32
    assert lengths.tolist() == [5, 0, 6] and np.isfinite(embeds).all()
    t = Tok()(["a cat", "", "a long prompt"], "max_length", True, 6, "np")
    with torch.no_grad():
        want = tm(torch.from_numpy(t["input_ids"]), torch.from_numpy(t["attention_mask"]))
    np.testing.assert_array_equal(embeds, want.numpy())
    assert enc.host_offload is False
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc.host_offload = True

"""The CogVideoX and LTX VAEs of the port vs the JAX package on the CPU:
encode moments and decode in f32 and in bf16 (the tiling running two
windows each way), and their torch-checkpoint loaders, with
tests/test_torch_vae.py's weights, helpers and tolerances."""

import pytest

from tests.test_torch_vae import check_bf16, check_encode_decode, check_loader

NAMES = ["cogvideox", "ltx"]


@pytest.mark.parametrize("name", NAMES)
def test_vae_encode_and_decode_match_jax(name):
    check_encode_decode(name)


@pytest.mark.parametrize("name", NAMES)
def test_vae_bf16_matches_jax(name):
    check_bf16(name)


@pytest.mark.parametrize("name", NAMES)
def test_torch_loaders_match_jax(name):
    check_loader(name)

"""The port's CLIP towers, tokenizer and conditioning
(contexture_nerf_tpu_torch.diffusion.clip, zero123plus) against the JAX
reference at tiny size, f32, on the CPU. Weights are the flax init moved
off its values (norm scales off 1, biases off 0) and carried across by
weights.py; inputs come from a numpy seed. XLA and torch sum the matmuls in
other orders: the towers agree to ~1e-5 of their outputs' scale.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.diffusion import clip as jclip
from contexture_nerf_tpu.diffusion.zero123plus import Zero123PlusPipeline
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.diffusion import clip as tclip
from contexture_nerf_tpu_torch.diffusion.zero123plus import (
    Zero123PlusTeacher, default_ramping_coefficients)

RNG = np.random.default_rng(0)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(int(np.prod(x.shape[:-1])))
    return jax.tree.map(move, tree)


def _bridge(jmod, tmod, x, seed):
    params = _perturbed(jmod.init(jax.random.PRNGKey(seed), x), seed)
    tmod.load_state_dict(weights.convert_tree(params))
    return params


def test_text_tower_matches_flax():
    cfg = tclip.CLIPTextConfig.tiny()
    ids = RNG.integers(0, cfg.vocab_size, (2, 77)).astype(np.int32)
    jm = jclip.CLIPTextModel(jclip.CLIPTextConfig.tiny())
    tm = tclip.CLIPTextModel(cfg)
    params = _bridge(jm, tm, jnp.asarray(ids), 1)
    ref = np.asarray(jm.apply(params, jnp.asarray(ids)))
    got = tm(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=2e-5)
    # causal: a later token does not move an earlier one's state
    ids2 = ids.copy()
    ids2[:, 40:] = (ids2[:, 40:] + 1) % cfg.vocab_size
    got2 = tm(torch.from_numpy(ids2).long()).detach()
    assert torch.equal(got2[:, :40], got.detach()[:, :40])
    assert not torch.allclose(got2[:, 40:], got.detach()[:, 40:])


def test_vision_tower_matches_flax():
    cfg = tclip.CLIPVisionConfig.tiny()
    px = RNG.standard_normal((2, 3, 32, 32)).astype(np.float32)
    jm = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig.tiny())
    tm = tclip.CLIPVisionModelWithProjection(cfg)
    params = _bridge(jm, tm, jnp.asarray(px), 2)
    ref = np.asarray(jm.apply(params, jnp.asarray(px)))
    got = tm(torch.from_numpy(px)).detach().numpy()
    assert got.shape == (2, cfg.projection_dim)
    np.testing.assert_allclose(got, ref, atol=2e-5)


@pytest.mark.parametrize("tower", ["text", "vision"])
def test_full_width_towers_have_the_reference_parameters(tower):
    """sd2 text (23 x 1024) and ViT-H/14 vision (32 x 1280) towers: the same
    parameter names and shapes as the flax modules, counted abstractly."""
    if tower == "text":
        jm = jclip.CLIPTextModel(jclip.CLIPTextConfig.sd2())
        x = jnp.zeros((1, 77), jnp.int32)
        with torch.device("meta"):
            tm = tclip.CLIPTextModel(tclip.CLIPTextConfig.sd2())
    else:
        jm = jclip.CLIPVisionModelWithProjection(jclip.CLIPVisionConfig.vit_h())
        x = jnp.zeros((1, 3, 224, 224))
        with torch.device("meta"):
            tm = tclip.CLIPVisionModelWithProjection(
                tclip.CLIPVisionConfig.vit_h())
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    fake = jax.tree.map(lambda s: np.zeros((1,) * len(s.shape), np.float32),
                        shapes)
    names = set(weights.convert_tree(fake))
    assert names == set(tm.state_dict())
    n_ref = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert n_ref == sum(p.numel() for p in tm.parameters())
    assert n_ref > (300e6 if tower == "text" else 600e6)


def test_hash_tokenizer_matches_reference():
    j = jclip.CLIPTokenizer(vocab_size=1000)
    t = tclip.CLIPTokenizer(vocab_size=1000)
    for prompt in ["", "A red brick house, front view!", "x " * 100]:
        assert np.array_equal(t([prompt]), j([prompt])), prompt
    empty = t([""])[0]
    assert empty[0] == 998 and (empty[1:] == 999).all()  # [bos, eos, eos...]


def test_bpe_tokenizer_from_local_files_matches_reference(tmp_path):
    vocab = {"<|endoftext|>": 7, "a</w>": 1, "b": 2, "c</w>": 3, "bc</w>": 4,
             "ab": 5, "abc</w>": 6, ",</w>": 8}
    (tmp_path / "vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "merges.txt").write_text("#version: 0.2\nb c</w>\n"
                                         "a bc</w>\na b\n")
    paths = dict(vocab_path=str(tmp_path / "vocab.json"),
                 merges_path=str(tmp_path / "merges.txt"), vocab_size=100)
    j, t = jclip.CLIPTokenizer(**paths), tclip.CLIPTokenizer(**paths)
    for prompt in ["abc", "a, bc zz", "ABC abc"]:
        assert np.array_equal(t([prompt]), j([prompt])), prompt
    assert list(t(["abc a"])[0][:4]) == [98, 6, 1, 99]


def test_clip_conditioning_matches_reference():
    """The empty-prompt text embedding plus the ramped image embedding of a
    condition image, with the CLIP pixel normalization (tiny towers: the
    32 px condition image is already the vision tower's size). The CLIP
    towers are moved off their init; the VAE keeps it: its negative latent
    encodes an all-zero image, which a VAE with nonzero biases turns into
    spatially constant activations that the tiny width's one-channel groups
    normalize to rounding noise (the two frameworks then differ by 5e-3);
    at init the zero image stays exactly zero on both sides."""
    pipe = Zero123PlusPipeline(tiny=True)
    params = {k: _perturbed(v, i) if k in ("text", "vision") else
              jax.tree.map(np.asarray, v)
              for i, (k, v) in enumerate(pipe.params.items())}
    pipe.params = jax.tree.map(jnp.asarray, params)
    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    weights.load_teacher(teacher, params)
    np.testing.assert_array_equal(teacher.ramping.numpy(),
                                  default_ramping_coefficients(77))
    img = RNG.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    j_eps = [np.asarray(jax.random.normal(k, (1, 4, 16, 16)))
             for k in (k1, k2)]
    ref_lat, ref_ehs = pipe.prepare_conditioning(jnp.asarray(img), key)
    lat, ehs = teacher.prepare_conditioning(
        torch.from_numpy(img), *(torch.from_numpy(e) for e in j_eps))
    np.testing.assert_allclose(ehs.numpy(), np.asarray(ref_ehs), atol=2e-5)
    np.testing.assert_allclose(lat.numpy(), np.asarray(ref_lat), atol=1e-4)
    # the ramp: token 0 carries no image embedding, the last all of it
    assert torch.equal(ehs[1, 0], ehs[0, 0])
    assert not torch.allclose(ehs[1, -1], ehs[0, -1])


def test_clip_pixel_resize_antialiases():
    """At full width the 320 px condition image shrinks to 224 px for the
    vision tower; jax.image.resize antialiases when it shrinks."""
    from contexture_nerf_tpu_torch.ops.image import resize_linear

    x = RNG.random((1, 3, 320, 320)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (1, 3, 224, 224), method="linear")
    got = resize_linear(torch.from_numpy(x), (224, 224))
    # the triangle filter's weights summed in other orders
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)

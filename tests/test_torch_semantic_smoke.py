"""The port's semantic smoke (contexture_nerf_tpu_torch/tools/semantic_smoke.py)
against tools/semantic_smoke.py, on the CPU.

FaithfulCodec: the same moments as the reference's on the same image
(exact, 1e-7 for the pooled means), and on a solid-colour image the encode
then decode gives the image back (1e-6). The smoke itself: a few
iterations on both sides from the reference's texture MLP (through the
weight bridge) with the reference step's draws (re-derived from its keys;
its fused embedding path runs the Pallas kernel in interpret mode), the
first and last grid colours within 2e-4 (two roundings to 4 decimals apart,
plus float noise) and the same files written.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contexture_nerf_tpu.training.trainer as jax_trainer
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.tools import semantic_smoke as port_smoke
from tools import semantic_smoke as ref_smoke

ITERS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_faithful_codec_matches_the_reference_and_inverts_solid_colours():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 3, 16, 24)).astype(np.float32)
    jm, jl = ref_smoke.FaithfulCodec(4).encode_moments(jnp.asarray(x))
    moments = port_smoke.FaithfulCodec(4)(torch.from_numpy(x))
    mean, logvar = moments.chunk(2, dim=1)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jm), atol=1e-7)
    np.testing.assert_array_equal(logvar.numpy(), np.asarray(jl))
    solid = torch.tensor([0.3, -0.6, 0.9]).reshape(1, 3, 1, 1).expand(
        1, 3, 16, 24).contiguous()
    codec = port_smoke.FaithfulCodec(4)
    back = codec.decode(codec(solid)[:, :4])
    np.testing.assert_allclose(back.numpy(), solid.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        back.numpy(), np.asarray(ref_smoke.FaithfulCodec(4).decode(
            jnp.asarray(codec(solid)[:, :4].numpy()))), atol=1e-6)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference tool's run of ITERS steps, its ConTEXTure kept (for
    the MLP's initial weights) and its per-step keys."""
    out = tmp_path_factory.mktemp("ref_smoke")
    made = []

    class Keep(jax_trainer.ConTEXTure):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax_trainer, "_FUSED_EMB_INTERPRET", True)
    mp.setattr(jax_trainer, "ConTEXTure", Keep)
    try:
        res = ref_smoke.run(out, ITERS)
    finally:
        mp.undo()
    return res, made[0], out


def _draws(setup_probs, cl_shape, z_shape):
    """step i's draws, as the reference's loop splits its key and its
    sds_step and _cfg_core take them from the sub-key."""
    key, subs = jax.random.PRNGKey(0), []
    for _ in range(ITERS):
        key, sub = jax.random.split(key)
        subs.append(sub)

    def draws(i):
        k_enc, k_noise, k_teach, k_tile = jax.random.split(subs[i], 4)
        k_neg, k_cond = jax.random.split(k_teach)
        return {
            "tile_idx": int(jax.random.choice(k_tile, 6, p=setup_probs)),
            "eps": np.asarray(jax.random.normal(k_enc, z_shape,
                                                jnp.float32)),
            "noise": np.asarray(jax.random.normal(k_noise, z_shape)),
            "neg_noise": np.asarray(jax.random.normal(k_neg, cl_shape)),
            "cond_noise": np.asarray(jax.random.normal(k_cond, cl_shape)),
        }
    return draws


def test_smoke_iterations_match_the_reference(reference, tmp_path):
    res_ref, tr, _ = reference
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, tr.texture_params)))
    setup = tr.prepare_sds(skip_bootstrap=True)
    probs = jnp.asarray(setup["tile_probs"])
    cl = setup["cond_lat_pair"]
    down = tr.zero123plus.vae_config
    h = setup["mask_grid"].shape[2] // 2 ** (len(down.block_out_channels) - 1)
    w = setup["mask_grid"].shape[3] // 2 ** (len(down.block_out_channels) - 1)
    draws = _draws(probs, cl.shape[1:], (1, 4, h, w))
    res = port_smoke.run(tmp_path, ITERS, device="cpu", mlp=mlp,
                         draws=draws)
    assert res["iters"] == res_ref["iters"] == ITERS
    assert res["target"] == res_ref["target"]
    for key in ("color_before", "color_after"):
        np.testing.assert_allclose(res[key], res_ref[key], atol=2e-4,
                                   err_msg=key)
    for key in ("err_before", "err_after"):
        assert abs(res[key] - res_ref[key]) <= 2e-4, key
    names = {"before.png", "after.png", "albedo_before.png",
             "albedo_after.png", "result.json"}
    assert names <= {p.name for p in tmp_path.iterdir()}
    assert json.loads((tmp_path / "result.json").read_text()) == res

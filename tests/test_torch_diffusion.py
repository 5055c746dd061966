"""The port's diffusion stack against the JAX reference at tiny size, f32,
on the CPU, with the reference's weights carried across by the port's bridge
(contexture_nerf_tpu_torch/weights.py): each layers.py block, the UNet
(write pass with ref_out, read pass with ref_kv_list and ControlNet
residuals), the ControlNet (zero-initialized heads randomized on both
sides), the VAE encoder, the Zero123++ teacher's CFG paths, and the grid,
scheduler and config pieces. Layouts: flax blocks take NHWC, the port NCHW.

Tolerances: f32 throughout; XLA and torch sum convolutions and matmuls in
other orders, so single blocks agree to ~1e-5 and whole towers to ~1e-4 of
their output's scale.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core import config as jax_config
from contexture_nerf_tpu.diffusion import layers as JL
from contexture_nerf_tpu.diffusion import schedulers as jsch
from contexture_nerf_tpu.diffusion.controlnet import ControlNet as JControlNet
from contexture_nerf_tpu.diffusion.controlnet import embed_cond as j_embed
from contexture_nerf_tpu.diffusion.unet import UNet2DCondition as JUNet
from contexture_nerf_tpu.diffusion.unet import UNetConfig as JUNetConfig
from contexture_nerf_tpu.diffusion.vae import AutoencoderKL
from contexture_nerf_tpu.diffusion.vae import VAEConfig as JVAEConfig
from contexture_nerf_tpu.diffusion.zero123plus import Zero123PlusPipeline
from contexture_nerf_tpu.ops.grid import merge_6_to_grid as j_merge
from contexture_nerf_tpu.ops.grid import split_grid_to_6 as j_split
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core import config as torch_config
from contexture_nerf_tpu_torch.diffusion import layers as TL
from contexture_nerf_tpu_torch.diffusion import schedulers as tsch
from contexture_nerf_tpu_torch.diffusion.controlnet import ControlNet
from contexture_nerf_tpu_torch.diffusion.controlnet import embed_cond
from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                      UNetConfig)
from contexture_nerf_tpu_torch.diffusion.vae import (Encoder, VAEConfig,
                                                     encode_moments,
                                                     sample_gaussian)
from contexture_nerf_tpu_torch.diffusion.zero123plus import (
    Zero123PlusTeacher, resize_linear, scale_image, scale_latents,
    unscale_image, unscale_latents)
from contexture_nerf_tpu_torch.ops.grid import merge_6_to_grid, split_grid_to_6


def _perturbed(tree, seed=0):
    """Every leaf moved off its init (norm scales off 1, biases and the
    zero-initialized heads off 0), as numpy f32."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(fan_in)
    return jax.tree.map(move, tree)


def _bridge(jax_module, port_module, *init_args, seed=0, **init_kw):
    params = jax_module.init(jax.random.PRNGKey(seed), *init_args, **init_kw)
    params = _perturbed(params, seed)
    port_module.load_state_dict(weights.convert_tree(params))
    return params


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got, ref, tol=1e-5):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(1.0, float(np.abs(ref).max())))


RNG = np.random.default_rng(0)


def _r(*shape):
    return RNG.standard_normal(shape).astype(np.float32)


# -- config ----------------------------------------------------------------------

@pytest.mark.parametrize("cls", ["RenderConfig", "GuideConfig", "OptimConfig",
                                 "LogConfig", "TrainConfig"])
def test_config_fields_and_defaults_equal_the_reference(cls):
    def spec(c):
        out = []
        for f in dataclasses.fields(c):
            d = f.default if f.default is not dataclasses.MISSING else \
                f.default_factory()
            out.append((f.name, repr(d) if dataclasses.is_dataclass(d)
                        else d))
        return out

    a, b = getattr(torch_config, cls), getattr(jax_config, cls)
    assert [n for n, _ in spec(a)] == [n for n, _ in spec(b)]
    if cls != "TrainConfig":
        assert spec(a) == spec(b)


# -- layers.py blocks ------------------------------------------------------------

def test_timestep_embedding():
    t = np.array([0, 17, 500, 999], np.float32)
    _close(TL.timestep_embedding(torch.from_numpy(t), 64),
           JL.timestep_embedding(jnp.asarray(t), 64), 1e-5)
    x = _r(2, 32)
    port = TL.TimestepEmbedding(32, 64)
    p = _bridge(JL.TimestepEmbedding(64), port, jnp.asarray(x))
    _close(port(torch.from_numpy(x)),
           JL.TimestepEmbedding(64).apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("cin,cout,temb", [(32, 64, True), (32, 32, False)])
def test_resnet_block(cin, cout, temb):
    x, t = _r(2, 8, 8, cin), _r(2, 128)
    jm = JL.ResnetBlock2D(cout, eps=1e-6, use_temb=temb)
    port = TL.ResnetBlock2D(cin, cout, eps=1e-6,
                            temb_dim=128 if temb else None)
    args = (jnp.asarray(x), jnp.asarray(t) if temb else None)
    p = _bridge(jm, port, *args)
    _close(port(_nchw(x), torch.from_numpy(t) if temb else None),
           jm.apply(p, *args).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("kind", ["unet", "vae", "up"])
def test_resample_blocks(kind):
    x = _r(2, 8, 8, 32)
    if kind == "up":
        jm, port = JL.Upsample2D(32), TL.Upsample2D(32)
    else:
        jm = JL.Downsample2D(32, asymmetric=kind == "vae")
        port = TL.Downsample2D(32, asymmetric=kind == "vae")
    p = _bridge(jm, port, jnp.asarray(x))
    _close(port(_nchw(x)), jm.apply(p, jnp.asarray(x)).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("mode", ["self", "cross", "ref"])
def test_cross_attention(mode):
    x, ctx, ref = _r(2, 20, 32), _r(2, 7, 24), _r(2, 9, 32)
    jm = JL.CrossAttention(2, 16)
    port = TL.CrossAttention(32, 24 if mode == "cross" else 32, 2, 16)
    jkw = {"context": jnp.asarray(ctx)} if mode == "cross" else \
        {"ref_kv": jnp.asarray(ref)} if mode == "ref" else {}
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in jkw.items()}
    p = _bridge(jm, port, jnp.asarray(x), **jkw)
    _close(port(torch.from_numpy(x), **tkw),
           jm.apply(p, jnp.asarray(x), **jkw))


def test_feedforward_geglu():
    x = _r(2, 5, 32)
    jm, port = JL.FeedForward(32), TL.FeedForward(32)
    p = _bridge(jm, port, jnp.asarray(x))
    _close(port(torch.from_numpy(x)), jm.apply(p, jnp.asarray(x)))


def test_basic_transformer_block_ref_out_and_ref_kv():
    x, ctx, ref = _r(2, 20, 32), _r(2, 7, 24), _r(2, 9, 32)
    jm = JL.BasicTransformerBlock(2, 16)
    port = TL.BasicTransformerBlock(32, 2, 16, 24)
    p = _bridge(jm, port, jnp.asarray(x), jnp.asarray(ctx))
    j_out, t_out = [], []
    jy = jm.apply(p, jnp.asarray(x), jnp.asarray(ctx), jnp.asarray(ref),
                  j_out)
    ty = port(torch.from_numpy(x), torch.from_numpy(ctx),
              torch.from_numpy(ref), t_out)
    _close(ty, jy)
    assert len(j_out) == len(t_out) == 1
    _close(t_out[0], j_out[0])


def test_transformer2d_pop_and_append_order():
    x, ctx = _r(2, 4, 4, 32), _r(2, 7, 24)
    refs = [_r(2, 9, 32), _r(2, 5, 32)]
    jm = JL.Transformer2DModel(2, 16, depth=2)
    port = TL.Transformer2DModel(32, 2, 16, 24, depth=2)
    p = _bridge(jm, port, jnp.asarray(x), jnp.asarray(ctx))
    j_kv, t_kv = [jnp.asarray(r) for r in refs], \
        [torch.from_numpy(r) for r in refs]
    j_out, t_out = [], []
    jy = jm.apply(p, jnp.asarray(x), jnp.asarray(ctx), j_kv, j_out)
    ty = port(_nchw(x), torch.from_numpy(ctx), t_kv, t_out)
    _close(ty, jy.transpose(0, 3, 1, 2))
    assert j_kv == [] and t_kv == [] and len(j_out) == len(t_out) == 2
    for a, b in zip(t_out, j_out):
        _close(a, b)


# -- towers ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_pair():
    jm = JUNet(JUNetConfig.tiny())
    port = UNet2DCondition(UNetConfig.tiny())
    p = _bridge(jm, port, jnp.zeros((2, 4, 16, 16)), jnp.array([0]),
                jnp.zeros((2, 7, 32)), seed=1)
    return jm, port, p


def test_unet_write_then_read_pass(unet_pair):
    jm, port, p = unet_pair
    x, ctx, t = _r(2, 4, 16, 16), _r(2, 7, 32), np.array([500])
    j_ref, t_ref = [], []
    jy = jm.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                  ref_out=j_ref)
    ty = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
              ref_out=t_ref)
    _close(ty, jy, 1e-4)
    assert len(j_ref) == len(t_ref) == 4  # 3 at level 0, 1 in the mid block
    for a, b in zip(t_ref, j_ref):
        _close(a, b, 1e-4)
    # read pass: reference tokens as a second KV source + ControlNet-style
    # residuals (NCHW on both sides)
    res_shapes = [(2, 32, 16, 16), (2, 32, 16, 16), (2, 32, 8, 8),
                  (2, 64, 8, 8)]
    downs = [_r(*s) for s in res_shapes]
    mid = _r(2, 64, 8, 8)
    jy = jm.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                  down_residuals=[jnp.asarray(d) for d in downs],
                  mid_residual=jnp.asarray(mid), ref_kv_list=list(j_ref))
    ty = port(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx),
              down_residuals=[torch.from_numpy(d) for d in downs],
              mid_residual=torch.from_numpy(mid), ref_kv_list=list(t_ref))
    _close(ty, jy, 1e-4)


def test_controlnet_with_randomized_heads():
    cfg_j, cfg_t = JUNetConfig.tiny(), UNetConfig.tiny()
    jm, port = JControlNet(cfg_j), ControlNet(cfg_t)
    x, ctx, t = _r(2, 4, 16, 16), _r(2, 7, 32), np.array([500])
    cond = RNG.random((2, 3, 128, 128)).astype(np.float32)
    p = _bridge(jm, port, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                jnp.asarray(cond), seed=2)
    assert float(np.abs(p["params"]["controlnet_mid_block"]["kernel"]).max()
                 ) > 0
    jd, jmid = jm.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                        jnp.asarray(cond), 2.0)
    td, tmid = port(torch.from_numpy(x), torch.from_numpy(t),
                    torch.from_numpy(ctx), torch.from_numpy(cond), 2.0)
    assert len(jd) == len(td)
    for a, b in zip(td, jd):
        _close(a, np.asarray(b).transpose(0, 3, 1, 2), 1e-4)
    _close(tmid, np.asarray(jmid).transpose(0, 3, 1, 2), 1e-4)
    # the hoisted hint embedding
    je = j_embed(p, cfg_j, jnp.asarray(cond))
    te = embed_cond(port, torch.from_numpy(cond))
    _close(te, np.asarray(je).transpose(0, 3, 1, 2), 1e-4)


def test_vae_encode_moments():
    vae = AutoencoderKL(JVAEConfig.tiny())
    img = RNG.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32)
    p = _perturbed(vae.init(jax.random.PRNGKey(3), jnp.asarray(img),
                            jax.random.PRNGKey(4)), 3)
    enc = Encoder(VAEConfig.tiny())
    enc.load_state_dict(weights.vae_encoder_state_dict(p))
    jmean, jlogvar = vae.apply(p, jnp.asarray(img),
                               method=vae.encode_moments)
    mean, logvar = encode_moments(enc, torch.from_numpy(img))
    _close(mean, jmean, 1e-4)
    _close(logvar, jlogvar, 1e-4)
    eps = _r(*mean.shape)
    _close(sample_gaussian(mean, logvar, torch.from_numpy(eps)),
           np.asarray(jmean) + np.exp(0.5 * np.asarray(jlogvar)) * eps, 1e-4)


@pytest.fixture(scope="module")
def teacher_pair():
    pipe = Zero123PlusPipeline(tiny=True)
    params = {k: _perturbed(pipe.params[k], i)
              for i, k in enumerate(("unet", "controlnet", "vae"))}
    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    weights.load_teacher(teacher, params)
    return pipe, {k: jax.tree.map(jnp.asarray, v)
                  for k, v in params.items()}, teacher


@pytest.mark.parametrize("individual", [False, True])
@pytest.mark.parametrize("hoisted", [False, True])
def test_teacher_cfg_v_pred(teacher_pair, individual, hoisted):
    pipe, params, teacher = teacher_pair
    lat, t = _r(1, 4, 16, 16), np.array([500])
    cl, ehs = _r(2, 4, 8, 8), _r(2, 77, 32)
    depth = RNG.random((1, 3, 48, 32)).astype(np.float32)  # upsampled 8x lat
    key = jax.random.PRNGKey(5)
    k_neg, k_cond = jax.random.split(key)
    neg = np.asarray(jax.random.normal(k_neg, cl.shape[1:]))
    cnd = np.asarray(jax.random.normal(k_cond, cl.shape[1:]))
    j_emb = t_emb = None
    if hoisted:
        j_emb = pipe.embed_control_cond(params, jnp.asarray(depth), (16, 16))
        t_emb = teacher.embed_control_cond(torch.from_numpy(depth), (16, 16))
        _close(t_emb, np.asarray(j_emb).transpose(0, 3, 1, 2), 1e-4)
    ja = (params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(cl),
          jnp.asarray(ehs), jnp.asarray(depth))
    ta = (torch.from_numpy(lat), torch.from_numpy(t), torch.from_numpy(cl),
          torch.from_numpy(ehs), torch.from_numpy(depth))
    noise = (torch.from_numpy(neg), torch.from_numpy(cnd))
    if individual:
        jv = pipe._cfg_v_pred_individual(*ja, 7.0, 3.0, key,
                                         scale_input=lambda x: x,
                                         cn_cond_emb=j_emb)
        tv = teacher._cfg_v_pred_individual(*ta, 7.0, 3.0, *noise,
                                            cn_cond_emb=t_emb)
    else:
        jv = pipe._cfg_v_pred(*ja, 10.0, key, scale_input=lambda x: x,
                              cn_cond_emb=j_emb)
        tv = teacher._cfg_v_pred(*ta, 10.0, *noise, cn_cond_emb=t_emb)
    _close(tv, jv, 1e-4)


# -- grid, schedulers, scalings ----------------------------------------------------

def test_grid_merge_and_split():
    tiles = _r(6, 3, 5, 5)
    g = merge_6_to_grid(torch.from_numpy(tiles))
    _close(g, j_merge(jnp.asarray(tiles)), 0)
    _close(split_grid_to_6(g, 5), j_split(jnp.asarray(g.numpy()), 5), 0)


def test_schedule_noise_and_velocity():
    acp = tsch.make_alphas_cumprod(device="cpu")
    jacp = jsch.make_alphas_cumprod()
    _close(acp, jacp, 1e-6)
    x, n, t = _r(2, 4, 6, 6), _r(2, 4, 6, 6), np.array([3, 741])
    for tf, jf in ((tsch.add_noise, jsch.add_noise),
                   (tsch.velocity_target, jsch.velocity_target)):
        _close(tf(acp, torch.from_numpy(x), torch.from_numpy(n),
                  torch.from_numpy(t)),
               jf(jacp, jnp.asarray(x), jnp.asarray(n), jnp.asarray(t)),
               1e-6)
    ts = tsch.dreamtime_schedule(acp, 5000).numpy()
    jts = np.asarray(jsch.dreamtime_schedule(jacp, 5000))
    # argmin over a float cumsum: ties at the rounding level may pick the
    # neighbouring t
    assert np.abs(ts - jts).max() <= 1 and (ts == jts).mean() > 0.99


def test_scalings_and_antialiased_resize():
    from contexture_nerf_tpu.diffusion import zero123plus as jz

    x = _r(1, 4, 8, 8)
    for tf, jf in ((scale_latents, jz.scale_latents),
                   (unscale_latents, jz.unscale_latents),
                   (scale_image, jz.scale_image),
                   (unscale_image, jz.unscale_image)):
        _close(tf(torch.from_numpy(x)), jf(jnp.asarray(x)), 1e-6)
    img = RNG.random((1, 3, 70, 50)).astype(np.float32)
    for hw in ((32, 32), (140, 100)):  # down (antialiased) and up
        _close(resize_linear(torch.from_numpy(img), hw),
               jax.image.resize(jnp.asarray(img), (1, 3) + hw, "linear"),
               1e-5)

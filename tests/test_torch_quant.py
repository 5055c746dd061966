"""The port's W8A8 path (contexture_nerf_tpu_torch/ops/quant.py, the
`quant` flags of diffusion/layers.py, the teacher's int8_controlnet /
int8_unet) against the JAX package's ops/quant.py and its quantized towers,
on the CPU, from numpy inputs made with a seed.

Tolerances:
  - the int8 values, the scales and the int32 sums are integers or
    products of the same f32 operations: equal bit for bit;
  - the primitives' outputs: equal, or within one ulp of their dtype;
  - gradients: those of the exact op, to f32 rounding (rtol 1e-5);
  - one quantized block, port against JAX through the weight bridge:
    the median element within 1e-6 of the output's scale, and relative
    Frobenius error within a third of the block's own quantization error
    (JAX int8 against JAX exact). XLA and torch sum the float parts
    (norms, attention, residuals) in other orders, which now and then moves
    an activation across a rounding boundary of its int8 grid; such a flip
    moves a row or a window of outputs by a step of the grid (over 30
    seeds: ratio at most 0.2, median at most 6e-8);
  - whole tiny towers and the SDS step: with random weights those flips
    beget flips downstream (over 6 seeds the UNet's ratio reached 0.63),
    so the port's int8 result is held to be nearer the JAX int8 result
    than that is to the exact one (relative Frobenius error, floored at
    1e-5), and the step's loss, gradient norm and Fisher term nearer the
    JAX int8 step's than the port's exact step is;
  - int8 against exact: the reference's own bounds, 0.15 for the
    ControlNet and 0.25 for the UNet (tests/test_quant.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import contexture_nerf_tpu.training.trainer as jax_trainer
from contexture_nerf_tpu.core.config import config_from_dict
from contexture_nerf_tpu.diffusion import layers as JL
from contexture_nerf_tpu.diffusion.controlnet import ControlNet as JControlNet
from contexture_nerf_tpu.diffusion.unet import UNet2DCondition as JUNet
from contexture_nerf_tpu.diffusion.unet import UNetConfig as JUNetConfig
from contexture_nerf_tpu.ops import quant as JQ
from contexture_nerf_tpu.training.trainer import ConTEXTure
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import \
    config_from_dict as torch_config_from_dict
from contexture_nerf_tpu_torch.diffusion import layers as TL
from contexture_nerf_tpu_torch.diffusion.controlnet import ControlNet
from contexture_nerf_tpu_torch.diffusion.layers import set_quant
from contexture_nerf_tpu_torch.diffusion.unet import (UNet2DCondition,
                                                      UNetConfig)
from contexture_nerf_tpu_torch.diffusion.zero123plus import \
    Zero123PlusTeacher
from contexture_nerf_tpu_torch.models.fields import NeRF2D
from contexture_nerf_tpu_torch.ops import quant as TQ
from contexture_nerf_tpu_torch.ops.groupnorm import GroupNormSiLU
from contexture_nerf_tpu_torch.training.trainer import SDSTrainer
from tools.make_shapes import uv_sphere, write_obj

RNG = np.random.default_rng(13)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _r(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _rel_err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)


def _np(t):
    return t.detach().float().numpy()


def _fro(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def _tower_close(port, jq, je):
    """Port int8 nearer JAX int8 than JAX int8 is to JAX exact (relative
    Frobenius error, floored at 1e-5)."""
    got, limit = _fro(port, jq), max(1e-5, _fro(jq, je))
    assert got < limit, (got, limit)


def _within_one_ulp(got, ref, dtype):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    if dtype == torch.bfloat16:  # 8 significand bits: 2^16 f32 ulps
        ulp = ulp * 65536.0
    assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


def _jdtype(dtype):
    return jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32


# -- the primitives -----------------------------------------------------------

@pytest.mark.parametrize("shape,dims", [
    ((3, 5, 40), (-1,)), ((2, 16, 9, 9), (0, 1, 2, 3)),
    ((24, 16, 3, 3), (1, 2, 3))])
def test_quantize_int8_equals_the_reference(shape, dims):
    x = _r(*shape, scale=3.0)
    x.reshape(-1)[::7] = 0.0  # ties and zeros too
    x.reshape(-1)[1::11] = 127.5 / 127.0
    qj, sj = JQ.quantize_int8(jnp.asarray(x), dims)
    qt, st = TQ.quantize_int8(torch.from_numpy(x), dims)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_rounds_half_to_even_and_floors_the_scale():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5]])
    q, s = TQ.quantize_int8(x, (-1,))
    assert float(s) == 1.0
    assert q.tolist() == [[127, 0, 2, 2, 0]]
    q, s = TQ.quantize_int8(torch.zeros(2, 3), (-1,))
    assert torch.all(q == 0) and torch.all(s == torch.tensor(1e-8) / 127.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_linear_equals_the_reference(dtype):
    x, w = _r(2, 19, 48), _r(48, 40, scale=0.1)  # flax kernel (K, N)
    xj = jnp.asarray(x).astype(_jdtype(dtype))
    wj = jnp.asarray(w).astype(_jdtype(dtype))
    xt = torch.from_numpy(x).to(dtype)
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).to(dtype)
    # the int32 sums
    ql, _ = JQ.quantize_int8(xj, -1)
    qr, _ = JQ.quantize_int8(wj, 0)
    acc_j = jax.lax.dot_general(ql, qr, (((2,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    acc_t = TQ.linear_int32(TQ.quantize_int8(xt, (-1,))[0],
                            TQ.quantize_int8(wt, (1,))[0])
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    yj = JQ.int8_dot_general(xj, wj, (((2,), (0,)), ((), ())))
    yt = TQ.int8_linear(xt, wt)
    assert yt.dtype == dtype
    _within_one_ulp(_np(yt), np.asarray(yj.astype(jnp.float32)), dtype)


CONVS = [(3, 1, 1), (3, 2, 1), (1, 1, 0)]  # (kernel, stride, padding)


@pytest.mark.parametrize("k,stride,pad", CONVS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_conv2d_equals_the_reference(k, stride, pad, dtype):
    x, w = _r(2, 10, 12, 16), _r(k, k, 16, 24, scale=0.1)  # NHWC, HWIO
    xj = jnp.asarray(x).astype(_jdtype(dtype))
    wj = jnp.asarray(w).astype(_jdtype(dtype))
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))
                          ).to(dtype)
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))
                          ).to(dtype)
    dn = ("NHWC", "HWIO", "NHWC")
    padding = [(pad, pad), (pad, pad)]
    ql, _ = JQ.quantize_int8(xj, (0, 1, 2, 3))
    qr, _ = JQ.quantize_int8(wj, (0, 1, 2))
    acc_j = jax.lax.conv_general_dilated(
        ql, qr, (stride, stride), padding, dimension_numbers=dn,
        preferred_element_type=jnp.int32)
    acc_t = TQ.conv2d_int32(TQ.quantize_int8(xt, (0, 1, 2, 3))[0],
                            TQ.quantize_int8(wt, (1, 2, 3))[0], stride, pad)
    assert acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy(),
                                  np.asarray(acc_j).transpose(0, 3, 1, 2))
    yj = JQ.int8_conv_general_dilated(xj, wj, (stride, stride), padding,
                                      dimension_numbers=dn)
    yt = TQ.int8_conv2d(xt, wt, stride, pad)
    assert yt.dtype == dtype
    assert yt.is_contiguous()  # K6, the next GroupNorm, takes NCHW only
    _within_one_ulp(_np(yt), np.asarray(yj.astype(jnp.float32)
                                        ).transpose(0, 3, 1, 2), dtype)


def test_conv_scale_spans_the_batch():
    """One activation scale over the whole batch: a sample's output
    depends on the other samples' amax (the CFG pair shares one)."""
    x, w = torch.from_numpy(_r(2, 8, 6, 6)), torch.from_numpy(_r(8, 8, 3, 3))
    x[1] *= 10.0
    both = TQ.int8_conv2d(x, w, 1, 1)
    alone = TQ.int8_conv2d(x[:1], w, 1, 1)
    assert not torch.equal(both[:1], alone)


def test_gradients_are_the_exact_ops():
    x = torch.from_numpy(_r(2, 5, 32)).requires_grad_(True)
    w = torch.from_numpy(_r(24, 32)).requires_grad_(True)
    g = torch.from_numpy(_r(2, 5, 24))
    gq = torch.autograd.grad(TQ.int8_linear(x, w), (x, w), g)
    ge = torch.autograd.grad(torch.nn.functional.linear(x, w), (x, w), g)
    for a, b in zip(gq, ge):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)
    # and the reference's custom VJP gives the same
    gj = jax.grad(lambda a, b: jnp.sum(
        JQ.int8_dot_general(a, b, (((2,), (0,)), ((), ()))) * g.numpy()),
        argnums=(0, 1))(jnp.asarray(x.detach().numpy()),
                        jnp.asarray(w.detach().numpy().T))
    np.testing.assert_allclose(gq[0].numpy(), np.asarray(gj[0]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gq[1].numpy(), np.asarray(gj[1]).T,
                               rtol=1e-5, atol=1e-5)
    for stride, pad in ((1, 1), (2, 1)):
        x = torch.from_numpy(_r(2, 8, 10, 10)).requires_grad_(True)
        w = torch.from_numpy(_r(16, 8, 3, 3)).requires_grad_(True)
        y = TQ.int8_conv2d(x, w, stride, pad)
        g = torch.from_numpy(_r(*y.shape))
        gq = torch.autograd.grad(y, (x, w), g)
        ge = torch.autograd.grad(torch.nn.functional.conv2d(
            x, w, stride=stride, padding=pad), (x, w), g)
        for a, b in zip(gq, ge):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_the_products_are_integer():
    """No float product hides behind the int8 path: the patches and the
    operands of _int_mm are int8."""
    seen = []
    real = torch._int_mm

    def spy(a, b):
        seen.append((a.dtype, b.dtype))
        return real(a, b)

    torch._int_mm = spy
    try:
        TQ.int8_linear(torch.randn(3, 16), torch.randn(8, 16))
        TQ.int8_conv2d(torch.randn(2, 8, 5, 5), torch.randn(8, 8, 3, 3), 2, 1)
    finally:
        torch._int_mm = real
    assert seen == [(torch.int8, torch.int8)] * 2


# -- the towers ------------------------------------------------------------------

def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x, np.float32)
        if x.ndim <= 1:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        fan_in = int(np.prod(x.shape[:-1]))
        return x + rng.standard_normal(x.shape).astype(np.float32) \
            / np.sqrt(fan_in)
    return jax.tree.map(move, tree)


@pytest.fixture(scope="module")
def controlnets():
    jm, jq = JControlNet(JUNetConfig.tiny()), \
        JControlNet(JUNetConfig.tiny(), quant=True)
    x, ctx, t = _r(2, 4, 16, 16), _r(2, 7, 32), np.array([500])
    cond = RNG.random((2, 3, 128, 128)).astype(np.float32)
    p = _perturbed(jm.init(jax.random.PRNGKey(2), jnp.asarray(x),
                           jnp.asarray(t), jnp.asarray(ctx),
                           jnp.asarray(cond)), 2)
    port = ControlNet(UNetConfig.tiny())
    port.load_state_dict(weights.convert_tree(p))
    set_quant(port, True)
    args = (x, t, ctx, cond)
    return jm, jq, port, p, args


def test_controlnet_int8_matches_the_reference(controlnets):
    jm, jq, port, p, (x, t, ctx, cond) = controlnets
    ja = [jnp.asarray(a) for a in (x, t, ctx, cond)]
    jd, jmid = jq.apply(p, *ja, 2.0)
    ed, emid = jm.apply(p, *ja, 2.0)
    with torch.no_grad():
        td, tmid = port(*(torch.from_numpy(a) for a in (x, t, ctx, cond)),
                        2.0)

    def nchw(a):
        return np.asarray(a).transpose(0, 3, 1, 2)

    for a, b, e in zip(td + [tmid], list(jd) + [jmid], list(ed) + [emid]):
        _tower_close(_np(a), nchw(b), nchw(e))
    # int8 against exact, the reference's bound
    assert _rel_err(_np(tmid), nchw(emid)) < 0.15
    errs = [_rel_err(_np(a), nchw(b)) for a, b in zip(td, ed)]
    assert float(np.mean(errs)) < 0.15, errs


def test_unet_int8_matches_the_reference():
    cfg_j = JUNetConfig.tiny()
    jm, jq = JUNet(cfg_j), JUNet(cfg_j, quant=True)
    x, ctx, t = _r(2, 4, 16, 16, scale=0.5), _r(2, 7, 32, scale=0.1), \
        np.array([500])
    p = _perturbed(jm.init(jax.random.PRNGKey(1), jnp.asarray(x),
                           jnp.asarray(t), jnp.asarray(ctx)), 1)
    port = UNet2DCondition(UNetConfig.tiny())
    port.load_state_dict(weights.convert_tree(p))
    set_quant(port, True)
    ja = [jnp.asarray(a) for a in (x, t, ctx)]
    ta = [torch.from_numpy(a) for a in (x, t, ctx)]
    # write pass, then the read pass over its tokens with residuals
    j_ref, t_ref = [], []
    jy = jq.apply(p, *ja, ref_out=j_ref)
    with torch.no_grad():
        ty = port(*ta, ref_out=t_ref)
    _tower_close(_np(ty), jy, jm.apply(p, *ja))
    downs = [_r(*s) for s in [(2, 32, 16, 16), (2, 32, 16, 16),
                              (2, 32, 8, 8), (2, 64, 8, 8)]]
    mid = _r(2, 64, 8, 8)
    res = dict(down_residuals=[jnp.asarray(d) for d in downs],
               mid_residual=jnp.asarray(mid), ref_kv_list=list(j_ref))
    jy = jq.apply(p, *ja, **res)
    je = jm.apply(p, *ja, **dict(res, ref_kv_list=list(j_ref)))
    with torch.no_grad():
        ty = port(*ta, down_residuals=[torch.from_numpy(d) for d in downs],
                  mid_residual=torch.from_numpy(mid),
                  ref_kv_list=list(t_ref))
    _tower_close(_np(ty), jy, je)
    # int8 against exact, the reference's bound
    assert _rel_err(_np(ty), je) < 0.25


BLOCKS = ["resnet", "resnet_shortcut", "transformer", "downsample",
          "upsample"]


@pytest.mark.parametrize("kind", BLOCKS)
def test_quantized_block_matches_the_reference(kind):
    """Each block kind the towers quantize, alone: the int8 layers it
    holds (and only those) run W8A8 on both sides."""
    x = _r(2, 8, 8, 32)  # NHWC
    extra = {}
    if kind.startswith("resnet"):
        cout = 64 if kind == "resnet_shortcut" else 32
        jb, je = JL.ResnetBlock2D(cout, quant=True), JL.ResnetBlock2D(cout)
        tb = TL.ResnetBlock2D(32, cout, temb_dim=16)
        args = (_r(2, 16),)
    elif kind == "transformer":
        jb = JL.Transformer2DModel(2, 16, quant=True)
        je = JL.Transformer2DModel(2, 16)
        tb = TL.Transformer2DModel(32, 2, 16, 24)
        args = (_r(2, 7, 24),)
        extra = {"ref_kv_list": _r(2, 64, 32)}
    elif kind == "downsample":
        jb, je = JL.Downsample2D(32, quant=True), JL.Downsample2D(32)
        tb, args = TL.Downsample2D(32), ()
    else:
        jb, je = JL.Upsample2D(32, quant=True), JL.Upsample2D(32)
        tb, args = TL.Upsample2D(32), ()
    ja = [jnp.asarray(x)] + [jnp.asarray(a) for a in args]
    p = _perturbed(jb.init(jax.random.PRNGKey(4), *ja), 4)
    tb.load_state_dict(weights.convert_tree(p))
    set_quant(tb, True)

    def jrun(m):  # the transformer pops its list: a new one each call
        kw = {k: [jnp.asarray(v)] for k, v in extra.items()}
        return np.asarray(m.apply(p, *ja, **kw)).transpose(0, 3, 1, 2)

    jy, jx = jrun(jb), jrun(je)
    with torch.no_grad():
        ty = _np(tb(torch.from_numpy(np.ascontiguousarray(
            x.transpose(0, 3, 1, 2))), *(torch.from_numpy(a) for a in args),
            **{k: [torch.from_numpy(v)] for k, v in extra.items()}))
    assert np.median(np.abs(ty - jy)) <= 1e-6 * np.abs(jy).max()
    assert _fro(ty, jy) <= _fro(jy, jx) / 3, (_fro(ty, jy), _fro(jy, jx))


@pytest.mark.parametrize("tower", ["unet", "controlnet"])
def test_quant_leaves_the_state_dicts_as_they_were(tower):
    """quant is a plain attribute: no key, shape or dtype of the tower's
    state_dict changes, and set_quant(.., False) clears every flag."""
    cls = UNet2DCondition if tower == "unet" else ControlNet
    a, b = cls(UNetConfig.tiny()), cls(UNetConfig.tiny())
    set_quant(b, True)
    assert any(getattr(m, "quant", False) for m in b.modules())
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    for k in sa:
        assert sa[k].shape == sb[k].shape and sa[k].dtype == sb[k].dtype
    set_quant(b, False)
    assert not any(getattr(m, "quant", False) for m in b.modules())


def test_int8_controlnet_with_zero_heads_leaves_the_v_prediction():
    """With the ControlNet's zero convs at zero its hints are exactly 0,
    quantized or not: the int8_controlnet v-prediction equals the exact
    teacher's (tests/test_quant.py's pipeline test); int8_teacher moves
    it."""
    gen = torch.Generator().manual_seed(0)
    teacher = Zero123PlusTeacher(tiny=True, device="cpu", generator=gen)
    with torch.no_grad():
        for name, m in teacher.controlnet.named_children():
            if name.startswith("controlnet_") and \
                    name != "controlnet_cond_embedding":
                m.weight.zero_()
                m.bias.zero_()
    lat = torch.from_numpy(_r(1, 4, 16, 16))
    clp = torch.from_numpy(_r(2, 4, 8, 8))
    ehs = torch.from_numpy(_r(2, 77, teacher.text_config.hidden_size))
    depth = torch.from_numpy(RNG.random((1, 3, 128, 128)).astype(np.float32))
    noises = torch.from_numpy(_r(4, 8, 8)), torch.from_numpy(_r(4, 8, 8))
    t = torch.tensor([500])
    v = teacher._cfg_v_pred(lat, t, clp, ehs, depth, 4.0, *noises)
    teacher.set_int8(int8_controlnet=True)
    assert teacher.controlnet.down_0_resnet_0.conv1.quant
    assert not teacher.unet.down_0_resnet_0.conv1.quant
    v8 = teacher._cfg_v_pred(lat, t, clp, ehs, depth, 4.0, *noises)
    assert torch.isfinite(v8).all()
    assert torch.equal(v8, v)
    teacher.set_int8(int8_unet=True)
    assert teacher.unet.down_0_resnet_0.conv1.quant
    assert teacher.controlnet.down_0_resnet_0.conv1.quant
    assert not torch.equal(teacher._cfg_v_pred(lat, t, clp, ehs, depth, 4.0,
                                               *noises), v)


# -- one SDS step with the W8A8 teacher ------------------------------------------------

T, KEY = 500, 5


def _cfg_dict(tmp):
    return {
        "log": {"exp_name": "q8", "exp_root": str(tmp / "exp"),
                "log_images": False, "save_mesh": False},
        "render": {"train_grid_size": 32, "eval_grid_size": 32},
        "guide": {"text": "q8", "shape_path": str(tmp / "s.obj"),
                  "texture_resolution": 16},
        "optim": {"seed": 0, "sds_iterations": 1, "int8_teacher": True,
                  "local_sds_grad": False,
                  "precompute_uv_embedding": False},
    }


def test_int8_teacher_sds_step_matches_the_reference(tmp_path, monkeypatch):
    """One step of the reference's _build_sds_step with optim.int8_teacher
    and the port's, on the reference's weights, setup and draws (the
    full-canvas, UV path, so no Pallas kernel is interpreted)."""
    write_obj(tmp_path / "s.obj", *uv_sphere(6, 8))
    monkeypatch.setattr(jax_trainer, "_FUSED_EMB_INTERPRET", True)
    tr = ConTEXTure(config_from_dict(_cfg_dict(tmp_path)), tiny_models=True,
                    backend="xla")
    assert tr.zero123plus.unet.quant and tr.zero123plus.controlnet.quant
    setup = tr.prepare_sds(skip_bootstrap=True)
    setup = dict(setup, emb_pts=None)
    step, optimizer, hot = tr._build_sds_step(setup, None)
    params = tr.texture_params
    _, _, loss_ref, gn_ref, fisher_ref, grid_ref = step(
        params, optimizer.init(params), jnp.asarray([T], jnp.int32),
        jax.random.PRNGKey(KEY), hot)

    teacher = Zero123PlusTeacher(tiny=True, device="cpu")
    weights.load_teacher(teacher,
                         jax.tree.map(np.asarray, tr.zero123plus.params))
    mlp = NeRF2D(device="cpu")
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, tr.texture_params)))
    keys = ("depth_grid", "mask_grid", "uv_grid_pts", "cond_lat_pair",
            "encoder_hidden_states", "tile_probs")
    port = SDSTrainer(torch_config_from_dict(_cfg_dict(tmp_path)),
                      {k: np.asarray(setup[k]) for k in keys},
                      teacher=teacher, mlp=mlp, tiny=True, device="cpu")
    assert teacher.int8_unet and teacher.unet.up_0_resnet_0.conv1.quant
    k_enc, k_noise, k_teach, k_tile = jax.random.split(
        jax.random.PRNGKey(KEY), 4)
    k_neg, k_cond = jax.random.split(k_teach)
    cl = hot["cond_lat_pair"]
    z_shape = port.latent_shape()
    draws = {
        "tile_idx": int(jax.random.choice(k_tile, 6, p=hot["tile_probs"])),
        "eps": np.asarray(jax.random.normal(k_enc, z_shape, jnp.float32)),
        "noise": np.asarray(jax.random.normal(k_noise, z_shape)),
        "neg_noise": np.asarray(jax.random.normal(k_neg, cl.shape[1:],
                                                  cl.dtype)),
        "cond_noise": np.asarray(jax.random.normal(k_cond, cl.shape[1:],
                                                   cl.dtype)),
    }
    # every GroupNorm input contiguous NCHW, as K6 takes it on the card
    layouts = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: layouts.append(args[0].is_contiguous()))
        for m in teacher.modules() if isinstance(m, GroupNormSiLU)]
    _, loss, gn, fisher, grid = port.step(T, draws)
    for h in hooks:
        h.remove()
    assert layouts and all(layouts), layouts.count(False)
    np.testing.assert_allclose(grid.numpy(), np.asarray(grid_ref), atol=1e-5)
    # the same step through the port's exact teacher
    mlp.load_state_dict(weights.convert_tree(
        jax.tree.map(np.asarray, tr.texture_params)))
    exact_cfg = torch_config_from_dict(_cfg_dict(tmp_path))
    exact_cfg.optim.int8_teacher = False
    exact = SDSTrainer(exact_cfg, {k: np.asarray(setup[k]) for k in keys},
                       teacher=teacher, mlp=mlp, tiny=True, device="cpu")
    assert not teacher.unet.up_0_resnet_0.conv1.quant
    _, loss_e, gn_e, fisher_e, _ = exact.step(T, draws)
    for got, ref, ex in ((loss, loss_ref, loss_e), (gn, gn_ref, gn_e),
                         (fisher, fisher_ref, fisher_e)):
        got, ref, ex = float(got), float(ref), float(ex)
        assert np.isfinite(got)
        assert abs(got - ref) < abs(ex - ref), (got, ref, ex)

"""A whole tiny run of the port against the reference's run: the SDS loop
of `ConTEXTure.paint_zero123plus` for 3 iterations in each package, the
teacher's towers read by both from the same tools/synth_snapshot.py
snapshot (guide.zero123plus_path with its controlnet/ subfolder).

The reference: `ConTEXTure` (tiny, XLA), `prepare_sds(skip_bootstrap=True)`,
then its loop as paint_zero123plus runs it: the DreamTime t schedule, one
jax.random split of the run's key per iteration, Adam's state carried. The
port: its own `ConTEXTure` from the same config (towers loaded from the
snapshot), the MLP's initial weights carried across with weights.py, its
own `prepare_sds` on the reference's condition draws, then its own
`SDSTrainer` and t schedule, each step fed the draws that the reference's
step takes from its key (as tests/test_torch_sds_step.py derives them).

Held: the loaded towers bit for bit; the t schedules exactly; each step's
loss within 1e-4 relative (f32 throughout; XLA and torch sum the
convolutions in other orders, test_torch_sds_step.py's tolerance); the
final parameters within 3 lr a step (Adam moves an element by about lr a
step whatever its gradient's size, so a summation-order flip of a
near-zero gradient's sign can move it by 2 lr; the updates' signs must
agree on 99% of each leaf).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contexture_nerf_tpu.core.config import config_from_dict
from contexture_nerf_tpu.diffusion import schedulers as jsch
from contexture_nerf_tpu.training.trainer import ConTEXTure as JConTEXTure
from contexture_nerf_tpu_torch import weights
from contexture_nerf_tpu_torch.core.config import \
    config_from_dict as torch_config_from_dict
from contexture_nerf_tpu_torch.training import trainer as tr
from tools import synth_snapshot as jsynth
from tools.make_shapes import uv_sphere, write_obj

ITERS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_dict(tmp, snap):
    return {"log": {"exp_name": "whole", "exp_root": str(tmp / "exp"),
                    "log_images": False, "save_mesh": False},
            "render": {"train_grid_size": 32, "eval_grid_size": 32},
            "guide": {"text": "a photo of a dairy cow",
                      "shape_path": str(tmp / "s.obj"),
                      "texture_resolution": 16,
                      "zero123plus_path": str(snap)},
            "optim": {"seed": 0, "sds_iterations": ITERS,
                      "local_sds_margin_px": 8}}


def _draws(key, hot, z_shape):
    """The draws of the reference's sds_step from its key."""
    k_enc, k_noise, k_teach, k_tile = jax.random.split(key, 4)
    cl = hot["cond_lat_pair"]
    k_neg, k_cond = jax.random.split(k_teach)
    return {
        "tile_idx": int(jax.random.choice(k_tile, 6, p=hot["tile_probs"])),
        "eps": np.asarray(jax.random.normal(k_enc, z_shape, jnp.float32)),
        "noise": np.asarray(jax.random.normal(k_noise, z_shape)),
        "neg_noise": np.asarray(jax.random.normal(k_neg, cl.shape[1:],
                                                  cl.dtype)),
        "cond_noise": np.asarray(jax.random.normal(k_cond, cl.shape[1:],
                                                   cl.dtype)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("whole")
    write_obj(tmp / "s.obj", *uv_sphere(6, 8))
    snap = jsynth.write_zero123plus_snapshot(tmp / "z123")
    jsynth.write_controlnet_snapshot(snap / "controlnet")

    ref = JConTEXTure(config_from_dict(_cfg_dict(tmp, snap)),
                      tiny_models=True, backend="xla")
    key0 = ref.key
    params0 = jax.tree.map(np.asarray, ref.texture_params)
    setup = ref.prepare_sds(skip_bootstrap=True)
    step, optimizer, hot = ref._build_sds_step(setup, None)
    acp = ref.zero123plus.alphas_cumprod
    ts = np.asarray(jsch.dreamtime_schedule(acp, ITERS, m=500, s=125))
    params, opt_state = ref.texture_params, optimizer.init(ref.texture_params)
    keys, losses = [], []
    for i in range(ITERS):  # paint_zero123plus's loop
        ref.key, sub = jax.random.split(ref.key)
        t = jnp.asarray([int(ts[i])], jnp.int32)
        params, opt_state, loss, *_ = step(params, opt_state, t, sub, hot)
        keys.append(sub)
        losses.append(float(loss))
    reference = {"key0": key0, "params0": params0, "setup": setup,
                 "hot": hot, "ts": ts, "keys": keys, "losses": losses,
                 "params": jax.tree.map(np.asarray, params),
                 "teacher": jax.tree.map(np.asarray, ref.zero123plus.params),
                 "lr": ref.cfg.optim.sds_lr}

    run = tr.ConTEXTure(torch_config_from_dict(_cfg_dict(tmp, snap)),
                        tiny_models=True, device="cpu")
    run.mlp.load_state_dict(weights.convert_tree(params0))
    _, k_cond = jax.random.split(key0)
    shape = (1,) + tuple(setup["cond_lat_pair"].shape[1:])
    eps = tuple(torch.from_numpy(np.array(jax.random.normal(k, shape)))
                for k in jax.random.split(k_cond))
    psetup = tr.prepare_sds(run.cfg, run.mesh_model, run.mlp, run.teacher,
                            eps=eps, skip_bootstrap=True)
    sds = tr.SDSTrainer(run.cfg, psetup, teacher=run.teacher, mlp=run.mlp,
                        tiny=True, device="cpu", mesh_model=run.mesh_model)
    pts = [int(t) for t in sds.t_schedule(ITERS).tolist()]
    plosses = []
    for i in range(ITERS):
        params_i, loss, *_ = sds.step(
            pts[i], _draws(keys[i], hot, sds.latent_shape()))
        plosses.append(float(loss))
    port = {"run": run, "ts": pts, "losses": plosses, "params": params_i}
    return reference, port


def test_both_read_the_same_towers(runs):
    """The port's towers, loaded from the snapshot by its ConTEXTure, equal
    the reference's loaded towers carried across by weights.py."""
    from contexture_nerf_tpu_torch.diffusion.zero123plus import \
        Zero123PlusTeacher

    reference, port = runs
    carried = Zero123PlusTeacher(tiny=True, device="cpu")
    weights.load_teacher(carried, reference["teacher"])
    for tower in ("unet", "controlnet", "vae_encoder"):
        want = getattr(carried, tower).state_dict()
        got = getattr(port["run"].teacher, tower).state_dict()
        assert list(got) == list(want)
        for k, v in want.items():
            torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def test_t_schedules_are_equal(runs):
    reference, port = runs
    assert port["ts"] == [int(t) for t in reference["ts"]]


def test_each_steps_loss_matches(runs):
    reference, port = runs
    np.testing.assert_allclose(port["losses"], reference["losses"],
                               rtol=1e-4)


def test_final_parameters_match(runs):
    reference, port = runs
    lr = reference["lr"]
    want = weights.convert_tree(reference["params"])
    old = weights.convert_tree(reference["params0"])
    got = port["params"]
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                   atol=3 * lr * ITERS, err_msg=k)
        agree = (torch.sign(got[k] - old[k]) == torch.sign(v - old[k]))
        assert agree.float().mean() >= 0.99, k

"""The port's multi-rank paths (contexture_nerf_tpu_torch.parallel and the
trainer's mesh) on 2 and 4 gloo ranks on the CPU, against the
single-process port and the JAX reference.

One launch of N ranks (parallel/launch.py `run_ranks`, one spawned process
a rank, torch on one thread, a deadline that kills every rank) runs every
check in turn (`rank_checks`): the mesh's placement
(tests/test_parallel.py:25-77), ring attention against dense attention
(atol 2e-5, rtol 1e-4, as test_parallel.py:213-240) and its refusal of
indivisible lengths, the tiny teacher's v-prediction with its towers
tensor-parallel against the replicated one (rtol 2e-4, atol 2e-5,
test_parallel.py:80-117; the int8_controlnet case at tp = 2: a row-parallel
layer that is not quantized sums in another order, and an int8 rounding
downstream can turn that ulp into a quantization step, more often the more
shards), one sharded SDS step per mode (DP, TP = 2, SP = 2) against the
single-device step from the same state and draws (loss within 1e-3 relative
and parameters within 5e-5, the reference's dryrun tolerances,
__graft_entry__.py:160-200, and the MLP's gradients before Adam within
chip_smoke.GRAD_RTOL: Adam's first step moves each parameter by about lr
whatever the gradient, so the parameters alone cannot see a wrong
gradient), chip_smoke.PARALLEL_FAULTS planted one at a time (each must fail
that check), the sharded eval against the single frames, make_mesh's
shapes, and the CLI painting a tiny run under torchrun's environment, held
to the single-process run.
The reference's ring attention runs on its 8 virtual CPU devices, and its
`_make_mesh` gives the words the port's errors keep.
"""

import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import (GRAD_RTOL, LOSS_RTOL, PARALLEL_FAULTS, PARAM_ATOL,
                        mlp_grads, planted_parallel_fault, step_errors)

ROOT = Path(__file__).resolve().parent.parent
# the planted faults, each in the mode whose collectives it breaks
FAULT_MODES = {"n_fold_gather": "dp", "no_grad_reduce": "dp",
               "tp_copy_no_reduce": "tp", "tp_row_no_reduce": "tp"}
SHAPE = (2, 3, 64, 16)  # ring inputs (B, H, S, d), as test_parallel.py
KERNEL_ROUTES = ("flash_attn_single", "flash_attn_two_source")


def _cfg_dict(tmp, **optim):
    return {"log": {"exp_name": "dp", "exp_root": str(Path(tmp) / "exp"),
                    "log_images": False, "save_mesh": False,
                    "eval_size": 3, "full_eval_size": 3},
            "render": {"train_grid_size": 32, "eval_grid_size": 32},
            "guide": {"text": "t", "shape_path": str(Path(tmp) / "s.obj"),
                      "texture_resolution": 16},
            "optim": {"seed": 0, "local_sds_grad": True,
                      "local_sds_margin_px": 8,
                      "precompute_uv_embedding": True, **optim}}


def _ring_inputs():
    rng = np.random.default_rng(7)
    return [torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32))
            for _ in range(5)]


def _cli_argv(tmp, parallel):
    yaml = ROOT / "configs" / "text_guided" / "spot_quick_test.yaml"
    return [f"--config_path={yaml}", f"--guide.shape_path={tmp}/s.obj",
            f"--log.exp_root={tmp}/{'ranks' if parallel else 'one'}",
            "--render.train_grid_size=48", "--render.eval_grid_size=48",
            "--guide.texture_resolution=16", "--log.full_eval_size=3",
            "--optim.sds_iterations=2", "--log.log_images=false",
            "--log.save_mesh=false"] + (
                ["--optim.data_parallel=on"] if parallel else [])


# -- what each rank runs ----------------------------------------------------------

def _placement(dev):
    from contexture_nerf_tpu_torch.parallel import mesh as pm

    n = pm.world_size()
    mesh = pm.create_mesh((n,), ("views",))
    tree = {"a": torch.arange(8 * 3.0).reshape(8, 3),
            "b": torch.zeros(5, 3), "c": torch.zeros(()),
            "d": [torch.arange(4 * n)]}
    placed = pm.shard_leading_axis(tree, mesh)
    return {"mesh": (tuple(mesh.mesh.shape), mesh.mesh_dim_names),
            "a": placed["a"], "b": placed["b"].shape, "c": placed["c"].shape,
            "d": placed["d"][0], "views": str(pm.views_sharding(mesh)),
            "replicated": str(pm.replicated(mesh))}


def _ring(dev):
    from contexture_nerf_tpu_torch.parallel import mesh as pm
    from contexture_nerf_tpu_torch.parallel.ring import ring_attention

    n = pm.world_size()
    mesh = pm.create_mesh((n,), ("sp",))
    q, k, v, ek, ev = _ring_inputs()
    out = {"one": ring_attention(q, k, v, mesh),
           "two": ring_attention(q, k, v, mesh, extra_k=ek, extra_v=ev)}
    try:
        ring_attention(q[:, :, :-1], k, v, mesh)
    except ValueError as e:
        out["indivisible"] = str(e)
    try:
        ring_attention(q.requires_grad_(True), k, v, mesh)
    except ValueError as e:
        out["grad"] = str(e)
    return out


def _teacher_inputs(teacher):
    g = torch.Generator().manual_seed(1)
    lat = torch.randn(1, 4, 24, 16, generator=g) * 0.3
    cond = torch.randn(2, 4, 8, 8, generator=g) * 0.2
    ehs = torch.randn(2, 77, teacher.text_config.hidden_size,
                      generator=g) * 0.02
    noise = [torch.randn(4, 8, 8, generator=g) for _ in range(2)]
    return lat, cond, ehs, noise


def _v_pred(teacher, inputs):
    lat, cond, ehs, (neg, cnd) = inputs
    depth = torch.zeros(1, 3, 24 * 8, 16 * 8)
    return teacher._cfg_v_pred(lat, torch.tensor([300]), cond, ehs, depth,
                               5.0, neg, cnd)


def _tp_teacher(dev):
    from contexture_nerf_tpu_torch.diffusion.zero123plus import \
        Zero123PlusTeacher
    from contexture_nerf_tpu_torch.parallel import mesh as pm
    from contexture_nerf_tpu_torch.parallel import tp

    n = pm.world_size()
    out = {}
    for case, int8 in (("bf16_path", False), ("int8_controlnet", True)):
        mesh = (pm.create_mesh((n // 2, 2), ("views", "tp")) if int8
                else pm.create_mesh((n,), ("tp",)))
        teacher = Zero123PlusTeacher(
            tiny=True, device=dev, generator=torch.Generator().manual_seed(0))
        teacher.set_int8(int8, False)
        inputs = _teacher_inputs(teacher)
        towers = (teacher.unet, teacher.controlnet, teacher.vae_encoder)
        replicated = _v_pred(teacher, inputs)
        before = sum(tp.parameter_bytes(t) for t in towers)
        specs = tp.tp_param_specs(teacher.unet, mesh)
        for t in towers:
            tp.shard_params_tp(t, mesh)
        after = sum(tp.parameter_bytes(t) for t in towers)
        out[case] = {"replicated": replicated, "sharded": _v_pred(
            teacher, inputs), "bytes": (before, after),
            "n_sharded": sum(1 for s in specs.values() if s.is_shard())}
    return out


def _steps(dev, tmp):
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.ops import attention as att
    from contexture_nerf_tpu_torch.parallel import mesh as pm
    from contexture_nerf_tpu_torch.tools.launches import census
    from contexture_nerf_tpu_torch.training import trainer as tr

    tr.SP_MIN_SEQ = 16  # so the tiny teacher's attention takes the ring
    # and, in the census, the kernel route (a CPU tensor takes the plain
    # route whatever the lengths)
    att.MIN_SQ_KERNEL = att.MIN_KV_KERNEL = 16
    out = {}
    for mode, knobs in (("dp", {}), ("tp", {"tensor_parallel": 2}),
                        ("sp", {"sequence_parallel": 2})):
        cfg = config_from_dict(_cfg_dict(tmp, data_parallel="on", **knobs))
        gen, teacher, mlp, _, mm = tr.build_models(
            cfg, tiny=True, device=dev, skip_bootstrap=True)
        setup = tr.prepare_sds(cfg, mm, mlp, teacher, skip_bootstrap=True,
                               generator=gen)
        one = tr.SDSTrainer(cfg, setup, teacher=copy.deepcopy(teacher),
                            mlp=copy.deepcopy(mlp), tiny=True, device=dev,
                            generator=gen, mesh=None)
        draws = one.draw()
        p1, l1, n1, _, _ = one.step(500, draws)
        mlp0 = copy.deepcopy(mlp)
        many = tr.SDSTrainer(cfg, setup, teacher=teacher, mlp=mlp, tiny=True,
                             device=dev, generator=gen)
        pm.collective_counts.clear()
        with census() as launches:
            p2, l2, n2, _, _ = many.step(500, draws)
        out[mode] = {"single": (p1, float(l1), mlp_grads(one.mlp)),
                     "sharded": (p2, float(l2), mlp_grads(many.mlp)),
                     "grad_norm": (float(n1), float(n2)),
                     "mesh": (tuple(many.mesh.mesh.shape),
                              many.mesh.mesh_dim_names),
                     "collectives": dict(pm.collective_counts),
                     "launches": launches.counts,
                     "faults": {}}
        for fault in (f for f, m in FAULT_MODES.items() if m == mode):
            bad = tr.SDSTrainer(cfg, setup, teacher=teacher,
                                mlp=copy.deepcopy(mlp0), tiny=True,
                                device=dev, generator=gen)
            with planted_parallel_fault(fault):
                p3, l3, _, _, _ = bad.step(500, draws)
            out[mode]["faults"][fault] = (p3, float(l3), mlp_grads(bad.mlp))
    return out


def _eval(dev, tmp):
    from PIL import Image

    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.parallel import mesh as pm
    from contexture_nerf_tpu_torch.training.trainer import ConTEXTure

    run = ConTEXTure(config_from_dict(_cfg_dict(tmp, data_parallel="on")),
                     tiny_models=True, device=dev)
    out = Path(tmp) / "frames"
    run.evaluate(run.dataloaders["val"], out / "sharded")
    if not pm.is_writer():
        return {"files": None}
    run.cfg.optim.data_parallel = "off"  # this rank alone: the single path
    run.evaluate(run.dataloaders["val"], out / "single")
    return {"files": {d: [(p.name, np.asarray(Image.open(p)))
                          for p in sorted((out / d).glob("*.jpg"))]
                      for d in ("sharded", "single")}}


def _make_mesh(dev, tmp):
    from contexture_nerf_tpu_torch.core.config import config_from_dict
    from contexture_nerf_tpu_torch.training.trainer import make_mesh

    out = {}
    for name, knobs in (("on", {"data_parallel": "on"}),
                        ("tp2", {"data_parallel": "on",
                                 "tensor_parallel": 2}),
                        ("sp2", {"data_parallel": "on",
                                 "sequence_parallel": 2}),
                        ("tp3", {"data_parallel": "on",
                                 "tensor_parallel": 3}),
                        ("off_tp2", {"data_parallel": "off",
                                     "tensor_parallel": 2}),
                        ("auto", {"data_parallel": "auto"}),
                        ("auto_sp2", {"data_parallel": "auto",
                                      "sequence_parallel": 2}),
                        ("both", {"data_parallel": "on",
                                  "tensor_parallel": 2,
                                  "sequence_parallel": 2})):
        try:
            m = make_mesh(config_from_dict(_cfg_dict(tmp, **knobs)))
            out[name] = None if m is None else (tuple(m.mesh.shape),
                                                m.mesh_dim_names)
        except ValueError as e:
            out[name] = "ValueError: " + str(e)
    return out


def _cli(dev, tmp):
    from contexture_nerf_tpu_torch import run_contexture

    run = run_contexture.main(_cli_argv(tmp, True), device=dev,
                              tiny_models=True)
    return {"params": {k: v.clone() for k, v in run.mlp.state_dict().items()},
            "exp": str(run.exp_path)}


def rank_checks(dev, tmp):
    """Every check on this rank, in turn; run by `run_ranks`."""
    return {"placement": _placement(dev), "ring": _ring(dev),
            "tp_teacher": _tp_teacher(dev), "steps": _steps(dev, tmp),
            "eval": _eval(dev, tmp), "make_mesh": _make_mesh(dev, tmp),
            "cli": _cli(dev, tmp)}


# -- the tests --------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_process_cli(tmp_path_factory):
    """The CLI run of `_cli_argv` in this process alone."""
    from contexture_nerf_tpu_torch import run_contexture
    from tools.make_shapes import uv_sphere, write_obj

    tmp = tmp_path_factory.mktemp("one")
    write_obj(tmp / "s.obj", *uv_sphere(8, 12))
    return run_contexture.main(_cli_argv(tmp, False), device="cpu",
                               tiny_models=True)


@pytest.fixture(scope="module", params=[2, 4], ids=lambda n: f"{n}ranks")
def ranks(request, tmp_path_factory):
    from contexture_nerf_tpu_torch.parallel.launch import run_ranks
    from tools.make_shapes import uv_sphere, write_obj

    n = request.param
    tmp = tmp_path_factory.mktemp(f"ranks{n}")
    write_obj(tmp / "s.obj", *uv_sphere(8, 12))
    results = run_ranks(n, rank_checks, "cpu",
                        kwargs={"tmp": str(tmp)},
                        timeout_s=400)
    return n, tmp, results


def test_mesh_placement_gives_each_rank_its_block(ranks):
    n, _, res = ranks
    a = torch.arange(8 * 3.0).reshape(8, 3)
    for r, got in enumerate(res):
        p = got["placement"]
        assert p["mesh"] == ((n,), ("views",))
        torch.testing.assert_close(p["a"], a[r * 8 // n:(r + 1) * 8 // n],
                                   rtol=0, atol=0)
        assert p["b"] == (5, 3) and p["c"] == ()  # left whole
        assert p["d"].tolist() == list(range(4 * r, 4 * r + 4))
        assert p["views"] == "S(0)" and p["replicated"] == "R"


def test_ring_attention_matches_dense_and_the_reference(ranks):
    import jax
    import jax.numpy as jnp

    from contexture_nerf_tpu.ops.attention import _xla_attention
    from contexture_nerf_tpu.parallel.mesh import create_mesh
    from contexture_nerf_tpu.parallel.ring import ring_attention
    from contexture_nerf_tpu_torch.ops.attention import xla_attention_plain

    n, _, res = ranks
    q, k, v, ek, ev = _ring_inputs()
    dense = xla_attention_plain(q, k, v)
    dense2 = xla_attention_plain(q, torch.cat([k, ek], 2),
                                 torch.cat([v, ev], 2))
    mesh = create_mesh((n,), ("sp",), devices=jax.devices()[:n])
    jq, jk, jv, jek, jev = (jnp.asarray(t.numpy()) for t in (q, k, v, ek, ev))
    ref = np.asarray(jax.jit(lambda *a: ring_attention(*a, mesh=mesh))(
        jq, jk, jv))
    ref2 = np.asarray(jax.jit(lambda q, k, v, ek, ev: ring_attention(
        q, k, v, mesh=mesh, extra_k=ek, extra_v=ev))(jq, jk, jv, jek, jev))
    np.testing.assert_allclose(ref, np.asarray(_xla_attention(jq, jk, jv)),
                               atol=2e-5, rtol=1e-4)
    for got in res:
        ring = got["ring"]
        for out, want, jref in ((ring["one"], dense, ref),
                                (ring["two"], dense2, ref2)):
            assert out.shape == SHAPE and out.dtype == torch.float32
            torch.testing.assert_close(out, want, atol=2e-5, rtol=1e-4)
            np.testing.assert_allclose(out.numpy(), jref, atol=2e-5,
                                       rtol=1e-4)
            # every rank holds the whole output, the same
            torch.testing.assert_close(out, res[0]["ring"][
                "one" if want is dense else "two"], rtol=0, atol=0)
        assert "divide" in ring["indivisible"]
        assert "no backward" in ring["grad"]


@pytest.mark.parametrize("case", ["bf16_path", "int8_controlnet"])
def test_tensor_parallel_teacher_matches_replicated(ranks, case):
    n, _, res = ranks
    for got in res:
        t = got["tp_teacher"][case]
        assert t["n_sharded"] > 0
        torch.testing.assert_close(t["sharded"], t["replicated"],
                                   rtol=2e-4, atol=2e-5)
        before, after = t["bytes"]
        assert after < before  # each rank holds only its shards
        torch.testing.assert_close(t["sharded"], res[0]["tp_teacher"][case][
            "sharded"], rtol=0, atol=0)
    if case == "int8_controlnet":
        # the int8 ControlNet's scales are the unsharded layer's
        assert got["tp_teacher"][case]["sharded"].isfinite().all()


@pytest.mark.parametrize("mode", ["dp", "tp", "sp"])
def test_sharded_step_matches_the_single_device_step(ranks, mode):
    n, _, res = ranks
    want_mesh = {"dp": ((n,), ("views",)),
                 "tp": ((n // 2, 2), ("views", "tp")),
                 "sp": ((n // 2, 2), ("views", "sp"))}[mode]
    for got in res:
        s = got["steps"][mode]
        assert s["mesh"] == want_mesh
        (p1, l1, _), (p2, l2, _) = s["single"], s["sharded"]
        assert abs(l2 - l1) <= LOSS_RTOL * max(1.0, abs(l1))
        # the gradients Adam took: summed over views, through the gather's
        # and the tp layers' backward
        _, _, grad_err = step_errors(s["sharded"], s["single"])
        assert grad_err <= GRAD_RTOL, grad_err
        n1, n2 = s["grad_norm"]
        assert abs(n2 - n1) <= GRAD_RTOL * n1
        for key in p1:
            torch.testing.assert_close(p2[key], p1[key], rtol=0,
                                       atol=PARAM_ATOL)
            # every rank ends with the same parameters
            torch.testing.assert_close(
                p2[key], res[0]["steps"][mode]["sharded"][0][key],
                rtol=0, atol=0)
        c = s["collectives"]
        assert c.get("all_gather", 0) >= 1
        if mode == "sp":
            assert c.get("send_recv", 0) > 0  # the ring ran
            # the ring takes calls the kernel would take without it
            dp = got["steps"]["dp"]["launches"]
            assert s["launches"]["flash_attn_two_source"] <= \
                dp["flash_attn_two_source"]
            assert sum(s["launches"][k] for k in KERNEL_ROUTES) < \
                sum(dp[k] for k in KERNEL_ROUTES)


@pytest.mark.parametrize("fault", list(FAULT_MODES))
def test_planted_fault_fails_the_step_check(ranks, fault):
    """Each of PARALLEL_FAULTS, planted in its mode's step, moves the
    gradients past GRAD_RTOL (an n-fold gradient or a missing sum leaves
    the loss and the parameters within the dryrun's limits)."""
    n, _, res = ranks
    mode = FAULT_MODES[fault]
    assert fault in PARALLEL_FAULTS
    for got in res:
        s = got["steps"][mode]
        _, _, grad_err = step_errors(s["faults"][fault], s["single"])
        assert grad_err > GRAD_RTOL, (fault, grad_err)


def test_sharded_eval_matches_single_frames(ranks):
    n, _, res = ranks
    files = res[0]["eval"]["files"]
    assert all(r["eval"]["files"] is None for r in res[1:])  # rank 0 writes
    names = [name for name, _ in files["sharded"]]
    assert names == [f"eval_rendered_{i:04d}_rgb.jpg" for i in range(3)]
    assert names == [name for name, _ in files["single"]]
    for (_, a), (_, b) in zip(files["sharded"], files["single"]):
        np.testing.assert_array_equal(a, b)


def test_make_mesh_shapes_and_errors(ranks, monkeypatch):
    import jax

    import contexture_nerf_tpu.training.trainer as jax_trainer
    from contexture_nerf_tpu.core.config import config_from_dict

    n, tmp, res = ranks
    got = res[0]["make_mesh"]
    assert all(r["make_mesh"] == got for r in res)
    assert got["on"] == ((n,), ("views",))
    assert got["tp2"] == ((n // 2, 2), ("views", "tp"))
    assert got["sp2"] == ((n // 2, 2), ("views", "sp"))
    assert got["auto"] is None  # 'auto' builds a mesh on CUDA ranks only
    # the reference's words, on n of its virtual devices
    devs = jax.devices()[:n]
    monkeypatch.setattr(jax_trainer.jax, "devices", lambda *a: devs)
    monkeypatch.setattr(jax_trainer.jax, "default_backend", lambda: "cpu")
    for name, knobs, words in (
            ("tp3", {"data_parallel": "on", "tensor_parallel": 3},
             "does not divide"),
            ("off_tp2", {"data_parallel": "off", "tensor_parallel": 2},
             "no mesh can be built"),
            ("auto_sp2", {"data_parallel": "auto", "sequence_parallel": 2},
             "builds no mesh"),
            ("both", {"data_parallel": "on", "tensor_parallel": 2,
                      "sequence_parallel": 2}, "mutually exclusive")):
        with pytest.raises(ValueError, match=words) as ref:
            jax_trainer.ConTEXTure._make_mesh(
                type("T", (), {"cfg": config_from_dict(
                    _cfg_dict(tmp, **knobs))})())
        assert got[name].startswith("ValueError: ") and words in got[name]
        if name == "both":
            assert got[name] == "ValueError: " + str(ref.value)
    if n % 3:
        assert "optim.tensor_parallel=3" in got["tp3"]


def test_cli_under_torchrun_matches_the_single_process_run(
        ranks, one_process_cli):
    """python -m contexture_nerf_tpu_torch.run_contexture under torchrun's
    environment with --optim.data_parallel=on: rank 0 writes the run,
    whose parameters and losses match the same CLI run in one process."""
    n, tmp, res = ranks
    one = one_process_cli
    exp = Path(res[0]["cli"]["exp"])
    assert exp.parent.name == "ranks"
    for key, want in one.mlp.state_dict().items():
        for r in res:
            torch.testing.assert_close(r["cli"]["params"][key], want,
                                       rtol=0, atol=PARAM_ATOL)
    m1 = json.loads((one.exp_path / "metrics.json").read_text())
    m2 = json.loads((exp / "metrics.json").read_text())
    assert [m["iter"] for m in m2] == [m["iter"] for m in m1]
    for a, b in zip(m1, m2):
        assert abs(a["sds_loss"] - b["sds_loss"]) <= \
            LOSS_RTOL * max(1.0, abs(a["sds_loss"]))
        # the gradients' norm, summed over the ranks before Adam
        assert abs(a["grad_norm"] - b["grad_norm"]) <= \
            GRAD_RTOL * a["grad_norm"]
    assert sorted(p.name for p in (exp / "results").iterdir()) == \
        sorted(p.name for p in (one.exp_path / "results").iterdir())
    assert (exp / "log.txt").exists() and (exp / "timings.json").exists()

"""The port's diffusers/transformers loader (contexture_nerf_tpu_torch
.diffusion.weights), its snapshot writer (contexture_nerf_tpu_torch.tools
.synth_snapshot), the snapshot resolution of the SD2-depth stack and the
Zero123++ teacher, the ramp, the tokenizer with textual-inversion concepts,
and a paint run from the five config keys, against the JAX package on
tiny snapshots that tools/synth_snapshot.py writes on the CPU.

Loaded towers equal the JAX converter's output carried through
`weights.convert_tree` exactly: both read the same f32 bytes and neither
rounds. The text tower's embeddings of a concept prompt agree to the
tolerance tests/test_torch_clip.py holds that tower to (atol 2e-5: XLA and
torch sum the matmuls in other orders).
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from contexture_nerf_tpu.diffusion import weights as JW
from contexture_nerf_tpu.diffusion import zero123plus as jz
from contexture_nerf_tpu.diffusion.clip import CLIPTextConfig as JTextConfig
from contexture_nerf_tpu.diffusion.clip import CLIPTokenizer as JTokenizer
from contexture_nerf_tpu.diffusion.clip import \
    CLIPVisionConfig as JVisionConfig
from contexture_nerf_tpu.diffusion.sd_depth import SDWeightPaths as JSDPaths
from contexture_nerf_tpu.diffusion.sd_depth import \
    StableDiffusionDepth as JSD
from contexture_nerf_tpu.diffusion.unet import UNetConfig as JUNetConfig
from contexture_nerf_tpu.diffusion.vae import VAEConfig as JVAEConfig
from contexture_nerf_tpu_torch import run_contexture
from contexture_nerf_tpu_torch import weights as bridge
from contexture_nerf_tpu_torch.core.config import config_from_dict
from contexture_nerf_tpu_torch.diffusion import clip as tclip
from contexture_nerf_tpu_torch.diffusion import weights as W
from contexture_nerf_tpu_torch.diffusion.sd_depth import (SDWeightPaths,
                                                          StableDiffusionDepth)
from contexture_nerf_tpu_torch.diffusion.zero123plus import (
    Zero123PlusTeacher, Zero123PlusWeightPaths)
from contexture_nerf_tpu_torch.tools import synth_snapshot as tsynth
from contexture_nerf_tpu_torch.training import trainer as tr
from tools import synth_snapshot as jsynth
from tools.make_shapes import uv_sphere, write_obj

ROOT = Path(__file__).resolve().parent.parent
CONCEPT = {"<sks>": 0.1, "<sks>-style": -0.2}  # the second prefixed by the first


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for this module: the suite runs several test
    processes at once, and more threads than cores slow all of them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def snaps(tmp_path_factory):
    """The JAX side's tiny snapshots, a Zero123++ snapshot with a
    controlnet/ subfolder, and a textual-inversion concept file."""
    d = tmp_path_factory.mktemp("snapshots")
    s = {"sd": jsynth.write_sd_snapshot(d / "sd"),
         "inpaint": jsynth.write_inpaint_snapshot(d / "inpaint"),
         "z123": jsynth.write_zero123plus_snapshot(d / "z123"),
         "cnet": jsynth.write_controlnet_snapshot(d / "cnet")}
    s["z123_sub"] = d / "z123_sub"
    shutil.copytree(s["z123"], s["z123_sub"])
    jsynth.write_controlnet_snapshot(s["z123_sub"] / "controlnet", seed=5)
    rng = np.random.default_rng(7)
    hidden = JTextConfig.tiny().hidden_size
    s["concept"] = d / "learned_embeds.bin"
    torch.save({tok: torch.from_numpy(
        (scale * rng.standard_normal(hidden)).astype(np.float32))
        for tok, scale in CONCEPT.items()}, s["concept"])
    return s


def _jax_vision_config():
    cfg = JVisionConfig.tiny()
    cfg.projection_dim = JTextConfig.tiny().hidden_size
    return cfg


def _jax(path, kind):
    """What the JAX converter makes of a checkpoint, as a port state_dict."""
    sd = JW.load_state_dict(str(path))
    if kind == "unet5":
        return bridge.convert_tree(JW.convert_unet(
            sd, JUNetConfig.tiny(in_channels=5)))
    if kind == "unet9":
        return bridge.convert_tree(JW.convert_unet(
            sd, JUNetConfig.tiny(in_channels=9)))
    if kind == "unet4":
        return bridge.convert_tree(JW.convert_unet(
            sd, JUNetConfig.tiny(in_channels=4)))
    if kind == "controlnet":
        return bridge.convert_tree(JW.convert_controlnet(
            sd, JUNetConfig.tiny(in_channels=4)))
    if kind in ("vae_encoder", "vae_decoder"):
        tree = JW.convert_vae(sd, JVAEConfig.tiny())
        return (bridge.vae_encoder_state_dict(tree) if kind == "vae_encoder"
                else bridge.vae_decoder_state_dict(tree))
    if kind == "text":
        return bridge.convert_tree(JW.convert_clip_text(
            sd, JTextConfig.tiny()))
    assert kind == "vision"
    return bridge.convert_tree(JW.convert_clip_vision(
        sd, _jax_vision_config()))


def _assert_equal(module, want):
    got = module.state_dict()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _files(root: Path):
    return sorted(p for p in Path(root).rglob("*.safetensors"))


# -- the safetensors reader --------------------------------------------------------------

@pytest.mark.parametrize("snap", ["sd", "inpaint", "z123", "cnet"])
def test_reader_matches_the_safetensors_package(snaps, snap):
    files = _files(snaps[snap])
    assert files
    for path in files:
        want = load_file(str(path))
        ckpt = W.load_state_dict(str(path))
        assert set(ckpt) == set(want)
        for k, v in want.items():
            got = ckpt[k].numpy()
            assert got.dtype == v.dtype and got.shape == v.shape
            assert ckpt.shape(k) == v.shape
            assert np.array_equal(got, v), k


def test_reader_reads_f16(tmp_path):
    rng = np.random.default_rng(3)
    want = {"a.weight": rng.standard_normal((5, 3)).astype(np.float16),
            "b": rng.standard_normal(7).astype(np.float16),
            "scalar": np.asarray(1.5, np.float16),
            "empty": np.zeros((0, 4), np.float16),
            "c.f32": rng.standard_normal((2, 2, 3)).astype(np.float32)}
    save_file(want, str(tmp_path / "model.safetensors"))
    ckpt = W.load_state_dict(str(tmp_path))  # a directory resolves
    assert ckpt.path.endswith("model.safetensors")
    for k, v in want.items():
        t = ckpt[k]
        assert t.dtype == torch.from_numpy(v).dtype and tuple(t.shape) == \
            v.shape, k
        assert np.array_equal(t.numpy(), v), k


def test_reader_refuses_other_dtypes(tmp_path):
    save_file({"i": np.arange(4, dtype=np.int64)},
              str(tmp_path / "model.safetensors"))
    with pytest.raises(ValueError, match="I64"):
        W.load_state_dict(str(tmp_path))["i"]


def test_bin_checkpoint_loads_as_the_jax_side(tmp_path, snaps):
    """A .bin with a "state_dict" wrapper, beside no safetensors file."""
    src = load_file(str(snaps["cnet"] / "diffusion_pytorch_model.safetensors"))
    torch.save({"state_dict": {k: torch.from_numpy(v)
                               for k, v in src.items()}},
               tmp_path / "diffusion_pytorch_model.bin")
    want = JW.load_state_dict(str(tmp_path))
    got = W.load_state_dict(str(tmp_path))
    assert got.path.endswith(".bin") and set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k


def test_checkpoint_resolution_order_and_missing(tmp_path):
    """The names in the JAX side's order: each file written takes the place
    of those after it."""
    ckpt_dir, empty = tmp_path / "ckpt", tmp_path / "empty"
    ckpt_dir.mkdir()
    empty.mkdir()
    for name in reversed(W.CHECKPOINT_NAMES):
        if name.endswith(".safetensors"):
            save_file({"x": np.zeros(1, np.float32)}, str(ckpt_dir / name))
        else:
            torch.save({"x": torch.zeros(1)}, ckpt_dir / name)
        assert W.resolve_checkpoint(str(ckpt_dir)).endswith(name)
    with pytest.raises(FileNotFoundError, match="no checkpoint file"):
        W.load_state_dict(str(empty))
    with pytest.raises(FileNotFoundError, match="no such checkpoint"):
        W.load_state_dict(str(tmp_path / "missing.safetensors"))


# -- every tower against the JAX converter ---------------------------------------------

@pytest.fixture(scope="module")
def loaded(snaps):
    """The port's SD2-depth stack and teachers (standalone ControlNet, and
    the controlnet/ subfolder) loaded from the snapshots."""
    sd = StableDiffusionDepth(tiny=True, device="cpu",
                              weight_paths=SDWeightPaths.from_snapshot(
                                  str(snaps["sd"]), str(snaps["inpaint"])))
    z = Zero123PlusTeacher(tiny=True, device="cpu",
                           weight_paths=Zero123PlusWeightPaths.from_snapshot(
                               str(snaps["z123"]), str(snaps["cnet"])))
    z_sub = Zero123PlusTeacher(
        tiny=True, device="cpu",
        weight_paths=Zero123PlusWeightPaths.from_snapshot(
            str(snaps["z123_sub"])))
    return {"sd": sd, "z": z, "z_sub": z_sub}


TOWERS = {
    "sd2_depth_unet": ("sd", "unet", ("sd", "unet"), "unet5"),
    "inpaint_unet": ("sd", "inpaint_unet", ("inpaint", "unet"), "unet9"),
    "vae_encoder": ("sd", "vae_encoder", ("sd", "vae"), "vae_encoder"),
    "vae_decoder": ("sd", "vae_decoder", ("sd", "vae"), "vae_decoder"),
    "clip_text": ("sd", "text_encoder", ("sd", "text_encoder"), "text"),
    "zero123plus_unet": ("z", "unet", ("z123", "unet"), "unet4"),
    "zero123plus_vae_encoder": ("z", "vae_encoder", ("z123", "vae"),
                                "vae_encoder"),
    "zero123plus_clip_text": ("z", "text_encoder", ("z123", "text_encoder"),
                              "text"),
    "controlnet_standalone": ("z", "controlnet", ("cnet", ""), "controlnet"),
    "controlnet_subfolder": ("z_sub", "controlnet",
                             ("z123_sub", "controlnet"), "controlnet"),
    "clip_vision": ("z", "vision_encoder", ("z123", "vision_encoder"),
                    "vision"),
}


@pytest.mark.parametrize("tower", list(TOWERS))
def test_loaded_tower_equals_the_jax_converter(snaps, loaded, tower):
    owner, attr, (snap, sub), kind = TOWERS[tower]
    path = snaps[snap] / sub if sub else snaps[snap]
    _assert_equal(getattr(loaded[owner], attr), _jax(path, kind))
    assert loaded[owner].loaded[attr]["path"] == str(path)


def test_legacy_vae_attention_names_and_clip_position_ids(tmp_path, snaps):
    """query/key/value/proj_attn load as to_q/to_k/to_v/to_out (the JAX
    converter probes both); transformers' position_ids buffer is not a
    weight and is dropped."""
    sd = load_file(str(snaps["sd"] / "vae" / "diffusion_pytorch_model"
                       ".safetensors"))
    legacy = {}
    for k, v in sd.items():
        for new, old in (("to_q", "query"), ("to_k", "key"),
                         ("to_v", "value"), ("to_out.0", "proj_attn")):
            k = k.replace(f".attentions.0.{new}.", f".attentions.0.{old}.")
        legacy[k] = v
    save_file(legacy, str(tmp_path / "diffusion_pytorch_model.safetensors"))
    assert any(".proj_attn." in k for k in legacy)
    conv = W.convert_vae(W.load_state_dict(str(tmp_path)), JVAEConfig.tiny())
    fresh = StableDiffusionDepth(tiny=True, device="cpu")
    for part in ("encoder", "decoder"):
        tower = getattr(fresh, f"vae_{part}")
        W.load_tower_(tower, conv[part])
        _assert_equal(tower, _jax(tmp_path, f"vae_{part}"))
    text = load_file(str(snaps["sd"] / "text_encoder" / "model.safetensors"))
    text["text_model.embeddings.position_ids"] = np.arange(
        77, dtype=np.float32)[None]
    (tmp_path / "text").mkdir()
    save_file(text, str(tmp_path / "text" / "model.safetensors"))
    tower = tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny())
    W.load_checkpoint_(tower, str(tmp_path / "text"), W.convert_clip_text)
    _assert_equal(tower, _jax(snaps["sd"] / "text_encoder", "text"))


def test_load_is_strict(tmp_path, snaps):
    """A key missing or left over, or a shape that differs, raises before
    anything is copied; so does a VAE key of neither part."""
    sd = load_file(str(snaps["cnet"] / "diffusion_pytorch_model.safetensors"))
    tower = Zero123PlusTeacher(tiny=True, device="cpu").controlnet
    before = {k: v.clone() for k, v in tower.state_dict().items()}
    cases = {
        "missing keys": {k: v for k, v in sd.items()
                         if k != "conv_in.weight"},
        "unexpected keys": {**sd, "extra.weight": np.zeros(3, np.float32)},
        "shape mismatches": {**sd, "conv_in.bias": np.zeros(
            sd["conv_in.bias"].shape[0] + 1, np.float32)},
    }
    for i, (msg, bad) in enumerate(cases.items()):
        save_file(bad, str(tmp_path / f"{i}.safetensors"))
        with pytest.raises(RuntimeError, match=msg):
            W.load_checkpoint_(tower, str(tmp_path / f"{i}.safetensors"),
                               W.convert_controlnet, tower.config)
    _assert_equal(tower, before)
    save_file({"encoder.conv_in.weight": np.zeros(1, np.float32),
               "stray.weight": np.zeros(1, np.float32)},
              str(tmp_path / "vae.safetensors"))
    with pytest.raises(ValueError, match="stray.weight"):
        W.convert_vae(W.load_state_dict(str(tmp_path / "vae.safetensors")),
                      JVAEConfig.tiny())


# -- snapshot resolution and the ramp ------------------------------------------------

def _fields(wp):
    return {k: (None if v is None else str(v)) for k, v in vars(wp).items()}


def test_sd_from_snapshot_resolves_as_the_jax_side(tmp_path, snaps):
    partial = tmp_path / "partial"
    (partial / "unet").mkdir(parents=True)  # no vae/, text_encoder/, tokenizer/
    cases = [(snaps["sd"], snaps["inpaint"]), (snaps["sd"], None),
             (None, snaps["inpaint"]),  # an inpaint root with unet/
             (None, snaps["inpaint"] / "unet"),  # and without
             (partial, None), (None, None)]
    for root, inp in cases:
        args = [None if p is None else str(p) for p in (root, inp)]
        got = _fields(SDWeightPaths.from_snapshot(*args))
        assert got == _fields(JSDPaths.from_snapshot(*args)), args
    full = SDWeightPaths.from_snapshot(str(snaps["sd"]))
    assert full.vae and full.tokenizer_vocab and full.inpaint_unet is None
    part = SDWeightPaths.from_snapshot(str(partial))
    assert part.unet and part.vae is None and part.tokenizer_vocab is None


def test_zero123plus_from_snapshot_resolves_as_the_jax_side(tmp_path, snaps):
    partial = tmp_path / "partial"
    (partial / "vision_encoder").mkdir(parents=True)
    cases = [(snaps["z123"], None), (snaps["z123"], snaps["cnet"]),
             (snaps["z123_sub"], None),  # controlnet/ subfolder
             (snaps["z123_sub"], snaps["cnet"]),  # controlnet_root wins
             (None, snaps["cnet"]), (partial, None), (None, None)]
    for root, cn in cases:
        args = [None if p is None else str(p) for p in (root, cn)]
        got = _fields(Zero123PlusWeightPaths.from_snapshot(*args))
        assert got == _fields(jz.Zero123PlusWeightPaths.from_snapshot(*args)
                              ), args
    sub = Zero123PlusWeightPaths.from_snapshot(str(snaps["z123_sub"]))
    assert sub.controlnet == str(snaps["z123_sub"] / "controlnet")
    assert Zero123PlusWeightPaths.from_snapshot(
        str(snaps["z123_sub"]), str(snaps["cnet"])).controlnet == \
        str(snaps["cnet"])
    assert Zero123PlusWeightPaths.from_snapshot(str(partial)).unet is None


RAMPS = {
    "dict_key": lambda n: {"_class_name": "Zero123PlusPipeline",
                           "ramping_coefficients": list(
                               np.linspace(0.9, 0.1, n).round(4))},
    "plain_list": lambda n: list(np.linspace(0.2, 0.7, n).round(4)),
    "missing_key": lambda n: {"_class_name": "Zero123PlusPipeline"},
    "wrong_length": lambda n: list(np.linspace(0.0, 1.0, n - 1)),
}


@pytest.mark.parametrize("case", list(RAMPS))
def test_ramp_follows_the_jax_rules(tmp_path, monkeypatch, case):
    """The JAX pipeline's ramp for the same file (its towers are not
    built: the ramp is read before them)."""
    n = JTextConfig.tiny().max_positions
    path = tmp_path / "model_index.json"
    path.write_text(json.dumps(RAMPS[case](n)))
    monkeypatch.setattr(jz.Zero123PlusPipeline, "_init_or_load",
                        lambda self, wp, seed: {})

    def build_both():
        j = jz.Zero123PlusPipeline(tiny=True, weight_paths=jz
                                   .Zero123PlusWeightPaths(
                                       ramping_coefficients=str(path)))
        t = Zero123PlusTeacher(tiny=True, device="cpu",
                               weight_paths=Zero123PlusWeightPaths(
                                   ramping_coefficients=str(path)))
        return j, t

    if case == "wrong_length":
        with pytest.raises(ValueError, match="ramping_coefficients length"):
            jz.Zero123PlusPipeline(tiny=True, weight_paths=jz
                                   .Zero123PlusWeightPaths(
                                       ramping_coefficients=str(path)))
        with pytest.raises(ValueError, match="ramping_coefficients length"):
            Zero123PlusTeacher(tiny=True, device="cpu",
                               weight_paths=Zero123PlusWeightPaths(
                                   ramping_coefficients=str(path)))
        return
    if case == "missing_key":
        with pytest.warns(UserWarning, match="ramping_coefficients"):
            j, t = build_both()
    else:
        j, t = build_both()
    assert t.ramping.dtype == torch.float32
    assert np.array_equal(t.ramping.numpy(), j.ramping)


# -- the tokenizer and textual-inversion concepts ------------------------------------

PROMPTS = ["the spot", "THE, spot!", "a cab and the thing", "",
           "a photo of <sks>", "a photo of <sks>.", "<sks>, studio light",
           "<sks>-style spot", "a <sks>-style, and <sks>."]


@pytest.fixture(scope="module")
def concept_pair(snaps):
    """The JAX SD2-depth stack and the port's, both from the SD2 snapshot,
    each with the concept loaded."""
    j = JSD(tiny=True, weight_paths=JSDPaths.from_snapshot(str(snaps["sd"])))
    t = StableDiffusionDepth(tiny=True, device="cpu",
                             weight_paths=SDWeightPaths.from_snapshot(
                                 str(snaps["sd"])))
    rows = t.text_encoder.token_embedding.num_embeddings
    j.load_concept(str(snaps["concept"]))
    t.load_concept(str(snaps["concept"]))
    return j, t, rows


def test_bpe_ids_from_a_snapshot_vocab_equal_the_jax_tokenizer(snaps):
    kw = {"vocab_path": str(snaps["sd"] / "tokenizer" / "vocab.json"),
          "merges_path": str(snaps["sd"] / "tokenizer" / "merges.txt"),
          "vocab_size": JTextConfig.tiny().vocab_size}
    j, t = JTokenizer(**kw), tclip.CLIPTokenizer(**kw)
    assert t._bpe
    for p in PROMPTS:
        assert t.encode(p) == j.encode(p), p
    assert np.array_equal(t(PROMPTS), j(PROMPTS))
    hashed_j, hashed_t = JTokenizer(vocab_size=kw["vocab_size"]), \
        tclip.CLIPTokenizer(vocab_size=kw["vocab_size"])
    assert not hashed_t._bpe
    assert np.array_equal(hashed_t(PROMPTS), hashed_j(PROMPTS))


def test_concept_tokens_equal_the_jax_tokenizer(concept_pair):
    j, t, rows = concept_pair
    assert t.tokenizer.added_tokens == j.tokenizer.added_tokens == {
        tok: rows + i for i, tok in enumerate(CONCEPT)}
    for p in PROMPTS:
        assert t.tokenizer.encode(p) == j.tokenizer.encode(p), p
    assert np.array_equal(t.tokenizer(PROMPTS), j.tokenizer(PROMPTS))
    for p in ("a photo of <sks>.", "<sks>, studio light"):
        assert rows in t.tokenizer.encode(p), p
    # the special ids and the hash range do not move with added tokens
    assert t.tokenizer.vocab_size == JTextConfig.tiny().vocab_size
    assert t.tokenizer.eos_token_id == t.tokenizer.vocab_size - 1


def test_concept_grows_the_text_tower_by_whole_rows(concept_pair, snaps):
    j, t, rows = concept_pair
    table = t.text_encoder.token_embedding.weight
    assert table.shape[0] == rows + len(CONCEPT)
    assert t.text_encoder.config.vocab_size == rows + len(CONCEPT)
    learned = torch.load(snaps["concept"], weights_only=True)
    for i, tok in enumerate(CONCEPT):
        assert torch.equal(table[rows + i], learned[tok])
    jt = np.asarray(j.params["text"]["params"]["token_embedding"]
                    ["embedding"])
    assert np.array_equal(table.numpy(), jt)


def test_concept_text_embeddings_equal_the_jax_stack(concept_pair):
    j, t, _ = concept_pair
    for p in ("a photo of <sks>.", "<sks>-style spot"):
        want = np.asarray(j.get_text_embeds([p]))
        got = t.get_text_embeds([p]).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=2e-5)


# -- the port's writer ------------------------------------------------------------------

@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Seeded random tiny towers written by the port's writer."""
    d = tmp_path_factory.mktemp("written")
    g = torch.Generator().manual_seed(11)
    z = Zero123PlusTeacher(tiny=True, device="cpu", generator=g)
    sd = StableDiffusionDepth(tiny=True, device="cpu", generator=g)
    n = (tsynth.write_zero123plus_snapshot(d / "z123", z)
         + tsynth.write_controlnet_snapshot(d / "cnet", z)
         + tsynth.write_sd_snapshot(d / "sd", sd)
         + tsynth.write_inpaint_snapshot(d / "inpaint", sd))
    return {"root": d, "z": z, "sd": sd, "bytes": n}


def _header(path):
    return {k: tuple(e["shape"])
            for k, e in W.safetensors_header(str(path))[0].items()}


@pytest.mark.parametrize("component,subset", [
    ("sd/unet", False), ("sd/vae", False), ("sd/text_encoder", False),
    ("inpaint/unet", False), ("z123/unet", False), ("z123/vae", True),
    ("z123/text_encoder", False), ("z123/vision_encoder", False),
    ("cnet", False)])
def test_writer_keys_are_the_jax_synth_snapshots(snaps, written, component,
                                                 subset):
    """The writer's names and shapes against tools/synth_snapshot.py's for
    the same configs: the same set, or (the teacher's VAE, which holds only
    the encoder) a subset."""
    snap, *sub = component.split("/")
    mine = _files(written["root"] / component)
    theirs = _files(snaps[snap] / sub[0] if sub else snaps[snap])
    assert [p.name for p in mine] == [p.name for p in theirs]
    got, want = _header(mine[0]), _header(theirs[0])
    assert set(got) <= set(want)
    assert {k: want[k] for k in got} == got
    if subset:
        assert set(got) == {k for k in want if not k.startswith(
            ("decoder.", "post_quant_conv."))}
    else:
        assert set(got) == set(want)


def test_written_snapshots_load_back_bit_for_bit(written):
    d = written["root"]
    z = Zero123PlusTeacher(tiny=True, device="cpu",
                           weight_paths=Zero123PlusWeightPaths.from_snapshot(
                               str(d / "z123"), str(d / "cnet")))
    sd = StableDiffusionDepth(tiny=True, device="cpu",
                              weight_paths=SDWeightPaths.from_snapshot(
                                  str(d / "sd"), str(d / "inpaint")))
    assert sorted(z.loaded) == sorted(["unet", "controlnet", "vae_encoder",
                                       "text_encoder", "vision_encoder"])
    assert sorted(sd.loaded) == sorted(["unet", "inpaint_unet",
                                        "vae_encoder", "vae_decoder",
                                        "text_encoder"])
    _assert_equal(z, written["z"].state_dict())
    _assert_equal(sd, written["sd"].state_dict())
    assert torch.equal(z.ramping, written["z"].ramping)
    total = sum(p.stat().st_size for p in d.rglob("*") if p.is_file())
    assert total == written["bytes"]
    assert sum(v["bytes"] for v in z.loaded.values()) + sum(
        v["bytes"] for v in sd.loaded.values()) == 4 * sum(
        p.numel() for m in (z, sd) for p in m.parameters())


def test_bf16_tower_round_trips_through_f32_exactly(tmp_path):
    g = torch.Generator().manual_seed(3)
    z = Zero123PlusTeacher(tiny=True, device="cpu", generator=g)
    unet = z.unet.to(torch.bfloat16)
    path = tmp_path / "unet" / tsynth.UNIT
    tsynth.save_safetensors(tsynth.unet_tensors(unet), path)
    assert {e["dtype"] for e in W.safetensors_header(str(path))[0].values()
            } == {"F32"}
    other = Zero123PlusTeacher(tiny=True, device="cpu").unet.to(
        torch.bfloat16)
    W.load_checkpoint_(other, str(path.parent), W.convert_unet, other.config)
    _assert_equal(other, unet.state_dict())


# -- the trainer from the five config keys ----------------------------------------------

def _cfg(root: Path, shape: str, name: str, **guide):
    return config_from_dict({
        "log": {"exp_name": name, "exp_root": str(root), "eval_size": 1,
                "full_eval_size": 1, "log_images": False, "save_mesh": False},
        "render": {"train_grid_size": 48, "eval_grid_size": 48},
        "guide": {"text": "a photo of <sks>.", "shape_path": shape,
                  "texture_resolution": 16, **guide},
        "optim": {"seed": 0, "sds_iterations": 1}})


@pytest.fixture(scope="module")
def painted(tmp_path_factory, snaps):
    """ConTEXTure from a config with all five keys, and the same config's
    random-tower run, both built; the first painted for one iteration."""
    d = tmp_path_factory.mktemp("paint")
    shape = str(d / "sphere.obj")
    write_obj(shape, *uv_sphere(6, 8))
    keys = {"diffusion_name": str(snaps["sd"]),
            "inpaint_model_path": str(snaps["inpaint"]),
            "zero123plus_path": str(snaps["z123"]),
            "controlnet_path": str(snaps["cnet"]),
            "concept_path": str(snaps["concept"])}
    random_run = tr.ConTEXTure(_cfg(d, shape, "random"), tiny_models=True,
                               device="cpu")
    cfg = _cfg(d, shape, "loaded", **keys)
    run = tr.ConTEXTure(cfg, tiny_models=True, device="cpu")
    mlp0 = {k: v.clone() for k, v in run.mlp.state_dict().items()}
    run.paint()
    return {"run": run, "random": random_run, "mlp0": mlp0, "cfg": cfg}


@pytest.mark.parametrize("tower", [t for t in TOWERS
                                   if t != "controlnet_subfolder"])
def test_trainer_towers_equal_the_disk_tensors(snaps, painted, tower):
    owner, attr, (snap, sub), kind = TOWERS[tower]
    run = painted["run"]
    module = getattr(run.diffusion if owner == "sd" else run.teacher, attr)
    want = _jax(snaps[snap] / sub if sub else snaps[snap], kind)
    if tower == "clip_text":  # the concept's rows follow the snapshot's
        table = module.token_embedding.weight
        rows = want["token_embedding.weight"].shape[0]
        assert table.shape[0] == rows + len(CONCEPT)
        want["token_embedding.weight"] = torch.cat(
            [want["token_embedding.weight"], table[rows:]])
    _assert_equal(module, want)


def test_trainer_takes_the_ramp_and_tokenizers_from_the_snapshots(
        snaps, painted):
    run = painted["run"]
    index = json.loads((snaps["z123"] / "model_index.json").read_text())
    assert np.array_equal(run.teacher.ramping.numpy(), np.asarray(
        index["ramping_coefficients"], np.float32))
    assert run.teacher.tokenizer._bpe and run.diffusion.tokenizer._bpe
    assert list(run.diffusion.tokenizer.added_tokens) == list(CONCEPT)
    log = (Path(painted["cfg"].log.exp_dir) / "log.txt").read_text()
    for line in ("Zero123++ weights from snapshot", "SD2 weights from "
                 "snapshot", "Loaded textual-inversion concept"):
        assert line in log, line


def test_trainer_mlp_draws_do_not_depend_on_what_loads(painted):
    """The seeded random init runs as without snapshots and the towers
    are overwritten after it: the MLP starts from the same weights, and
    the generator stands at the same place after the models."""
    _assert_equal(painted["random"].mlp, painted["mlp0"])
    rnd = painted["random"].generator.get_state()
    again = tr.build_models(painted["cfg"], tiny=True, device="cpu")[0]
    assert torch.equal(again.get_state(), rnd)


def test_trainer_paints_one_iteration_from_the_snapshots(painted):
    exp = Path(painted["cfg"].log.exp_dir)
    metrics = json.loads((exp / "metrics.json").read_text())
    assert [e["iter"] for e in metrics] == [0]
    assert all(np.isfinite(v) for v in metrics[0].values())


def test_trainer_path_rules(tmp_path, snaps):
    """A given path that does not exist raises; diffusion_name that is no
    local directory is a hub name (random towers); a concept_path that does
    not exist is skipped, as in the reference."""
    shape = str(tmp_path / "sphere.obj")
    write_obj(shape, *uv_sphere(6, 8))
    for key in ("inpaint_model_path", "zero123plus_path", "controlnet_path"):
        cfg = _cfg(tmp_path, shape, key, **{key: str(tmp_path / "nowhere")})
        with pytest.raises(FileNotFoundError, match=f"guide.{key}"):
            tr.build_models(cfg, tiny=True, device="cpu")
    cfg = _cfg(tmp_path, shape, "hub", diffusion_name="stabilityai/x",
               concept_path=str(tmp_path / "none.bin"))
    assert tr.sd_weight_paths(cfg.guide) is None
    assert tr.zero123plus_weight_paths(cfg.guide) is None
    _, teacher, _, diffusion, _ = tr.build_models(cfg, tiny=True,
                                                  device="cpu")
    assert teacher.loaded == {} and diffusion.loaded == {}
    assert diffusion.tokenizer.added_tokens == {}


def _quant_flags(teacher):
    """(UNet, ControlNet) -> the set of their layers' int8 flags."""
    return tuple({bool(getattr(m, "quant", False)) for m in tower.modules()
                  if hasattr(m, "quant")}
                 for tower in (teacher.unet, teacher.controlnet))


@pytest.mark.parametrize("knob", ["int8_controlnet", "int8_teacher"])
def test_int8_knobs_reach_the_teacher(tmp_path, knob, monkeypatch):
    """optim.int8_controlnet quantizes the ControlNet alone,
    optim.int8_teacher the UNet and the ControlNet, through build_models,
    ConTEXTure, SDSTrainer and the CLI; a knob that is off leaves (or
    puts) the towers exact. The edge layers stay exact either way."""
    shape = str(tmp_path / "sphere.obj")
    write_obj(shape, *uv_sphere(6, 8))
    cfg = _cfg(tmp_path, shape, knob)
    setattr(cfg.optim, knob, True)

    def check(teacher):
        unet, cnet = _quant_flags(teacher)
        assert unet == ({True, False} if knob == "int8_teacher" else {False})
        assert cnet == {True, False}
        for tower in (teacher.unet, teacher.controlnet):
            assert not tower.conv_in.quant
            assert not tower.time_embedding.linear_1.quant
            assert not tower.down_0_resnet_0.time_emb_proj.quant
        assert not teacher.controlnet.controlnet_mid_block.quant
        assert teacher.controlnet.down_0_resnet_0.conv1.quant

    _, teacher, mlp, _, mesh = tr.build_models(cfg, tiny=True, device="cpu",
                                               skip_bootstrap=True)
    check(teacher)
    check(tr.ConTEXTure(cfg, tiny_models=True, device="cpu").teacher)
    off = _cfg(tmp_path, shape, "off")
    setup = tr.prepare_sds(off, mesh, mlp, tr.apply_int8(off, teacher),
                           skip_bootstrap=True)
    assert _quant_flags(teacher) == ({False}, {False})
    check(tr.SDSTrainer(cfg, setup, teacher=teacher, mlp=mlp, tiny=True,
                        device="cpu").teacher)
    monkeypatch.setattr(tr.ConTEXTure, "full_eval", lambda self: None)
    run = run_contexture.main(
        [f"--guide.shape_path={shape}", f"--log.exp_root={tmp_path}",
         "--log.exp_name=cli", "--log.eval_only=true",
         "--guide.texture_resolution=16", "--render.train_grid_size=48",
         f"--optim.{knob}=true"], device="cpu", tiny_models=True)
    check(run.teacher)


# -- the boundary ---------------------------------------------------------------------------

NEW_MODULES = ("contexture_nerf_tpu_torch.diffusion.weights",
               "contexture_nerf_tpu_torch.tools.synth_snapshot",
               "contexture_nerf_tpu_torch.ops.quant",
               "contexture_nerf_tpu_torch.models.volume",
               "contexture_nerf_tpu_torch.tools.make_shapes",
               "contexture_nerf_tpu_torch.tools.semantic_smoke",
               "contexture_nerf_tpu_torch.generate_survey_textures",
               "contexture_nerf_tpu_torch.get_texture_renders_cond_grid",
               "contexture_nerf_tpu_torch.run_ablation_study")
FORBIDDEN = ("jax", "jaxlib", "flax", "contexture_nerf_tpu", "safetensors")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_modules_import_no_jax_and_no_safetensors(module):
    path = ROOT / (module.replace(".", "/") + ".py")
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            roots.add(node.module.split(".")[0])
    assert not roots & set(FORBIDDEN)
    code = (f"import sys, {module}; bad = [m for m in sys.modules if "
            f"m.split('.')[0] in {FORBIDDEN!r}]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr

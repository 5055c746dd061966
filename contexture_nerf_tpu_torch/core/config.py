"""Config schema: the port's own copy of contexture_nerf_tpu/core/config.py.

The dataclasses, their field names and defaults are the JAX package's
(tests/test_torch_diffusion.py asserts they are equal), so one config dict
drives both. `load_config` reads a YAML file and `--section.key value` or
`--section.key=value` overrides, as contexture_nerf_tpu/core/config.py's
does; `dump_config` writes the config back as YAML.

A section may also take keys of the port alone (`PORT_KEYS`: name -> its
allowed values, the default first): they are not dataclass fields, so the
field list stays the JAX package's. The loader sets them as instance
attributes, checked against their allowed values, and `config_to_dict`
writes one only where it differs from its default, so a config that sets
none gives the JAX package's dict.
The one such key is `guide.teacher`: "zero123plus" (the default) or
"sv3d_p" (the SDS loop over SV3D_p's 21-frame orbit,
training/orbit.py).
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field, fields, is_dataclass
from pathlib import Path
from typing import Any, ClassVar, Dict, List, Optional, Tuple, get_type_hints


@dataclass
class RenderConfig:
    """Parameters for the mesh renderer (reference: train_config.py:7-31)."""

    # Grid size for rendering during painting
    train_grid_size: int = 1200
    # Grid size of evaluation
    eval_grid_size: int = 1024
    # training camera radius range
    radius: float = 1.5
    # Set [0, overhead_range] as the overhead region
    overhead_range: float = 40
    # Define the front angle region
    front_range: float = 70
    # The front offset, use to rotate shape from code
    front_offset: float = 0.0
    # Number of views to use
    n_views: int = 8
    # Theta value for rendering during training
    base_theta: float = 60
    # Additional views to use before rotating around shape
    views_before: List[Tuple[float, float]] = field(default_factory=list)
    # Additional views to use after rotating around shape
    views_after: List[Tuple[float, float]] = field(
        default_factory=lambda: [[180, 30], [180, 150]]
    )
    # Whether to alternate between the rotating views from the different sides
    alternate_views: bool = True


@dataclass
class GuideConfig:
    """Parameters defining the guidance (reference: train_config.py:34-81)."""

    # Guiding text prompt
    text: str = ""
    # The mesh to paint
    shape_path: str = "shapes/spot_triangulated.obj"
    # Append direction to text prompts
    append_direction: bool = False
    # A Textual-Inversion concept to use
    concept_name: Optional[str] = None
    # Path to the TI embedding
    concept_path: Optional[Path] = None
    # A huggingface diffusion model to use
    diffusion_name: str = "stabilityai/stable-diffusion-2-depth"

    second_model_type: Optional[str] = None
    individual_control_of_conditions: bool = False
    guidance_scale_i: Optional[int] = None
    guidance_scale_t: Optional[int] = None

    use_zero123plus: Optional[bool] = True

    guess_mode: Optional[bool] = False
    # Scale of mesh in 1x1x1 cube
    shape_scale: float = 0.6
    # height of mesh
    dy: float = 0.25
    # texture image resolution
    texture_resolution: int = 1024
    # texture mapping interpolation: 'nearest', 'bilinear', 'bicubic'
    texture_interpolation_mode: str = "bilinear"
    # Guidance scale for score distillation
    guidance_scale: float = 7.5
    # Use inpainting in relevant iterations
    use_inpainting: bool = True
    # The texture before editing
    reference_texture: Optional[Path] = None
    # The edited texture
    initial_texture: Optional[Path] = None
    # Whether to use background color or image
    use_background_color: bool = False
    # Background image to use
    background_img: str = "textures/brick_wall.png"
    # Threshold for defining refine regions
    z_update_thr: float = 0.2
    # Some more strict masking for projecting back
    strict_projection: bool = True
    # local checkpoint snapshot roots (diffusers layout); random init if None
    inpaint_model_path: Optional[str] = None
    zero123plus_path: Optional[str] = None
    controlnet_path: Optional[str] = None
    # keys of the port alone (module docstring): the SDS teacher
    PORT_KEYS: ClassVar[Dict[str, Tuple[str, ...]]] = {
        "teacher": ("zero123plus", "sv3d_p")}
    teacher: ClassVar[str] = "zero123plus"


@dataclass
class OptimConfig:
    """Parameters for the optimization process (reference: train_config.py:84-100).
    Field names and defaults are those of the JAX package; see its config
    for what each knob does there."""

    seed: int = 0
    lr: float = 1e-2
    min_timestep: float = 0.02
    max_timestep: float = 0.98
    no_noise: bool = False
    learn_max_z_normals: bool = True
    alpha: float = -100
    # SDS loop length and its Adam hyperparameters
    sds_iterations: int = 5000
    sds_lr: float = 1e-5
    sds_betas: Tuple[float, float] = (0.9, 0.99)
    sds_eps: float = 1e-15
    resume: bool = False
    checkpoint_interval: int = 1000
    # SDS tile sampling over the 6 grid tiles: uniform | mixed | weighted
    tile_weighting: str = "uniform"
    # evaluate the MLP on a precomputed Fourier embedding of the static UVs
    precompute_uv_embedding: bool = True
    # reference-exact lattice render; needs the raster cache (next slice)
    exact_lattice_render: bool = False
    # multi-device options of the JAX package; the port runs one device
    data_parallel: str = "auto"
    tensor_parallel: int = 1
    sequence_parallel: int = 1
    int8_controlnet: bool = False
    int8_teacher: bool = False
    # gradient through a margin-padded slice around the sampled tile only
    local_sds_grad: bool = True
    # margin in pixels, a multiple of the VAE downsample factor
    local_sds_margin_px: int = 64


@dataclass
class LogConfig:
    """Parameters for logging and saving (reference: train_config.py:102-124)."""

    # Experiment name
    exp_name: str = "default_exp"
    # Experiment output dir
    exp_root: Path = Path("experiments/")
    # Run only test
    eval_only: bool = False
    # Number of angles to sample for eval during training
    eval_size: int = 10
    # Number of angles to sample for eval after training
    full_eval_size: int = 100
    # Export a mesh
    save_mesh: bool = True
    # Whether to show intermediate diffusion visualizations
    vis_diffusion_steps: bool = False
    # Whether to log intermediate images
    log_images: bool = True
    # write log images from a background thread
    async_image_writer: bool = True

    @property
    def exp_dir(self) -> Path:
        return Path(self.exp_root) / self.exp_name


@dataclass
class TrainConfig:
    """The main configuration for the trainer (reference: train_config.py:127-133)."""

    log: LogConfig = field(default_factory=LogConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    guide: GuideConfig = field(default_factory=GuideConfig)


# ----------------------------------------------------------------------------
# pyrallis-compatible loading
# ----------------------------------------------------------------------------

_PATH_FIELDS = {"exp_root", "concept_path", "reference_texture", "initial_texture"}


def _coerce(value: Any, ftype: Any, name: str) -> Any:
    if value is None:
        return None
    if name in _PATH_FIELDS:
        return Path(value)
    origin = getattr(ftype, "__origin__", None)
    if ftype in (int,):
        return int(value)
    if ftype in (float,):
        return float(value)
    if ftype in (bool,):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if ftype in (str,):
        return str(value)
    if origin in (list, List):
        return list(value)
    if origin in (tuple, Tuple):
        return tuple(value)
    return value


def _build_dataclass(cls, data: dict, section: str = "",
                     unknown: Optional[list] = None):
    kwargs = {}
    port_keys = getattr(cls, "PORT_KEYS", {})
    names = {f.name for f in fields(cls)} | set(port_keys)
    if unknown is not None:
        unknown.extend(f"{section}.{k}" for k in data if k not in names)
    # the annotations resolved: under `from __future__ import annotations`
    # f.type is a string, and a value like "1e-05" (which PyYAML reads as a
    # string: YAML 1.1 floats need a dot) would reach the config uncoerced
    hints = get_type_hints(cls)
    for f in fields(cls):
        if f.name in data:
            v = data[f.name]
            ftype = hints[f.name]
            # Optional[X] -> X
            args = getattr(ftype, "__args__", None)
            if args and type(None) in args:
                non_none = [a for a in args if a is not type(None)]
                ftype = non_none[0] if non_none else Any
            kwargs[f.name] = _coerce(v, ftype, f.name)
    obj = cls(**kwargs)
    for key in port_keys:
        if key in data:
            set_port_key(obj, key, data[key])
    return obj


def set_port_key(section, key: str, value) -> None:
    """Set a port-only key of a config section; a value outside its
    `PORT_KEYS` choices raises."""
    choices = type(section).PORT_KEYS[key]
    if value not in choices:
        raise ValueError(f"{key}: {value!r} is not one of {choices}")
    setattr(section, key, value)


def config_from_dict(data: dict, strict: bool = False) -> TrainConfig:
    """Build a TrainConfig. Unknown keys are warned-and-ignored by default
    (strict=True raises) — the reference's pyrallis hard-rejects them, which
    makes its own shipped mickey.yaml/beachball.yaml unrunnable (stale
    guidance_scale_crossattn/concat/control keys, SURVEY.md §5 gotcha); the
    warning keeps those mirrors runnable while still surfacing typos."""
    import logging

    sections = {
        "log": LogConfig,
        "render": RenderConfig,
        "optim": OptimConfig,
        "guide": GuideConfig,
    }
    unknown: list = [k for k in data if k not in sections]
    built = {}
    for key, cls in sections.items():
        built[key] = _build_dataclass(cls, data.get(key, {}) or {},
                                      section=key, unknown=unknown)
    if unknown:
        msg = (f"unknown config keys ignored: {', '.join(unknown)} "
               "(the reference's pyrallis would reject these)")
        if strict:
            raise ValueError(msg)
        logging.getLogger("contexture_nerf_tpu_torch").warning(msg)
    return TrainConfig(**built)


def config_to_dict(cfg: TrainConfig) -> dict:
    def enc(obj):
        if is_dataclass(obj):
            out = {f.name: enc(getattr(obj, f.name)) for f in fields(obj)}
            for key, choices in getattr(obj, "PORT_KEYS", {}).items():
                if getattr(obj, key) != choices[0]:
                    out[key] = enc(getattr(obj, key))
            return out
        if isinstance(obj, Path):
            return str(obj)
        if isinstance(obj, tuple):
            return list(obj)
        if isinstance(obj, list):
            return [enc(x) for x in obj]
        return obj

    return enc(cfg)



def dump_config(cfg: TrainConfig, path: Path) -> None:
    import yaml

    Path(path).write_text(yaml.safe_dump(config_to_dict(cfg), sort_keys=False))


def _parse_cli_value(raw: str) -> Any:
    import yaml

    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def load_config(argv: Optional[List[str]] = None) -> TrainConfig:
    """pyrallis-style entry: --config_path=... plus --section.key overrides."""
    import yaml

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--config_path", type=str, default=None)
    known, rest = parser.parse_known_args(argv)

    data: dict = {}
    if known.config_path:
        data = yaml.safe_load(Path(known.config_path).read_text()) or {}

    # CLI overrides: --log.exp_name value  |  --log.exp_name=value
    i = 0
    while i < len(rest):
        tok = rest[i]
        if not tok.startswith("--"):
            i += 1
            continue
        tok = tok[2:]
        if "=" in tok:
            key, val = tok.split("=", 1)
            i += 1
        else:
            key = tok
            val = rest[i + 1] if i + 1 < len(rest) else "true"
            i += 2
        parts = key.split(".")
        node = data
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_cli_value(val)

    return config_from_dict(data)

"""Pieces the traffic drivers share: the program's config from a cell's
configuration file, the geometry of the six views (made once a process),
the reference's towers with the weights remade from the seed, and the
leaf-by-leaf comparison of norms."""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench import weights as W
from portbench.reference import geometry as geo
from portbench.reference import towers as rt

_GEOMETRY: Dict[tuple, dict] = {}


def tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def unet_config(cell, tiny: bool):
    return rt.UNetConfig.tiny() if tiny else rt.UNetConfig(
        **tuples(cell.config["unet"]))


def vae_config(cell, tiny: bool):
    return rt.VAEConfig.tiny() if tiny else rt.VAEConfig(
        **tuples(cell.config["vae"]))


def train_config(cell, tiny: bool, control: bool):
    """The program's TrainConfig: the configuration's `train_config`, its
    `control` overrides with `control`, the shape's path in the checkout."""
    from contexture_nerf_tpu_torch.core.config import config_from_dict

    data = {k: dict(v) for k, v in cell.config["train_config"].items()}
    guide = data.setdefault("guide", {})
    guide["shape_path"] = str(cell.dir.parent / guide["shape_path"])
    if tiny:
        guide["texture_resolution"] = 64
    if control:
        for sec, vals in cell.config["control"].items():
            data.setdefault(sec, {}).update(vals)
    return config_from_dict(data, strict=True)


def check_unet(cell, unet_config) -> None:
    """The program runs the UNet the configuration states."""
    for k, v in cell.config["unet"].items():
        got = getattr(unet_config, k)
        if (list(got) if isinstance(got, tuple) else got) != v:
            raise ValueError(f"the program's UNet {k} = {got}, the "
                             f"configuration states {v}")


def geometry(cfg, tile_px: int, render_px: int, device, views: bool):
    """The six views' grids (and with `views` their maps and boxes)."""
    key = (cfg.guide.shape_path, tile_px, render_px, str(device), views)
    if key not in _GEOMETRY:
        g = geo.six_views(cfg.guide.shape_path, render_px, tile_px,
                          cfg.guide.shape_scale, cfg.guide.dy,
                          cfg.render.radius, device)
        if not views:
            g["cache"] = g["bboxes6"] = None
        _GEOMETRY[key] = g
    return _GEOMETRY[key]


def install_towers(owner, names, seed, device, dtype) -> Dict[str, list]:
    """Seeded weights into the program's towers `owner.<name>`; returns each
    tower's leaves."""
    specs = {t: W.spec(getattr(owner, t)) for t in names}
    for t in names:
        W.install(getattr(owner, t), W.make_tower(specs[t], seed, t, device,
                                                  dtype))
    return specs


def reference_towers(torch, modules: Dict[str, object], specs, seed, device,
                     served) -> Dict[str, object]:
    """The reference's modules (built on the meta device) in f32, with the
    weights remade from the seed in the served dtype: the same values as
    the program's."""
    for name, mod in modules.items():
        if W.spec(mod) != specs[name]:
            raise ValueError(f"the reference's {name} has other leaves than "
                             "the program's")
        W.install(mod, W.make_tower(specs[name], seed, name, device, served),
                  dtype=torch.float32)
    return modules


def _norm(t) -> float:
    return float(t.double().norm())


def leaf_gaps(prog: dict, refr: dict, keep: Optional[set] = None) -> dict:
    """Each leaf's |‖prog‖ - ‖ref‖| over the larger of the reference leaf's
    norm and the median leaf's."""
    names: List[str] = [n for n in refr if keep is None or n in keep]
    ref_norms = {n: _norm(refr[n]) for n in names}
    med = sorted(ref_norms.values())[len(names) // 2]
    return {n: abs(_norm(prog[n]) - ref_norms[n]) / max(ref_norms[n], med)
            for n in names}



def moved_leaves(grads: dict, floor: float = 1e-3) -> set:
    """Leaves whose reference gradient is at least `floor` of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {n: _norm(v) for n, v in grads.items()}
    med = sorted(norms.values())[len(norms) // 2]
    return {n for n, v in norms.items() if v >= floor * med}


class Phases:
    """Host seconds of set-up's phases, the device synchronised at each
    phase's end: `clock(name)` closes the phase that ran since the last
    call."""

    def __init__(self, torch, device):
        import time

        self.torch, self.device, self.time = torch, device, time
        self.t = time.perf_counter()
        self.times: Dict[str, float] = {}

    def __call__(self, name: str) -> None:
        sync(self.torch, self.device)
        now = self.time.perf_counter()
        self.times[name] = now - self.t
        self.t = now


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()

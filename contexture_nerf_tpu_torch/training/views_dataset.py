"""Camera poses: the port's counterparts of
contexture_nerf_tpu/training/views_dataset.py `rand_poses`,
`rand_modal_poses`, `circle_pose`, `Zero123PlusDataset`,
`MultiviewDataset` and `ViewsDataset` (the eval turntable), and the
port's `OrbitDataset` (SV3D_p's orbit). Poses are a
handful of host floats read once at setup; each is a dict {dir, theta,
phi, radius, base_theta}, angles in radians. Random poses come from a
numpy generator.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from contexture_nerf_tpu_torch.ops.image import get_view_direction


def rand_poses(size: int, rng: np.random.Generator,
               radius_range=(1.0, 1.5), phi_range=(0.0, 360.0),
               angle_overhead=30.0, angle_front=60.0,
               biased_angles=True) -> Dict:
    """One random pose; theta biased to the top (70%: above the equator).
    `size` is the number of draws per call, of which the first is
    returned."""
    angle_overhead_r = np.deg2rad(angle_overhead)
    angle_front_r = np.deg2rad(angle_front)
    radius = rng.uniform(radius_range[0], radius_range[1], size)
    phi_r = np.deg2rad(rng.uniform(phi_range[0], phi_range[1], size))
    if biased_angles:
        top_flag = rng.random() > 0.3
        x = (1 - rng.random(size)) if top_flag else (-rng.random(size))
        thetas = np.arccos(x)
    else:
        thetas = np.deg2rad(rng.uniform(0.0, 180.0, size))
    dirs = get_view_direction(thetas, phi_r, angle_overhead_r, angle_front_r)
    return {"dir": int(dirs[0]), "theta": float(thetas[0]),
            "phi": float(phi_r[0]), "radius": float(radius[0])}


def rand_modal_poses(size: int, rng: np.random.Generator,
                     radius_range=(1.4, 1.6), theta_range=(45.0, 90.0),
                     phi_range=(0.0, 360.0), angle_overhead=30.0,
                     theta_range_overhead=(0.0, 20.0),
                     angle_front=60.0) -> Dict:
    """One random pose near the four cardinal azimuths (within 15 degrees),
    or, 15% of the time, an overhead pose."""
    angle_overhead_r = np.deg2rad(angle_overhead)
    angle_front_r = np.deg2rad(angle_front)
    radius = rng.uniform(radius_range[0], radius_range[1], size)
    if rng.random() > 0.85:
        phis = np.deg2rad(rng.uniform(phi_range[0], phi_range[1], size))
        thetas = np.deg2rad(rng.uniform(theta_range_overhead[0],
                                        theta_range_overhead[1], size))
    else:
        mods = np.deg2rad([0, 90, 180, 270])
        perturb = np.deg2rad(15) * rng.random(size)
        phis = perturb + mods[rng.integers(0, 4, size)]
        thetas = np.deg2rad(rng.uniform(theta_range[0], theta_range[1], size))
    dirs = get_view_direction(thetas, phis, angle_overhead_r, angle_front_r)
    return {"dir": int(dirs[0]), "theta": float(thetas[0]),
            "phi": float(phis[0]), "radius": float(radius[0])}


def circle_pose(radius=1.25, theta=60.0, phi=0.0, angle_overhead=30.0,
                angle_front=60.0) -> Dict:
    """One pose on a circle, angles given in degrees."""
    theta_r = np.deg2rad(theta)
    phi_r = np.deg2rad(phi)
    dirs = get_view_direction(np.array([theta_r]), np.array([phi_r]),
                              np.deg2rad(angle_overhead),
                              np.deg2rad(angle_front))
    return {"dir": int(dirs[0]), "theta": float(theta_r),
            "phi": float(phi_r), "radius": float(radius)}


class Zero123PlusDataset:
    """The 7 fixed poses: the front view, then the 6 Zero123++ target views
    at azimuths {30, 150, 270, 90, 210, 330} relative to the front and
    elevations {30, 30, 30, -20, -20, -20} (polar theta = 90 - elevation)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.phis = [0] + [30, 150, 270, 90, 210, 330]
        thetas_abs = [30] + [30, 30, 30, -20, -20, -20]
        self.thetas = [90 - t for t in thetas_abs]
        self.size = len(self.phis)

    def __len__(self) -> int:
        return self.size

    def poses(self) -> List[Dict]:
        out = []
        for theta, phi in zip(self.thetas, self.phis):
            d = circle_pose(radius=self.cfg.radius, theta=theta, phi=phi,
                            angle_overhead=self.cfg.overhead_range,
                            angle_front=self.cfg.front_range)
            d["base_theta"] = math.radians(self.cfg.base_theta)
            out.append(d)
        return out

    def __iter__(self):
        return iter(self.poses())


class OrbitDataset:
    """The orbit of a video teacher (SV3D_p): `frames` poses at one
    elevation (10 degrees by default), azimuths 360 k / frames for
    k = 1..frames (the last at 0, the front), as simple_video_sample.py
    sets them for sv3d_p; radius render.radius."""

    def __init__(self, cfg, frames: int = 21, elevation_deg: float = 10.0):
        self.cfg = cfg
        self.phis = [float(a) for a in
                     np.linspace(0, 360, frames + 1)[1:] % 360]
        self.thetas = [90.0 - elevation_deg] * frames
        self.size = frames

    def __len__(self) -> int:
        return self.size

    def poses(self) -> List[Dict]:
        return [circle_pose(radius=self.cfg.radius, theta=theta, phi=phi,
                            angle_overhead=self.cfg.overhead_range,
                            angle_front=self.cfg.front_range)
                for theta, phi in zip(self.thetas, self.phis)]

    def __iter__(self):
        return iter(self.poses())


class MultiviewDataset:
    """n_views poses on a ring at base_theta, in alternating order when
    render.alternate_views, with views_before and views_after around them."""

    def __init__(self, cfg):
        self.cfg = cfg
        size = cfg.n_views
        self.phis = [(i / size) * 360 for i in range(size)]
        self.thetas = [cfg.base_theta for _ in range(size)]

        def alternate(vals):
            return ([vals[0]]
                    + [x for pair in zip(vals[1:size // 2],
                                         vals[-1:size // 2:-1])
                       for x in pair]
                    + [vals[size // 2]])

        if cfg.alternate_views:
            self.phis = alternate(self.phis)
            self.thetas = alternate(self.thetas)
        for phi, theta in cfg.views_before:
            self.phis = [phi] + self.phis
            self.thetas = [theta] + self.thetas
        for phi, theta in cfg.views_after:
            self.phis = self.phis + [phi]
            self.thetas = self.thetas + [theta]
        self.size = len(self.phis)

    def __len__(self) -> int:
        return self.size

    def poses(self) -> List[Dict]:
        out = []
        for theta, phi in zip(self.thetas, self.phis):
            d = circle_pose(radius=self.cfg.radius, theta=theta, phi=phi,
                            angle_overhead=self.cfg.overhead_range,
                            angle_front=self.cfg.front_range)
            d["base_theta"] = math.radians(self.cfg.base_theta)
            out.append(d)
        return out

    def __iter__(self):
        return iter(self.poses())


class ViewsDataset:
    """The eval turntable: `size` poses at radius render.radius * 1.2 and
    theta base_theta, phi evenly over 360 degrees; random_views=True draws
    `rand_poses` from a numpy generator seeded with `seed` instead."""

    def __init__(self, cfg, size: int = 100, random_views: bool = False,
                 seed: int = 0):
        self.cfg = cfg
        self.size = size
        self.random_views = random_views
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.size

    def poses(self) -> List[Dict]:
        out = []
        for i in range(self.size):
            if self.random_views:
                d = rand_poses(1, self._rng)
            else:
                phi = (i / self.size) * 360
                d = circle_pose(radius=self.cfg.radius * 1.2,
                                theta=self.cfg.base_theta, phi=phi,
                                angle_overhead=self.cfg.overhead_range,
                                angle_front=self.cfg.front_range)
            d["base_theta"] = math.radians(self.cfg.base_theta)
            out.append(d)
        return out

    def __iter__(self):
        return iter(self.poses())

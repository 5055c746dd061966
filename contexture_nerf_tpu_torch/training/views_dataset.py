"""Camera poses of the Zero123++ paint path: the port's counterparts of
contexture_nerf_tpu/training/views_dataset.py `circle_pose` and
`Zero123PlusDataset`. Poses are a handful of host floats read once at
setup; each is a dict {dir, theta, phi, radius, base_theta}, angles in
radians.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from contexture_nerf_tpu_torch.ops.image import get_view_direction


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

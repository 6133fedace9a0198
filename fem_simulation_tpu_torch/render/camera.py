"""LookAt camera with rotate / pan / zoom and ray unprojection.

Port of `fem_simulation_tpu/render/camera.py` (numpy only, no GL): the
matrices feed the headless renderer and the pick ray feeds `sim.picking`.
"""
from __future__ import annotations

import numpy as np


def _normalize(v):
    return v / (np.linalg.norm(v) + 1e-12)


class Camera:
    def __init__(self, position=(0.0, 0.5, 3.0), target=(0.0, 0.0, 0.0),
                 up=(0.0, 1.0, 0.0), fov_deg=45.0, aspect=1.0,
                 near=0.01, far=100.0):
        self.position = np.asarray(position, dtype=np.float64)
        self.target = np.asarray(target, dtype=np.float64)
        self.up = _normalize(np.asarray(up, dtype=np.float64))
        self.fov_deg = fov_deg
        self.aspect = aspect
        self.near = near
        self.far = far

    # -- matrices -----------------------------------------------------------
    def view(self) -> np.ndarray:
        f = _normalize(self.target - self.position)
        s = _normalize(np.cross(f, self.up))
        u = np.cross(s, f)
        m = np.eye(4)
        m[0, :3], m[1, :3], m[2, :3] = s, u, -f
        m[:3, 3] = -m[:3, :3] @ self.position
        return m

    def proj(self) -> np.ndarray:
        t = 1.0 / np.tan(np.radians(self.fov_deg) / 2)
        m = np.zeros((4, 4))
        m[0, 0] = t / self.aspect
        m[1, 1] = t
        m[2, 2] = (self.far + self.near) / (self.near - self.far)
        m[2, 3] = 2 * self.far * self.near / (self.near - self.far)
        m[3, 2] = -1.0
        return m

    # -- interaction: rotate / pan / zoom -------------------------------------
    def rotate(self, d_yaw: float, d_pitch: float):
        """Orbit around the target (radians)."""
        off = self.position - self.target
        r = np.linalg.norm(off)
        yaw = np.arctan2(off[0], off[2]) + d_yaw
        pitch = np.clip(np.arcsin(off[1] / (r + 1e-12)) + d_pitch,
                        -1.55, 1.55)
        self.position = self.target + r * np.array([
            np.cos(pitch) * np.sin(yaw), np.sin(pitch),
            np.cos(pitch) * np.cos(yaw)])

    def pan(self, dx: float, dy: float):
        f = _normalize(self.target - self.position)
        s = _normalize(np.cross(f, self.up))
        u = np.cross(s, f)
        d = -dx * s + dy * u
        self.position += d
        self.target += d

    def zoom(self, amount: float):
        f = _normalize(self.target - self.position)
        self.position += amount * f

    # -- picking ray ----------------------------------------------------------
    def unproject(self, sx: float, sy: float, width: int, height: int):
        """Screen pixel -> (origin, direction) world ray."""
        ndc = np.array([2 * sx / width - 1, 1 - 2 * sy / height, -1.0, 1.0])
        inv = np.linalg.inv(self.proj() @ self.view())
        p_near = inv @ ndc
        p_near = p_near[:3] / p_near[3]
        ndc[2] = 1.0
        p_far = inv @ ndc
        p_far = p_far[:3] / p_far[3]
        return self.position.copy(), _normalize(p_far - p_near)

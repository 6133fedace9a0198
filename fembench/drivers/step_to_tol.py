"""Frames: episodes of implicit-Euler frames through the program's
`fem_simulation_tpu_torch.sim.lattice.step_to_tol` on a `LatticeScene`.

A request is one frame. An episode's first frame starts the body from rest
(the benchmark's own rest positions on the lattice) with an initial velocity
of v0_scale * N(0, 1) at every real vertex, drawn on the card from a
torch.Generator seeded with the episode's seed (as the program's
models/train_solver.initial_velocity draws it); each later frame steps the
state the last one returned. Gravity is constant, no vertex is dragged.

The answer kept for the judge is the frame's input positions, the positions
it returned and what the reference needs for the input's velocity: the
episode's v0 on its first frame, else the positions before the input
(v_in = (x_in - x_before) / dt, as the implicit step defines it), so the
reference takes no velocity from the program.
"""
from __future__ import annotations

import torch

from fembench import program
from fembench.geometry import Geometry
from fembench.reference import Model, inf_norm


class System:
    """The program serving a mix's frames."""

    def __init__(self, body: dict, geo: Geometry, config: dict, mix: dict,
                 device):
        from fem_simulation_tpu_torch.config import DynamicsConfig
        from fem_simulation_tpu_torch.sim import lattice
        self.step = lattice.step_to_tol
        self.LatState = lattice.LatState
        self.scene = program.lattice_scene(body, config, device)
        self.dyn = DynamicsConfig(dt=float(config["dynamics"]["dt"]),
                                  damping=float(config["dynamics"]["damping"]))
        self.mix = mix
        self.device = self.scene.device
        self.x_rest = program.field(geo.rest_lattice(), self.device)
        self.real3 = program.field(geo.real_lattice(), self.device)[..., None]
        self.zeros = torch.zeros(geo.shape, device=self.device)
        self.gen = torch.Generator(device=self.device)
        self.st, self.x_before = None, None

    def warm(self):
        """The shapes a frame can use beyond the mix's first frames: the
        energy of the rescue's line search."""
        self.scene.total_energy(self.x_rest)

    def serve(self, req):
        """One frame. Returns (Newton iterations, exit norm, answer)."""
        m = self.mix
        v0 = None
        if req.step == 0:
            self.gen.manual_seed(req.seed)
            v0 = float(m["v0_scale"]) * torch.randn(
                self.x_rest.shape, generator=self.gen,
                device=self.device) * self.real3
            st = self.LatState(x=self.x_rest, v=v0, drag_mask=self.zeros,
                               drag_pos=self.x_rest)
            before = None
        else:
            st, before = self.st, self.x_before
        out, k, fn = self.step(self.scene, st, self.dyn, float(m["tol"]),
                               int(m["max_newton"]), int(m["cg_iterations"]),
                               float(m["cg_tol"]),
                               gravity_scale=float(m["gravity_scale"]))
        self.st, self.x_before = out, st.x
        answer = {"x_in": st.x, "x_out": out.x, "v0": v0,
                  "x_before": before if req.step > 0 else None}
        return int(k), float(fn), answer


def judge(model: Model, answer: dict, config: dict, mix: dict) -> float:
    """||f||inf of the frame's implicit-Euler residual at its answer, as the
    reference computes it from the frame's input."""
    dt = float(config["dynamics"]["dt"])
    damping = float(config["dynamics"]["damping"])
    xi = model.gather(answer["x_in"])
    if answer["v0"] is not None:
        vi = model.gather(answer["v0"])
    else:
        vi = (xi - model.gather(answer["x_before"])) / dt
    x_tilde = xi + dt * (damping * vi)
    f = model.residual(model.gather(answer["x_out"]), x_tilde, 1.0 / dt,
                       float(mix["gravity_scale"]))
    return inf_norm(f)


def reference_step(model: Model):
    """step_to_tol's call, served by the reference's Newton solver in
    `model`'s precision: the control put in the program's place."""
    def step(scene, st, dyn, tol, max_newton, cg_iterations, cg_tol,
             gravity_scale=1.0):
        xi, vi = model.gather(st.x), model.gather(st.v)
        x_tilde = xi + dyn.dt * (dyn.damping * vi)
        x, k, fn = model.newton(x_tilde, x_tilde, 1.0 / dyn.dt, gravity_scale,
                                tol, max_newton, cg_iterations, cg_tol)
        x_lat = model.scatter(x, st.x)
        return st._replace(x=x_lat, v=(x_lat - st.x) / dyn.dt), k, fn
    return step

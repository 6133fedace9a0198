"""Diagnose the exp3 one-shot residual gap: why a small training MSE sits
beside a one-shot prediction residual orders above the solver's.

Port of `examples/exp3_diagnose.py`. On a held-out frame (3 solver frames
from rest, then the 4th frame's prediction problem):

* per-vertex position error |pred - x*| against per-vertex residual
  |f(pred)|, split pins / free vertices;
* the residual split into elastic + gravity, inertia and pin-penalty parts;
* the implied amplification ||f|| / ||dx|| against the dynamic Hessian's
  diagonal scale.

Writes results/exp3_diagnosis<tag>_torch.md and a scatter PNG (or
<--out>.md / .png); run after
exp3_scale_run:

    python -m fem_simulation_tpu_torch.examples.exp3_diagnose [--net results/exp3_scale_torch_net.npz]
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import DynamicsConfig, TrainSolverConfig
from ..models.train_solver import SolverNetTrainer
from ..ops import elastic
from ..sim import dynamic
from ..utils.viz import to_numpy
from ._common import RESULTS, beam_scene, beam_shape, out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--net", default=os.path.join(RESULTS,
                                                  "exp3_scale_torch_net.npz"))
    ap.add_argument("--beam", default="16,16,72")
    ap.add_argument("--multilevel", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--out", default=None,
                    help="output prefix (default: "
                         "results/exp3_diagnosis<tag>_torch)")
    args = ap.parse_args(argv)

    scene = beam_scene(beam_shape(args.beam), device=args.device)
    n = scene.level(0).n_verts
    tr = SolverNetTrainer(scene, TrainSolverConfig(),
                          multilevel=args.multilevel, predict_delta=True)
    tr.load(args.net)
    dyn = DynamicsConfig()
    inv_dt = 1.0 / dyn.dt
    p0 = scene.params["levels"][0]
    mat = scene.material

    def step(s):
        return dynamic.step_to_tol(scene, scene.params, s, tol=1e-4,
                                   max_newton=10)

    st = dynamic.init_state(scene)
    for _ in range(3):
        st, _, _ = step(st)
    x_tilde = st.x + st.v * dyn.damping * dyn.dt
    x_star = step(st)[0].x                  # the true next state

    with torch.no_grad():
        pred = tr._forward(x_tilde)
        dx = to_numpy(torch.linalg.vector_norm(pred - x_star, dim=-1))
        f = dynamic._dyn_force(scene, scene.params, st, pred, x_tilde, inv_dt)
        fmag = to_numpy(torch.linalg.vector_norm(f, dim=-1))
        f_el = (elastic.force(pred, p0["hexes"], p0["det"], p0["g"],
                              mat.lame_mu, mat.lame_la, n)
                + elastic.gravity_force(p0["mass"], mat.gravity, n,
                                        pred.dtype))
        f_pin = elastic.pin_force(pred, p0["pin_mask"], p0["pin_pos"],
                                  mat.control_mag)
        f_in = elastic.inertia_force(pred, x_tilde, p0["mass"], inv_dt)
    pins = to_numpy(p0["pin_mask"]) > 0
    mass = to_numpy(p0["mass"])

    def s(v):
        return float(np.abs(to_numpy(v)).max())

    lines = [f"# exp3 one-shot residual gap: diagnosis ({n} verts, "
             f"{scene.device})\n",
             f"prediction position error: RMS "
             f"{float(np.sqrt((dx ** 2).mean())):.3e}, max {dx.max():.3e}",
             f"residual |f|_inf at prediction: {s(f):.3e}",
             f"  elastic+gravity component |.|_inf: {s(f_el):.3e}",
             f"  inertia (m/dt^2) component |.|_inf: {s(f_in):.3e} "
             f"(m/dt^2 = {mass.max() * inv_dt ** 2:.1f} max)",
             f"  pin-penalty component |.|_inf:     {s(f_pin):.3e} "
             f"(control_mag = {mat.control_mag})",
             f"residual split: pins max {fmag[pins].max():.3e} "
             f"(mean {fmag[pins].mean():.3e}), free max "
             f"{fmag[~pins].max():.3e} (mean {fmag[~pins].mean():.3e})",
             f"position-error split: pins max {dx[pins].max():.3e}, "
             f"free max {dx[~pins].max():.3e}"]
    amp = fmag.max() / max(dx.max(), 1e-30)
    lines.append(f"\nimplied amplification |f| / |dx| ~ {amp:.1f}; the "
                 f"dynamic Hessian's diagonal scale is control_mag + "
                 f"m/dt^2 + elastic ~ "
                 f"{mat.control_mag + mass.max() * inv_dt ** 2:.0f} at "
                 f"pins: the MSE and the residual differ by the Hessian's "
                 f"norm. The loss that targets the residual directly is "
                 f"TrainSolverConfig.loss='residual'.")
    md = "\n".join(lines) + "\n"
    out_md = out_path(args.out, f"exp3_diagnosis{args.tag}_torch") + ".md"
    with open(out_md, "w") as fh:
        fh.write(md)
    print(md, flush=True)

    from ..utils.viz import _pyplot
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.loglog(dx[~pins], fmag[~pins], ".", ms=2, alpha=0.3, label="free")
    ax.loglog(dx[pins], fmag[pins], ".", ms=3, alpha=0.5, color="C3",
              label="pinned")
    ax.set_xlabel("|pred - x*| per vertex")
    ax.set_ylabel("|f(pred)| per vertex")
    ax.legend()
    ax.set_title("exp3: position error vs residual")
    fig.tight_layout()
    png = out_md[:-len(".md")] + ".png"
    fig.savefig(png, dpi=120)
    plt.close(fig)
    print(f"wrote {out_md}, {png}")
    return md


if __name__ == "__main__":
    main()

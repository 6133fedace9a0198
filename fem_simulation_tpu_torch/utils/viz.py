"""Headless visualization: surface rendering to PNG / GIF, convergence plots.

Port of `fem_simulation_tpu/utils/viz.py`, on matplotlib's Agg backend.
Positions and series may be tensors on any device or numpy arrays; they
are read back to numpy at the boundary (`to_numpy`).
"""
from __future__ import annotations

import numpy as np
import torch


def to_numpy(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _tri_shade(x, tris, light=(0.4, 0.8, 0.45)):
    """Flat shading: two-tone diffuse."""
    v0, v1, v2 = x[tris[:, 0]], x[tris[:, 1]], x[tris[:, 2]]
    n = np.cross(v1 - v0, v2 - v0)
    nn = n / (np.linalg.norm(n, axis=1, keepdims=True) + 1e-12)
    light = np.asarray(light) / np.linalg.norm(light)
    lam = np.abs(nn @ light)
    return 0.25 + 0.7 * lam


def _limits(ax, lo, hi):
    c = (lo + hi) / 2
    r = (hi - lo).max() / 2 * 1.1
    ax.set_xlim(c[0] - r, c[0] + r)
    ax.set_ylim(c[1] - r, c[1] + r)
    ax.set_zlim(c[2] - r, c[2] + r)


def _colors(x, tris):
    shade = _tri_shade(x, tris)
    return np.clip(np.outer(shade, np.array([0.55, 0.65, 0.9])), 0, 1)


def render_surface(x_mesh_order, tris: np.ndarray, path: str,
                   elev: float = 15.0, azim: float = -60.0, title: str = ""):
    """Render the surface mesh to a PNG file."""
    plt = _pyplot()
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    x = to_numpy(x_mesh_order)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    ax.add_collection3d(Poly3DCollection(x[tris], facecolors=_colors(x, tris),
                                         edgecolor="none"))
    _limits(ax, x.min(0), x.max(0))
    ax.view_init(elev=elev, azim=azim)
    ax.set_title(title)
    ax.axis("off")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def render_gif(frames_mesh_order, tris, path: str, fps: int = 15):
    """Render a list of vertex arrays to an animated GIF."""
    plt = _pyplot()
    from matplotlib.animation import FuncAnimation, PillowWriter
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    frames = [to_numpy(f) for f in frames_mesh_order]
    fig = plt.figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    allx = np.concatenate(frames)
    lo, hi = allx.min(0), allx.max(0)

    def draw(i):
        ax.clear()
        x = frames[i]
        ax.add_collection3d(Poly3DCollection(x[tris],
                                             facecolors=_colors(x, tris)))
        _limits(ax, lo, hi)
        ax.axis("off")

    anim = FuncAnimation(fig, draw, frames=len(frames))
    anim.save(path, writer=PillowWriter(fps=fps))
    plt.close(fig)


def plot_convergence(series: dict, path: str, ylog: bool = True,
                     xlabel: str = "iteration", title: str = ""):
    """Overlay ||f||_inf (or energy) series: the `compare` harness plot."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, ys in series.items():
        ys = to_numpy(ys)
        ax.plot(np.arange(1, len(ys) + 1), ys, label=name)
    if ylog:
        ax.set_yscale("log")
    ax.set_xlabel(xlabel)
    ax.legend()
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)


def render_level(scene, level: int, path: str, x=None, title=None):
    """Render one multigrid level's hex mesh surface."""
    from .. import mesh as meshlib
    lvl = scene.level(level)
    tris = meshlib.surface_triangles(np.asarray(lvl.hexes))
    xs = np.asarray(lvl.x0) if x is None else to_numpy(x)
    render_surface(xs, tris, path,
                   title=title or f"level {level}: {lvl.n_hexes} hexes")


def show(scene, sim, energy, f_inf, out_prefix: str):
    """Energy and ||f||_inf series and the deformed mesh: writes
    {prefix}_energy.png, {prefix}_conv.png and {prefix}_mesh.png."""
    from .. import mesh as meshlib
    plot_convergence({"energy": energy}, out_prefix + "_energy.png",
                     ylog=False)
    plot_convergence({"||f||_inf": f_inf}, out_prefix + "_conv.png")
    tris = meshlib.surface_triangles(scene.mesh.hexes)
    render_surface(scene.to_mesh_order(sim.x), tris, out_prefix + "_mesh.png")

"""Simulation driver loop: headless window and frame capture.

Port of `fem_simulation_tpu/render/window.py`. `HeadlessWindow` drives
`loop(render_fn)` and `setSelect(select, move, clear)` as the reference
window does, and captures frames to PNG / GIF through `utils.viz` instead
of swapping GL buffers. Pause and drag are scripted with `inject_*`
methods, the key and mouse callbacks' equivalents (Space toggles pause).
"""
from __future__ import annotations

from ..utils.viz import to_numpy
from .camera import Camera


class HeadlessWindow:
    """Drives render_fn(pause) per frame; optionally captures frames.

    render_fn is called with the pause flag; the sim reads and writes its
    own state. Register a frame_source() -> (x_mesh_order, tris) to enable
    capture: each captured frame is one copy to the host.
    """

    def __init__(self, width: int = 1920, height: int = 1080,
                 title: str = "fem_simulation_tpu_torch"):
        self.width = width
        self.height = height
        self.title = title
        self.camera = Camera(aspect=width / height)
        self.paused = False
        self.frames = []
        self._frame_source = None
        self._select_cbs = None
        self._should_close = False

    # -- the reference window's API -------------------------------------------
    def set_frame_source(self, fn):
        self._frame_source = fn

    def setSelect(self, select, move, clear):
        """Register picking callbacks."""
        self._select_cbs = (select, move, clear)

    def loop(self, render_fn, max_frames: int = 120, capture_every: int = 0):
        for i in range(max_frames):
            if self._should_close:
                break
            render_fn(self.paused)
            if capture_every and self._frame_source and i % capture_every == 0:
                x, tris = self._frame_source()
                self.frames.append(to_numpy(x).copy())
                self._tris = tris

    # -- scripted interaction (keyboard/mouse equivalents) -------------------
    def inject_pause_toggle(self):
        self.paused = not self.paused      # Space

    def inject_close(self):
        self._should_close = True          # Esc

    def inject_click(self, sx: float, sy: float):
        """LMB press in select mode -> select callback with the pick ray."""
        if self._select_cbs:
            o, d = self.camera.unproject(sx, sy, self.width, self.height)
            self._select_cbs[0](o, d)

    def inject_drag(self, sx: float, sy: float):
        if self._select_cbs:
            o, d = self.camera.unproject(sx, sy, self.width, self.height)
            self._select_cbs[1](o, d)

    def inject_release(self):
        if self._select_cbs:
            self._select_cbs[2]()

    # -- output --------------------------------------------------------------
    def save_gif(self, path: str, fps: int = 15):
        from ..utils.viz import render_gif
        if not self.frames:
            raise RuntimeError("no frames captured; pass capture_every>0 and "
                               "set_frame_source(...)")
        render_gif(self.frames, self._tris, path, fps=fps)

    def save_png(self, path: str, frame: int = -1):
        from ..utils.viz import render_surface
        render_surface(self.frames[frame], self._tris, path)


# Alias matching the reference class name (`Window(1920, 1080, "Test")`).
Window = HeadlessWindow

"""Headless and browser viewers over a running simulator (no GL)."""
from .camera import Camera  # noqa: F401
from .window import HeadlessWindow, Window  # noqa: F401

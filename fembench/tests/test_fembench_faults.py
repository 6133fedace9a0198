"""A run with the timed path broken underneath comes out not correct: the
program's entry returning its state unchanged, leaving half the body out,
or altering one vertex of its answer. (The cells take one chip: there is no
exchange between chips to leave out.)"""
import pytest
import torch

from fembench import run

from .conftest import TINY_CELLS


def _half(a, b):
    """b on the z-planes of the first half of the lattice, a elsewhere."""
    z = a.shape[2] // 2
    out = a.clone()
    out[:, :, :z] = b[:, :, :z]
    return out


def _moved(x):
    """x with one real vertex (on the bottom edge, free on every body)
    moved by 1e-3 (dx / 50)."""
    out = x.clone()
    out[0, 0, x.shape[2] // 2] += 1e-3
    return out


def frames_fault(kind):
    def plant(system):
        step = system.step

        def faulty(scene, st, *args, **kw):
            out, k, fn = step(scene, st, *args, **kw)
            if kind == "unchanged":
                return st, k, fn
            x = _half(out.x, st.x) if kind == "half" else _moved(out.x)
            return out._replace(x=x), k, fn
        system.step = faulty
    return plant


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_fault_is_not_correct(tiny_root, cell, kind):
    r = run.run_cell(tiny_root, cell, 99, 0.3, False, device="cpu",
                     log=lambda *a: None, system_hook=frames_fault(kind))
    assert r["correct"] is False
    assert r["checks"]["resid_max"]["value"] > r["checks"]["resid_max"][
        "limit"]


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_sound_run_is_correct(tiny_root, cell):
    r = run.run_cell(tiny_root, cell, 99, 0.3, False, device="cpu",
                     log=lambda *a: None)
    assert r["correct"] is True
    assert torch.isfinite(torch.tensor(r["checks"]["resid_max"]["value"]))

"""The control at a tiny size: the reference's own Newton solver computed in
TF32 (reference.Model prec 'tf32') put in the program's place fails each
mix's check, and the program at the same size passes it, held to the limit
of the full cell that shares the tiny cell's configuration and mix. On the
card, `python3 -m fembench.readings` reads both at the cells' own sizes."""
import json

import pytest

from fembench import readings, run

from .conftest import TINY_CELLS


@pytest.mark.parametrize("cell,like", [(c[0], c[3]) for c in TINY_CELLS])
def test_control_fails_where_the_program_passes(tiny_root, cell, like):
    limit = run.resolve(tiny_root, like).limits["resid_max"]["limit"]
    lines = readings.readings(tiny_root, cell, seeds=[11, 2 ** 33 + 1],
                              seconds=0.5, control_seeds=[5, 6, 7],
                              control_requests=1, device="cpu",
                              emit=lambda s: None)
    prog = [r["resid_max"] for r in lines if r["who"] == "program"]
    ctrl = [r["resid_max"] for r in lines if r["who"] == "control"]
    assert len(prog) == 2 and len(ctrl) == 3
    assert max(prog) <= limit < min(ctrl), json.dumps(lines)

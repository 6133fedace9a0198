"""On the card: the command runs a cell briefly, prints its result as the
last line with correct true, names the card, and traces kernels. Skips
without a CUDA device."""
import json
import subprocess
import sys

import pytest

from .conftest import REPO


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_command_on_the_card(card, trace):
    p = subprocess.run([sys.executable, "-m", "fembench.run", "--workload",
                        "beam74k.frames", "--seed", "77", "--seconds", "2",
                        "--trace", str(trace)], cwd=REPO,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    if trace:
        assert r["device"]["busy_s"] > 0.0
        assert "fused_newton_roofline" in r["metrics"]

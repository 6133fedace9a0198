"""Each mix at a tiny size on the CPU (the program's plain versions): a run
gives a result of the contract's form with correct true; without a card
the command refuses and prints no result."""
import json
import os
import subprocess
import sys

import pytest

from fembench import run

from .conftest import REPO, TINY_CELLS

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_mix_runs_tiny(tiny_root, cell, trace):
    lines = []
    r = run.run_cell(tiny_root, cell, 2 ** 31 + 12345, 0.5, bool(trace),
                     device="cpu", log=lambda *a: lines.append(" ".join(
                         str(x) for x in a)))
    json.loads(json.dumps(r))
    keys = list(r)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert lines[-1].startswith("check resid_max")
    assert set(r["build_s"]) == {"cuda", "native"}
    if trace:
        assert "breakdown" in r and "busy_s" in r["device"]
        # no device metric on the CPU
        assert set(r["metrics"]) == {"newton_per_frame", "frame_ms_p95"}
    else:
        assert set(r["metrics"]) == {"setup_s", "frame_ms"}
        assert r["metrics"]["frame_ms"]["value"] > 0.0


def test_same_seed_same_requests(tiny_root):
    from fembench import traffic
    mix = traffic.load(tiny_root, "frames_tiny")
    a = traffic.requests(mix, 7)
    b = traffic.requests(mix, 7)
    first = [next(a) for _ in range(65)]
    assert first == [next(b) for _ in range(65)]
    assert [r.step for r in first[:31]] == list(range(30)) + [0]
    assert first[0].seed != first[30].seed
    assert traffic.derive(2 ** 40 + 3, 5) == traffic.derive(2 ** 40 + 3, 5)


def test_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this process has a CUDA device")
    p = subprocess.run([sys.executable, "-m", "fembench.run", "--workload",
                        "beam74k.frames", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and fembench/."""
    from .conftest import copy_benchmark
    copy_benchmark(str(tmp_path))
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "-c",
                        "import sys; sys.argv[0] = 'x'; "
                        "from fembench import run; "
                        "r = run.run_cell('.', 'beam74k.frames', 1, 1.0, "
                        "False, device='cpu')"],
                       cwd=str(tmp_path), env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and "fem_simulation_tpu_torch" in p.stderr

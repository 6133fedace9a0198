"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny
cells beside the real ones, and the card check (inside a fixture, never at
import)."""
import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# tiny bodies under the real configurations' material, dynamics and mixes
TINY = {"tinybeam": {"generator": "beam", "cells": [2, 2, 8], "dx": 0.05},
        "tinyshell": {"generator": "shell", "cells": [6, 6, 6],
                      "thickness": 2, "dx": 0.05}}
# (cell, configuration, mix, the full cell whose limits it is held to);
# the tiny mixes are the real ones with short traced stretches
TINY_CELLS = (("tinybeam.frames", "tinybeam", "frames_tiny",
               "beam74k.frames"),
              ("tinyshell.frames", "tinyshell", "frames_tiny",
               "shell64.frames"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)")


def copy_benchmark(dst):
    """BENCHMARK.json and fembench/ of the repo under dst."""
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "fembench"),
                    os.path.join(dst, "fembench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))


def add_cell(root, cell, config, mix, like):
    """A cell `cell` of `config` under `mix` added to the benchmark at root
    as a later change would add one: an entry, and the limits and metric
    lists of the cell `like`; the configuration and mix files must be
    there."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as fh:
        b = json.load(fh)
    if config not in {c["name"] for c in b["configs"]}:
        b["configs"].append({"name": config, "source": "tiny test body",
                             "file": f"fembench/configs/{config}.json",
                             "reduced": [], "why": "tests"})
    b["workloads"].append({"name": cell, "config": config, "traffic": mix,
                           "chips": 1, "why": "tests"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m and like in m["workloads"]:
            m["workloads"].append(cell)
    with open(path, "w") as fh:
        json.dump(b, fh)
    shutil.copy(os.path.join(root, "fembench", "limits", like + ".json"),
                os.path.join(root, "fembench", "limits", cell + ".json"))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    """The benchmark with the tiny cells added: tinybeam.frames and
    tinyshell.frames, each held to the limits of the full cell whose
    configuration and mix it shares."""
    root = str(tmp_path_factory.mktemp("bench"))
    copy_benchmark(root)
    for name, mesh in TINY.items():
        with open(os.path.join(REPO, "fembench", "configs",
                               "beam74k.json")) as fh:
            cfg = json.load(fh)
        cfg.update(name=name, mesh=mesh)
        with open(os.path.join(root, "fembench", "configs",
                               name + ".json"), "w") as fh:
            json.dump(cfg, fh)
    for mix in ("frames",):
        path = os.path.join(root, "fembench", "mixes", mix)
        with open(path + ".json") as fh:
            spec = json.load(fh)
        spec.update(trace_requests=4, trace_gap_requests=2,
                    warm_requests=2)
        with open(path + "_tiny.json", "w") as fh:
            json.dump(spec, fh)
    for cell, config, mix, like in TINY_CELLS:
        add_cell(root, cell, config, mix, like)
    return root


@pytest.fixture
def card():
    """Skips the test where this process has no CUDA device."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

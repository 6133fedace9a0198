"""BENCHMARK.json against the contract's shape, and every cell resolving to
the files it names: a configuration, a mix, a driver, its limits and a
reader for each of its per-layer metrics."""
import json
import os
import re

import pytest

from fembench import run

from .conftest import REPO, add_cell, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_names_and_units():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["fembench"] and 1 <= b["run_seconds"] <= 51
    assert all(TEXT.match(w) for w in b["command"])
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert c["file"].startswith("fembench/") and c["reduced"] == []
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and TEXT.match(w["why"])
        assert w["chips"] == 1
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in b["workloads"]}
    assert [m["name"] for m in b["end_to_end"]] == ["setup_s", "frame_ms"]
    assert all(0.01 <= m["bound"] <= 0.25 for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and TEXT.match(m["layer"])
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves(cell):
    c = run.resolve(REPO, cell)
    assert c.config["name"] == c.entry["config"]
    assert hasattr(c.driver, "System") and hasattr(c.driver, "judge")
    assert c.mix["rate_metric"] in {m["name"] for m in c.end_to_end}
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert c.per_layer and set(c.limits) == {"resid_max"}
    for m in c.per_layer:
        assert callable(run.load_module(REPO, "metrics", m["name"]).read)


def test_a_cell_added_by_files_and_an_entry_alone(tmp_path):
    """A later change adds a configuration and a mix as files, and the cell
    as an entry with its limits: no file of the benchmark is edited but
    BENCHMARK.json, and the cell runs."""
    root = str(tmp_path)
    copy_benchmark(root)
    before = {p: open(os.path.join(dp, p), "rb").read()
              for dp, _, fs in os.walk(os.path.join(root, "fembench"))
              for p in fs}
    cfg = json.load(open(os.path.join(root, "fembench/configs/beam74k.json")))
    cfg.update(name="cube3", mesh={"generator": "beam", "cells": [3, 3, 3],
                                   "dx": 0.05})
    json.dump(cfg, open(os.path.join(root, "fembench/configs/cube3.json"),
                        "w"))
    mix = json.load(open(os.path.join(root, "fembench/mixes/frames.json")))
    mix.update(episode_requests=5, trace_requests=4, trace_gap_requests=2,
               warm_requests=2)
    json.dump(mix, open(os.path.join(root, "fembench/mixes/short.json"),
                        "w"))
    add_cell(root, "cube3.short", "cube3", "short", "beam74k.frames")
    after = {p: open(os.path.join(dp, p), "rb").read()
             for dp, _, fs in os.walk(os.path.join(root, "fembench"))
             for p in fs}
    assert all(after[p] == v for p, v in before.items())
    r = run.run_cell(root, "cube3.short", 3, 0.5, False, device="cpu",
                     log=lambda *a: None)
    assert r["correct"] and r["attempted"] > 0
    assert set(r["metrics"]) == {"setup_s", "frame_ms"}

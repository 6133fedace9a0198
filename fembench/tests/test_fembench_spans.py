"""The readers of the program's spans and counters (host_syncs_per_frame,
pcg_per_newton, frame_dispatch_us, scene_build_s): their arithmetic on
hand-built run records, None without a device or where the program keeps
no such spans or counters, and their hooks on the program's CPU frames."""
import sys
from types import SimpleNamespace

import pytest
import torch

from fembench import run

from .conftest import REPO

LATTICE = "fem_simulation_tpu_torch.sim.lattice"
PROFILING = "fem_simulation_tpu_torch.utils.profiling"
NAMES = ("host_syncs_per_frame", "pcg_per_newton", "frame_dispatch_us",
         "scene_build_s")
DEV = [("fused_newton_kernel<false>", 0.0, 1.0)]     # a device event


def reader(name):
    return run.load_module(REPO, "metrics", name)


def rec(id, name, start, end, parent=-1, request=-1):
    return SimpleNamespace(id=id, name=name, start_ns=start, end_ns=end,
                           parent=parent, request=request)


def a_run(store=None, dev=DEV):
    return SimpleNamespace(dev=dev, store=store or {}, note=lambda *a: None)


@pytest.fixture
def records(monkeypatch):
    """Hand-built span records in place of the program's."""
    from fem_simulation_tpu_torch.utils import profiling
    box = []
    monkeypatch.setattr(profiling, "records", lambda: list(box))
    return box


def test_host_syncs_per_frame():
    ends = [{"frames": 10, "newton": 17, "syncs": 27, "rescues": 0},
            {"frames": 11, "newton": 19, "syncs": 30, "rescues": 0},
            {"frames": 13, "newton": 22, "syncs": 41, "rescues": 1}]
    m = reader("host_syncs_per_frame")
    assert m.read(a_run({"host_syncs_per_frame": ends})) == 14 / 3
    assert m.read(a_run({"host_syncs_per_frame": ends}, dev=[])) is None
    assert m.read(a_run({"host_syncs_per_frame": ends[:1]})) is None


def test_pcg_per_newton():
    cuda, other = torch.device("cpu"), "another device"
    t = lambda v: torch.tensor(v, dtype=torch.int64)     # noqa: E731
    ends = [(17, {cuda: (t(90), 10)}),
            (19, {cuda: (t(108), 12)}),
            (22, {cuda: (t(130), 14), other: (t(9), 1)})]
    m = reader("pcg_per_newton")
    # (130 - 90 - 4) + (9 - 1) matvecs in 22 - 17 iterations
    assert m.read(a_run({"pcg_per_newton": ends})) == (36 + 8) / 5
    assert m.read(a_run({"pcg_per_newton": ends}, dev=[])) is None
    assert m.read(a_run({"pcg_per_newton": ends[:1]})) is None


def test_frame_dispatch_us(records):
    # frame 4: 1,000 us with 300 us of reads (one inside a Newton span);
    # frame 5: 600 us with 100 us; frame 3 is not the stretch's
    records += [rec(1, "lattice.readback", 100_000, 200_000, 0, 4),
                rec(3, "lattice.readback", 300_000, 500_000, 2, 4),
                rec(2, "lattice.newton", 250_000, 600_000, 0, 4),
                rec(0, "lattice.frame", 0, 1_000_000, -1, 4),
                rec(6, "lattice.readback", 1_100_000, 1_200_000, 5, 5),
                rec(5, "lattice.frame", 1_050_000, 1_650_000, -1, 5),
                rec(7, "lattice.frame", 0, 9_000_000, -1, 3)]
    m = reader("frame_dispatch_us")
    store = {"frame_dispatch_us": [4, 5]}
    assert m.read(a_run(store)) == ((1000 - 300) + (600 - 100)) / 2
    assert m.read(a_run(store, dev=[])) is None
    assert m.read(a_run({"frame_dispatch_us": [9]})) is None


def test_scene_build_s(records):
    m = reader("scene_build_s")
    assert m.read(a_run()) is None
    records += [rec(0, "lattice.scene", 10, 2_500_000_010),
                rec(1, "lattice.frame", 3_000_000_000, 3_000_100_000, -1, 1)]
    assert m.read(a_run()) == pytest.approx(2.5)
    assert m.read(a_run(dev=[])) is None


def test_without_the_programs_counters(monkeypatch):
    """A program with no such counters or spans (the benchmark's first
    commit): the hooks keep nothing and every reader returns None."""
    bare = SimpleNamespace()
    for name in (LATTICE, PROFILING,
                 "fem_simulation_tpu_torch.ops.lattice_kernels"):
        monkeypatch.setitem(sys.modules, name, bare)
    store = {}
    for name in NAMES:
        m = reader(name)
        if hasattr(m, "record"):
            store[name] = []
            m.record(store[name], (), {}, 0.0)
            assert store[name] == []
        assert m.read(a_run(store)) is None


def test_hooks_on_the_programs_frames():
    """The hooks live while CPU frames of a tiny beam run, as in the first
    traced stretch: each reader reads what the program counted."""
    from fem_simulation_tpu_torch import mesh as pmesh
    from fem_simulation_tpu_torch.ops import lattice_kernels as lk
    from fem_simulation_tpu_torch.sim import lattice
    from fem_simulation_tpu_torch.utils import profiling
    torch.set_num_threads(1)
    sc = lattice.LatticeScene(pmesh.beam(2, 2, 8, dx=0.05), device="cpu")
    st = sc.init_state()
    metrics = [(name, reader(name)) for name in NAMES]
    store = {}
    profiling.enable()
    try:
        with run.hooked(metrics, store):
            counts0 = dict(lattice.counts)
            pcg0 = lk.pcg_matvecs()
            ks = []
            for _ in range(4):
                st, k, _ = lattice.step_to_tol(sc, st)
                ks.append(k)
    finally:
        profiling.disable()
    r = a_run(store)
    # whole frames between the first frame's end and the last's
    assert metrics[0][1].read(r) == (
        lattice.counts["syncs"] - counts0["syncs"] - 1 - ks[0]) / 3
    matvecs = lk.pcg_matvecs() - pcg0
    pcg = metrics[1][1].read(r)
    assert sum(ks[1:]) * pcg <= matvecs and pcg > 0
    frames = [x for x in profiling.records() if x.name == "lattice.frame"]
    assert store["frame_dispatch_us"] == [f.request for f in frames[-4:]]
    assert 0 < metrics[2][1].read(r) < max(
        f.end_ns - f.start_ns for f in frames[-4:]) * 1e-3
    assert metrics[3][1].read(r) > 0

"""The lattice frame's counters and spans (sim/lattice.py, utils/profiling.py,
ops/lattice_kernels.py's PCG counter) on the CPU, at tiny sizes: the counts
against what the frames return, the spans' nesting and request ids, and
when tracing is on."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim import lattice as tlat
from fem_simulation_tpu_torch.utils import profiling


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh():
    """Counters and records from zero, tracing off, for each test."""
    profiling.disable()
    profiling.reset()
    tlat.reset_counts()
    lk.reset_launches()
    yield
    profiling.disable()


@pytest.fixture(scope="module")
def beam2k():
    """The 2k beam (8x8x24 cells, 2,025 vertices) and its state after one
    frame, so that the frames below take Newton iterations of their own."""
    sc = tlat.LatticeScene(meshlib.beam(8, 8, 24, dx=0.05), device="cpu")
    st, _, _ = tlat.step_to_tol(sc, sc.init_state())
    return sc, st


def kicked(sc):
    """The rigid-rotation kick of test_torch_lattice.py's rescue test."""
    st = sc.init_state()
    x = st.x.numpy()
    r = x - x.reshape(-1, 3).mean(0)
    omega = np.array([18.0, 0.0, 6.0], np.float32)
    v = np.cross(np.broadcast_to(omega, r.shape), r).astype(np.float32)
    return st._replace(v=torch.from_numpy(v) * sc.vert_mask[..., None])


def test_counts_over_frames(beam2k, monkeypatch):
    """Frames, Newton iterations and reads counted; the PCG counter and
    return_cg's total equal the launches' k less one each."""
    sc, st = beam2k
    ks_pcg = []
    orig = lk.fused_newton

    def spy(*a, **kw):
        out = orig(*a, **kw)
        ks_pcg.append(int(out[3]))
        return out
    monkeypatch.setattr(lk, "fused_newton", spy)
    ks, cgs = [], []
    for i in range(4):
        syncs = tlat.counts["syncs"]
        if i < 2:
            st, k, fn, cg = tlat.step_to_tol(sc, st, return_cg=True)
            cgs.append(cg)
            # the initial residual, one read an iteration, return_cg's total
            assert tlat.counts["syncs"] - syncs == 1 + k + 1
        else:
            st, k, fn = tlat.step_to_tol(sc, st)
            assert tlat.counts["syncs"] - syncs == 1 + k
        assert fn <= 1e-4 and k >= 1
        ks.append(k)
    assert tlat.counts == {"frames": 4, "newton": sum(ks),
                           "syncs": 4 + sum(ks) + 2, "rescues": 0}
    assert len(ks_pcg) == sum(ks)
    assert sum(cgs) == sum(k - 1 for k in ks_pcg[:ks[0] + ks[1]])
    assert lk.pcg_matvecs() == sum(k - 1 for k in ks_pcg)
    (total, calls), = lk.pcg.values()
    assert total.dtype == torch.int64 and calls == sum(ks)


def test_rescued_frames_count_their_reads(monkeypatch):
    """On the kick, each frame's reads are the initial residual, one an
    iteration, and each rescue's: armijo_step's own and the residual after
    it."""
    sc = tlat.LatticeScene(meshlib.beam(3, 3, 12, dx=0.05), device="cpu")
    st = kicked(sc)
    armijo_reads = []
    orig = tlat.armijo_step

    def spy(*a, **kw):
        before = tlat.counts["syncs"]
        out = orig(*a, **kw)
        armijo_reads.append(tlat.counts["syncs"] - before)
        return out
    monkeypatch.setattr(tlat, "armijo_step", spy)
    for _ in range(6):
        syncs, rescues = tlat.counts["syncs"], tlat.counts["rescues"]
        n_armijo = len(armijo_reads)
        st, k, fn = tlat.step_to_tol(sc, st, tol=1e-4, max_newton=25)
        rescued = tlat.counts["rescues"] - rescues
        assert rescued == len(armijo_reads) - n_armijo
        assert tlat.counts["syncs"] - syncs == (
            1 + k + sum(armijo_reads[n_armijo:]) + rescued)
    assert tlat.counts["rescues"] >= 1
    assert all(n >= 2 for n in armijo_reads)     # the slope and a backtrack


def test_spans_nest_one_request_a_frame(beam2k):
    """Under enable(): a frame span a frame, at the top, its request id the
    frame's number; every span of the frame inside it with that id; a Newton
    span an iteration and a readback span a read; the frame less its
    readbacks is frame_dispatch_us's host time."""
    sc, st = beam2k
    profiling.enable()
    ks = []
    for _ in range(2):
        st, k, _ = tlat.step_to_tol(sc, st)
        ks.append(k)
    profiling.disable()
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    frames = [r for r in recs if r.name == "lattice.frame"]
    assert [f.request for f in frames] == [1, 2]
    for f, k in zip(frames, ks):
        assert f.parent == -1
        mine = [r for r in recs if r.request == f.request and r is not f]
        names = [r.name for r in mine]
        assert names.count("lattice.newton") == k
        assert names.count("lattice.readback") == 1 + k
        assert names.count("lattice.setup") == 1
        for r in mine:
            outer = by_id[r.parent]
            assert outer.request == f.request
            assert outer.start_ns <= r.start_ns <= r.end_ns <= outer.end_ns
            if r.name in ("lattice.setup", "lattice.newton"):
                assert r.parent == f.id
        reads = sum(r.end_ns - r.start_ns for r in mine
                    if r.name == "lattice.readback")
        newton = sum(r.end_ns - r.start_ns for r in mine
                     if r.name == "lattice.newton")
        dispatch = f.end_ns - f.start_ns - reads
        assert 0 < reads < f.end_ns - f.start_ns
        assert newton < dispatch + reads


def test_rescue_span_holds_its_reads():
    sc = tlat.LatticeScene(meshlib.beam(3, 3, 12, dx=0.05), device="cpu")
    st = kicked(sc)
    profiling.enable()
    for _ in range(3):
        st, _, _ = tlat.step_to_tol(sc, st, tol=1e-4, max_newton=25)
    profiling.disable()
    recs = profiling.records()
    by_id = {r.id: r for r in recs}
    rescues = [r for r in recs if r.name == "lattice.rescue"]
    assert len(rescues) == tlat.counts["rescues"] >= 1
    for r in rescues:
        assert by_id[r.parent].name == "lattice.newton"
        assert any(x.parent == r.id and x.name == "lattice.readback"
                   for x in recs)


def test_off_records_nothing(beam2k):
    """Tracing off: no record, and a span site hands out one shared no-op."""
    sc, st = beam2k
    assert not profiling.tracing()
    assert profiling.span("a") is profiling.span("b", request=3)
    tlat.step_to_tol(sc, st)
    assert profiling.records() == []
    assert tlat.counts["frames"] == 1


def test_profiler_turns_tracing_on(beam2k):
    """Inside a torch.profiler session tracing is on and the spans are its
    record_function ranges; after it, off."""
    sc, st = beam2k
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.tracing()
        tlat.step_to_tol(sc, st)
    assert not profiling.tracing()
    names = {e.name for e in prof.events()}
    assert {"lattice.frame", "lattice.setup", "lattice.newton",
            "lattice.readback"} <= names
    assert {r.name for r in profiling.records()} == {
        "lattice.frame", "lattice.setup", "lattice.newton",
        "lattice.readback"}
    kept = len(profiling.records())
    tlat.step_to_tol(sc, st)
    assert len(profiling.records()) == kept


def test_scene_span_recorded_always():
    """A scene's build is the span lattice.scene with tracing off."""
    assert not profiling.tracing()
    tlat.LatticeScene(meshlib.beam(2, 2, 4, dx=0.05), device="cpu")
    (rec,) = profiling.records()
    assert rec.name == "lattice.scene" and rec.parent == -1
    assert rec.request == -1 and rec.end_ns > rec.start_ns


def test_records_bounded():
    """The store keeps the newest MAX_RECORDS."""
    profiling.enable()
    for i in range(profiling.MAX_RECORDS + 5):
        with profiling.span("x", request=i):
            pass
    recs = profiling.records()
    assert len(recs) == profiling.MAX_RECORDS
    assert recs[0].request == 5 and recs[-1].request == (
        profiling.MAX_RECORDS + 4)

"""The passes and the launch plan of the Gauss-Seidel kernel ell_gs, on the CPU.

`gs_passes` lists the colors a call relaxes (no color twice in a row),
`gs_plan` mirrors ell_gs_plan in csrc/ell_kernels.cu: the coop form, a
cluster of up to 16 blocks (rows and x in shared memory), or a cooperative
launch whose blocks keep their rows in shared memory for the whole call or
stream them a pass at a time. These tests check, without a card, that every
launch the plan weighs gives each row of every color to exactly one block
and fits a block's shared memory and a cluster's 16 blocks, what the plan
picks at the main paths' multigrid levels, and that the wrapper raises when
the C entry reports a failed launch.
"""
import contextlib

import numpy as np
import pytest
import torch

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.ops import _cuda
from fem_simulation_tpu_torch.ops import ell_kernels as ek
from fem_simulation_tpu_torch.sim.scene import Scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: the tests run in several processes
    at once, and torch's default of a thread a core each makes them contend
    for the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H100_SMS = 132
H100_SMEM = 232448           # the shared memory a block may opt in to
# (N, K, color offsets) of every level of the unstructured Scenes of the
# main paths (mesh.beam(..., dx=0.05); 2 levels on the 8x8x24 beam, 3 on
# the others), as the hierarchy colors them
LEVELS = {
    "2k fine": (2025, 27, (0, 325, 625, 885, 1125, 1385, 1625, 1833, 2025)),
    "2k level 1": (325, 27, (0, 63, 117, 159, 195, 237, 273, 301, 325)),
    "19k fine": (18785, 27, (0, 2673, 5265, 7641, 9945, 12321, 14625,
                             16737, 18785)),
    "19k level 1": (2673, 27, (0, 425, 825, 1165, 1485, 1825, 2145, 2417,
                               2673)),
    "19k level 2": (425, 27, (0, 81, 153, 207, 255, 309, 357, 393, 425)),
    "74k fine": (74273, 27, (0, 10449, 20817, 30105, 39321, 48609, 57825,
                             66081, 74273)),
    "74k level 1": (10449, 27, (0, 1625, 3225, 4525, 5805, 7105, 8385, 9425,
                                10449)),
    "74k level 2": (1625, 27, (0, 297, 585, 783, 975, 1173, 1365, 1497,
                               1625)),
}
# what the plan picks there, (form, blocks) for the V-cycle's call (3
# iterations) and the harness's (1 iteration)
PICKS = {
    "2k fine": {3: ("cluster", 16), 1: ("cluster", 16)},
    "2k level 1": {3: ("cluster", 7), 1: ("cluster", 9)},
    "19k fine": {3: ("resident", 128), 1: ("resident", 132)},
    "19k level 1": {3: ("resident", 71), 1: ("resident", 86)},
    "19k level 2": {3: ("cluster", 9), 1: ("cluster", 9)},
    "74k fine": {3: ("stream", 131), 1: ("stream", 131)},
    "74k level 1": {3: ("resident", 125), 1: ("resident", 130)},
    "74k level 2": {3: ("cluster", 16), 1: ("cluster", 16)},
}

def test_levels_are_the_scene_hierarchy():
    """LEVELS holds what the 2k beam's Scene colors (the larger beams'
    offsets come from the same hierarchy code)."""
    sc = Scene(meshlib.beam(8, 8, 24, dx=0.05),
               solver=SolverConfig(n_levels=2), device="cpu")
    for li, label in enumerate(("2k fine", "2k level 1")):
        op = sc.make_op(li)
        n, k, offs = LEVELS[label]
        assert tuple(op.nbr.shape) == (n, k)
        assert tuple(op.color_offsets) == offs


@pytest.mark.parametrize("label", sorted(LEVELS))
def test_every_launch_owns_each_row_once(label):
    """Every (form, blocks) the plan weighs at a path level: block r's
    slices of color c tile the color in order, so every row of every color
    belongs to exactly one block; the block's shared memory (its layout
    rows at least the rows it owns) is within 227 KB; a cluster has at most
    16 blocks and the cooperative staged forms at most one block an SM."""
    n, k, offs = LEVELS[label]
    cands = ek.gs_candidates(n, k, offs, H100_SMS, 3)
    assert cands[0][1:] == (ek.GS_COOP, 0)
    staged = set()
    for _, form, blocks in cands[1:]:
        staged.add(form)
        starts = ek.gs_slice_starts(offs, blocks)
        assert starts.shape == (len(offs) - 1, blocks + 1)
        assert (starts[:, 0] == offs[:-1]).all()
        assert (starts[:, -1] == offs[1:]).all()
        assert (np.diff(starts, axis=1) >= 0).all()
        rows = ek.gs_slice_rows(offs, blocks)
        assert (rows == np.diff(starts, axis=1)).all()
        layout = ek.gs_layout_rows(offs, form, blocks)
        if form == ek.GS_STREAM:
            assert layout == rows.max()
        else:
            assert layout >= rows.sum(axis=0).max()
        smem = ek.gs_smem_bytes(form, n, k, layout)
        assert 0 < smem <= ek.GS_SMEM_CAP < H100_SMEM
        if form == ek.GS_CLUSTER:
            assert blocks <= ek.GS_MAX_CLUSTER
        else:
            assert blocks <= H100_SMS
    # the stream form fits everywhere; a level of at most ~2k rows fits in
    # a cluster's shared memory with its copy of x
    assert ek.GS_STREAM in staged
    assert (ek.GS_CLUSTER in staged) == (n <= 2100)
    # the owner of every row, counted at the plan's own pick
    form, blocks = ek.gs_plan(n, k, offs, H100_SMS, 3)
    if form != ek.GS_COOP:
        owners = np.zeros(n, np.int64)
        starts = ek.gs_slice_starts(offs, blocks)
        for c in range(len(offs) - 1):
            for r in range(blocks):
                owners[starts[c, r]:starts[c, r + 1]] += 1
        assert (owners == 1).all()


@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("label", sorted(LEVELS))
def test_plan_picks_at_path_levels(label, iterations):
    """The mirror's pick at each level of the main paths on an H100: a
    cluster on the levels whose rows and x fit in 16 blocks' shared memory
    (the 2k fine level among them), the resident form where the rows fit in
    the card's, the stream form on the 74k beam's fine level."""
    n, k, offs = LEVELS[label]
    form, blocks = ek.gs_plan(n, k, offs, H100_SMS, iterations)
    assert (ek.GS_FORMS[form], blocks) == PICKS[label][iterations]


@pytest.mark.parametrize("offs, iterations, want", [
    ((0, 2, 5, 9), 1, [2, 1, 0, 1, 2]),
    ((0, 2, 5, 9), 2, [2, 1, 0, 1, 2, 1, 0, 1, 2]),
    ((0, 2, 2, 5, 9), 1, [3, 2, 0, 2, 3]),        # an empty color
    ((0, 4, 7), 3, [1, 0, 1, 0, 1, 0, 1]),
    ((0, 0, 6), 3, [1]),                          # one non-empty color
    ((0, 2, 5, 9), 0, []),
])
def test_gs_passes(offs, iterations, want):
    """The passes: the two-stage sweeps' colors (non-empty, last to first,
    then first to last, each iteration) with each color that would follow
    itself left out."""
    assert ek.gs_passes(offs, iterations) == want
    full = [c for _ in range(iterations)
            for c in list(range(len(offs) - 2, -1, -1))
            + list(range(len(offs) - 1)) if offs[c + 1] > offs[c]]
    dedup = [c for i, c in enumerate(full) if i == 0 or full[i - 1] != c]
    assert want == dedup


def test_gs_passes_at_path_levels():
    """8 non-empty colors: 43 passes a 3-iteration call (not 48), 15 a
    1-iteration call (not 16)."""
    offs = LEVELS["2k fine"][2]
    assert len(ek.gs_passes(offs, 3)) == 43
    assert len(ek.gs_passes(offs, 1)) == 15


class _FailingLib:
    """A kernel library whose ell_gs (or ell_gs_plan) reports a CUDA error."""

    def __init__(self, plan_err=0, launch_err=0):
        self.plan_err, self.launch_err, self.calls = plan_err, launch_err, []

    def ell_gs_plan(self, n, k, offs, n_colors, iterations, plan):
        plan[0], plan[1] = ek.GS_CLUSTER, 4
        return self.plan_err

    def ell_gs(self, *args):
        self.calls.append(args[-3:-1])       # (form, blocks)
        return self.launch_err

    def lat_error_string(self, err):
        return b"injected"


@pytest.mark.parametrize("where", ["launch", "plan"])
def test_gs_raises_on_a_failed_launch(monkeypatch, where):
    """A non-zero code from the C entry (a refused cluster launch, too
    little shared memory for the planned form) raises in the wrapper; it
    does not run another form or the plain version instead."""
    lib = _FailingLib(plan_err=int(where == "plan") * 2,
                      launch_err=int(where == "launch") * 719)
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "load", lambda: lib)
    monkeypatch.setattr(_cuda, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(ek, "_gs_plans", {})
    n, k = 4, 2
    values = torch.eye(3).expand(n, k, 3, 3).contiguous()
    nbr = torch.tensor([[0, 1], [1, 0], [2, 3], [3, 2]], dtype=torch.int32)
    args = (values, nbr, torch.ones((n, k)), torch.zeros(n, dtype=torch.int32),
            (0, 2, 4), torch.ones((n, 3)))
    before = ek.launches["gs"]
    with pytest.raises(RuntimeError, match="injected"):
        ek.gs(*args, None, 3)
    if where == "launch":
        assert lib.calls == [(ek.GS_CLUSTER, 4)]
        assert ek.launches["gs"] == before + 1
    else:
        assert lib.calls == [] and ek.launches["gs"] == before

"""The frozen bounds against hand counts, and the trace reductions on
synthetic events."""
import pytest
import torch

from fembench import bounds, trace

PEAK = bounds.PEAKS["NVIDIA H100 80GB HBM3"]


def test_fused_newton_at_the_74k_beam():
    # 74,273 vertices, 65,536 cells, k = 3: two HVPs
    n_bytes, flops = bounds.fused_newton_work(74273, 65536, 3)
    assert n_bytes == 4 * (3 * 74273 * 4) + 3 * 74273 * 4 + 4 * 65536 + 8
    assert flops == 65536 * (2 * 449 * 8 + 930 * 8 + 2 * 763 * 8)
    # PERF.md's 26.2 us (chip_smoke.lattice_bounds): operations bound it
    assert bounds.bound_s(n_bytes, flops, PEAK) == pytest.approx(26.24e-6,
                                                                 rel=1e-3)
    assert bounds.bound_s(n_bytes, flops, PEAK) == flops / 67e12


def test_unknown_card_has_no_peak():
    assert bounds.peaks("NVIDIA H100 PCIe") is None


def test_annotations_are_no_device_work():
    from types import SimpleNamespace as NS
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, s, e, dt, ann=False):
        return NS(name=name, time_range=NS(start=s, end=e), device_type=dt,
                  is_user_annotation=ann)
    prof = NS(events=lambda: [ev("fembench.stretch", 0.0, 50.0, cpu, True),
                              ev("fembench.stretch", 1.0, 49.0, cuda, True),
                              ev("span", 2.0, 48.0, cpu, True),
                              ev("span", 2.5, 47.0, cuda),
                              ev("kernel", 5.0, 9.0, cuda)])
    dev, host = trace.events(prof)
    assert dev == [("kernel", 5.0, 9.0)]
    assert host == [("fembench.stretch", 0.0, 50.0), ("span", 2.0, 48.0)]


def test_busy_union_and_gaps():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 12.0), ("k1", 20.0, 25.0),
           ("copy", 30.0, 31.0)]
    assert trace.busy_us(dev) == 12.0 + 5.0 + 1.0
    assert trace.spans(dev, "k1") == [10.0, 5.0]
    top = trace.top_ops(dev)
    assert top[0][0] == "k1" and top[0][1] == pytest.approx(15e-6)
    host = [("frame", -5.0, 40.0), ("aten::item", 13.0, 19.0),
            ("cudaLaunchKernel", 26.0, 29.0)]
    gaps = dict(map(tuple, trace.idle_gaps(dev, host, 0.0, 35.0)))
    assert gaps["aten::item"] == pytest.approx(8e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(5e-6)
    assert gaps["frame"] == pytest.approx(4e-6)
    assert sum(gaps.values()) == pytest.approx((35.0 - 18.0) * 1e-6)

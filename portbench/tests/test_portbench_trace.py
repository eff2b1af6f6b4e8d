"""The reduction of a profiled stretch on a synthetic profiler trace."""

import types

import pytest
from torch.autograd import DeviceType

from portbench import trace


def ev(name, start, end, dev=DeviceType.CPU, id_=0):
    return types.SimpleNamespace(name=name, device_type=dev, id=id_,
                                 time_range=types.SimpleNamespace(start=start, end=end))


def synthetic():
    cuda = DeviceType.CUDA
    return [
        ev("portbench step", 0, 100),
        ev("gear demod bank", 10, 60),
        ev("cudaLaunchKernel", 12, 14, id_=1),
        ev("cudaLaunchKernel", 40, 42, id_=2),
        ev("cudaLaunchKernel", 70, 72, id_=3),
        ev("portbench fetch", 100, 200),
        ev("cudaMemcpyAsync", 110, 112, id_=4),
        ev("aten::copy_", 105, 190),
        ev("kernel_a", 20, 50, cuda, 1),
        ev("kernel_b", 45, 80, cuda, 2),  # overlaps kernel_a
        ev("kernel_c", 90, 95, cuda, 3),
        ev("Memcpy DtoH", 150, 160, cuda, 4),
        ev("gear demod bank", 20, 50, cuda),  # the range's device-side mirror
    ]


def test_union_owners_and_counts():
    s = trace.reduce(synthetic(), blocks=2, wall_us=200.0,
                     range_names=["gear demod bank", "portbench step", "portbench fetch"],
                     outer_names=["portbench step", "portbench fetch"])
    assert [o.name for o in s.ops] == ["kernel_a", "kernel_b", "kernel_c", "Memcpy DtoH"]
    assert [o.owner for o in s.ops] == ["gear demod bank", "gear demod bank",
                                        "portbench step", "portbench fetch"]
    assert s.busy_us == pytest.approx((80 - 20) + (95 - 90) + (160 - 150))
    assert s.device_ms_per_block(lambda o: o.owner == "gear demod bank") == pytest.approx(
        (30 + 35) / 2 / 1e3)
    assert s.host_ms_per_block("gear demod bank") == pytest.approx(50 / 2 / 1e3)
    assert s.host_ms_per_block("absent") is None
    fetch = [us for label, us in s.gaps if label == "portbench fetch > aten::copy_"]
    assert sorted(fetch) == [pytest.approx(40.0), pytest.approx(55.0)]  # (160, 200), (95, 150)
    assert sum(us for _, us in s.gaps) == pytest.approx(200 - s.busy_us)


def test_union_clips_to_the_stretch():
    busy, gaps = trace.union_us([(-5, 5), (8, 12), (10, 30)], 0, 20)
    assert busy == pytest.approx(5 + 12)
    assert gaps == [(5, 8)]


def test_breakdown_ranks_ops_and_gaps():
    s = trace.reduce(synthetic(), 2, 200.0, ["portbench step"], ["portbench step"])
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["kernel_b", pytest.approx(35e-6)]
    assert len(b["idle_gaps"]) >= 1 and all(v > 0 for _, v in b["idle_gaps"])

"""Each per-layer metric reader on synthetic records, and the reduction of
profiler events that the device metrics read."""

import pytest

from portbench import cells, profiling

WINDOW = [
    {"wall_s": 10.0, "timings": {"device-upload": 0.5, "coarsening": 2.0,
                                 "initial-partitioning": 0.5,
                                 "uncoarsening": 5.0,
                                 "uncoarsening/extend-partition": 1.0}},
    {"wall_s": 12.0, "timings": {"device-upload": 0.7, "coarsening": 2.0,
                                 "initial-partitioning": 0.3,
                                 "uncoarsening": 6.0,
                                 "extend-partition": 1.0}},
]
PROFILE = {"window_s": 4.0, "busy_s": 1.0, "launches": 1234,
           "kernel_s": {"void gather_kernel<int>(int const*)": 0.002,
                        "ratings_kernel<long>": 0.001,
                        "void at::native::sort_kernel": 0.5},
           "device_ops": [], "idle_gaps": []}
RECORDS = {"window": WINDOW, "census": {"syncs": 1123, "outside": 2,
                                        "sites": []},
           "profile": PROFILE}
EXPECTED = {
    "facade.other_s": ((10 - 8) + (12 - 10)) / 2,
    "upload_s": 0.6,
    "coarsening_s": 2.0,
    "ip_s": 0.4,
    "uncoarsening_s": (5.0 + 7.0) / 2,
    "ops.host_syncs": 1123.0,
    "kernels.device_ms": 3.0,
    "device.idle_pct": 75.0,
    "device.launches": 1234.0,
}
NAMES = [m["name"] for m in cells.manifest()["per_layer"]]


def test_every_metric_has_an_expectation():
    assert sorted(NAMES) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    assert cells.metric(name).read(RECORDS) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_returns_none(name):
    empty = {"window": [], "census": None, "profile": None}
    assert cells.metric(name).read(empty) is None


def test_no_hand_written_kernel_reads_none():
    profile = dict(PROFILE, kernel_s={"void at::native::sort_kernel": 0.5})
    records = dict(RECORDS, profile=profile)
    assert cells.metric("kernels.device_ms").read(records) is None


class Event:
    def __init__(self, kind, start, end, name, thread=1):
        self._v = (kind, start, end, name, thread)

    def activity_type(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def name(self):
        return self._v[3]

    def start_thread_id(self):
        return self._v[4]


class OlderEvent(Event):
    """A kineto event of a torch without `activity_type()`."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return object.__getattribute__(self, name)

    def device_type(self):
        cpu = self._v[0] in ("cpu_op", "user_annotation")
        return "DeviceType.CPU" if cpu else "DeviceType.CUDA"


@pytest.mark.parametrize("cls", [Event, OlderEvent])
def test_reduce_events(cls):
    events = [
        cls("cpu_op", 0, 100, "aten::sort"),
        cls("user_annotation", 0, 1000, "coarsening"),
        cls("cpu_op", 500, 700, "aten::item"),
        cls("kernel", 10, 60, "gather_kernel"),
        cls("kernel", 50, 90, "sort_kernel"),
        cls("gpu_memcpy", 600, 650, "Memcpy DtoH"),
        cls("gpu_user_annotation", 0, 1000, "coarsening"),
        cls("cpu_op", 0, 10, "other thread", thread=2),
    ]
    s = profiling.reduce_events(events, wall_s=1e-6, ranges={"coarsening"})
    assert s["busy_s"] == pytest.approx(130e-9)  # [10, 90) and [600, 650)
    assert s["launches"] == 2
    assert s["kernel_s"] == {"gather_kernel": 50e-9, "sort_kernel": 40e-9}
    assert dict(s["device_ops"]) == {"gather_kernel": 50e-9,
                                     "sort_kernel": 40e-9,
                                     "Memcpy DtoH": 50e-9}
    idle = dict(s["idle_gaps"])
    # [0, 10) under aten::sort, [90, 600) mid 345 under the annotation,
    # [650, 1000) mid 825 under the annotation
    assert idle == {"aten::sort": 10e-9, "coarsening": (510 + 350) * 1e-9}


def test_reduce_events_without_device_events():
    assert profiling.reduce_events([Event("cpu_op", 0, 5, "x")], 1.0) is None


def test_union():
    import numpy as np

    lo, hi = profiling.union(np.array([5, 0, 20, 8]), np.array([9, 6, 30, 12]))
    assert lo.tolist() == [0, 20] and hi.tolist() == [12, 30]

"""The traced window's reduction: device activity as a union, idle gaps
named by the host, span copies on the device timeline left out, and a
trace that kept fewer kernel records than were launched marked short."""
from types import SimpleNamespace

import pytest

from palmbench import trace


class Event:
    def __init__(self, name, device, start, dur):
        self._n, self._d, self._s, self._u = name, device, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._u


def prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


EVENTS = [
    Event("palmbench.knn_batch", False, 0, 1000),
    Event("palmbench.knn_batch", True, 0, 1000),  # the span's device copy
    Event("aten::to", False, 100, 300),
    Event("void screen_dense_kernel<float>", True, 400, 200),
    Event("Memcpy HtoD (Pageable -> Device)", True, 500, 200),
    Event("void screen_dense_kernel<float>", True, 800, 100),
]


def test_union_gaps_and_names():
    s = trace.read(prof(EVENTS), 0, 1000, {"screen_select": 2})
    assert s.busy_s == pytest.approx(400e-9)  # [400, 700) and [800, 900)
    assert s.window_s == pytest.approx(1e-6)
    assert s.short == {}
    assert s.kernel_s["screen_dense_kernel"] == pytest.approx(300e-9)
    idle = dict(s.idle_gaps)
    assert idle["knn_batch: aten::to"] == pytest.approx(400e-9)  # covers 3/4
    assert idle["knn_batch: host code outside torch"] == pytest.approx(200e-9)
    assert sum(idle.values()) == pytest.approx(600e-9)
    assert all(not n.startswith("palmbench.") for n, _ in s.device_ops)


def test_missing_kernel_records_mark_the_trace_short():
    s = trace.read(prof(EVENTS), 0, 1000, {"screen_select": 3, "paa": 0})
    assert s.short == {"screen_select": (2, 3)}

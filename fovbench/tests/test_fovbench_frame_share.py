"""The reader of the port's ``raygen`` and ``film`` counts
(``metrics/frame_kernel_share.py``) on hand-made counter tables: the
stages taken by the hand-written kernels over all ray-generation and film
stages, in percent; None where the port keeps no such counts (a port
without the groups, or one that counted nothing in them)."""

import pytest

from fovbench import harness
from conftest import BENCH


def _reader():
    return harness.load_metric(BENCH, "frame_kernel_share")


@pytest.mark.parametrize("raygen,film,want", [
    ({"kernel": 4}, {"kernel": 4}, 100.0),
    ({"kernel": 2}, {"plain": 2}, 50.0),
    ({"kernel": 3, "plain": 1}, {"kernel": 3, "plain": 1}, 75.0),
    ({"plain": 2}, {"plain": 2}, 0.0),
    ({}, {}, None),
    (None, None, None),
])
def test_share_of_stages_on_the_kernels(monkeypatch, raygen, film, want):
    from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

    table = {"frames": 2, "ns": {}, "ns_total": {}, "syncs": {},
             "lanes": {0: 10}, "shade": {"kernel": 8}}
    for name, group in (("raygen", raygen), ("film", film)):
        if group is not None:
            table[name] = group
    monkeypatch.setattr(tracing, "snapshot", lambda: table)
    assert _reader().read(None) == want


def test_none_without_the_port(monkeypatch):
    mod = _reader()
    monkeypatch.setattr(mod, "port_counters", lambda: None)
    assert mod.read(None) is None

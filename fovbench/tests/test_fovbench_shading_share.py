"""The reader of the port's ``shade`` counts
(``metrics/shading_kernel_share.py``) on hand-made counter tables: the
bounces shaded by the hand-written kernels over all bounces, in percent;
None where the port keeps no such counts (a port without the group, or
one that shaded nothing)."""

import pytest

from fovbench import harness
from conftest import BENCH


def _reader():
    return harness.load_metric(BENCH, "shading_kernel_share")


@pytest.mark.parametrize("shade,want", [
    ({"kernel": 12}, 100.0),
    ({"kernel": 9, "plain": 3}, 75.0),
    ({"plain": 4}, 0.0),
    ({}, None),
    (None, None),
])
def test_share_of_bounces_on_the_kernels(monkeypatch, shade, want):
    from fovpathtracing_optixcodelatest_tpu_torch.utils import tracing

    table = {"frames": 3, "ns": {}, "ns_total": {}, "syncs": {},
             "lanes": {0: 10}}
    if shade is not None:
        table["shade"] = shade
    monkeypatch.setattr(tracing, "snapshot", lambda: table)
    assert _reader().read(None) == want


def test_none_without_the_port(monkeypatch):
    from fovbench import spans

    monkeypatch.setattr(spans, "port_counters", lambda: None)
    mod = _reader()
    monkeypatch.setattr(mod, "port_counters", lambda: None)
    assert mod.read(None) is None

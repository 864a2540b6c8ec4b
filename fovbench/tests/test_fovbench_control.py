"""The check fails what it has to fail, at the tiny size on the CPU: the
bfloat16 control, and whole runs with the timed path broken underneath
(a step that leaves its state unchanged, half of every pixel's samples
left out with the mean over the rest, an answer altered where it is
produced). The cells run on one card: no exchange between cards to leave
out."""

import pytest
import torch

from fovbench import control, harness

PORT = "fovpathtracing_optixcodelatest_tpu_torch"


@pytest.mark.parametrize("cell", ["tiny.fixate", "tiny.stereo_saccade"])
def test_bfloat16_control_fails(tiny, cell):
    r = control.readings(tiny, cell, 11, 8, "cpu", torch.bfloat16)
    assert r["fails"], r


def _unchanged_state(monkeypatch):
    from fovpathtracing_optixcodelatest_tpu_torch.render import film

    monkeypatch.setattr(film, "composite_pass",
                        lambda canvas, *a, **k: canvas)


def _half_the_samples(monkeypatch):
    from fovpathtracing_optixcodelatest_tpu_torch.render import renderer

    real = renderer.pass_slot_values

    def half(*a, **k):
        vals = real(*a, **k)
        for v in vals:
            for f, x in v.items():
                k2 = x.shape[1] // 2
                if k2:
                    v[f] = torch.cat([x[:, :k2], x[:, :x.shape[1] - k2]], 1)
        return vals

    monkeypatch.setattr(renderer, "pass_slot_values", half)


def _altered_answer(monkeypatch):
    from fovpathtracing_optixcodelatest_tpu_torch.render import renderer

    real = renderer.trace_paths

    def altered(*a, **k):
        out = real(*a, **k)
        out["radiance"][::2] *= 1.5
        return out

    monkeypatch.setattr(renderer, "trace_paths", altered)


@pytest.mark.parametrize("cell", ["tiny.fixate", "tiny.stereo_saccade"])
@pytest.mark.parametrize("fault", [_unchanged_state, _half_the_samples,
                                   _altered_answer])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    fault(monkeypatch)
    res, _ = harness.run_cell(tiny, cell, 2 ** 31 + 77, 0.3, False, "cpu")
    assert not res["correct"], res["checks"]
    assert res["failed"] > 0

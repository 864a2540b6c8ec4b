"""The traffic generator repeats exactly from its seed."""

import numpy as np
import pytest

from conftest import BENCH
from fovbench import traffic


@pytest.mark.parametrize("mix", ["fixate", "stereo_saccade"])
def test_mix_repeats_from_seed(mix):
    spec = traffic.load(BENCH, mix)
    seed = 2 ** 31 + 12345  # more than 32 signed bits hold
    a = traffic.Traffic(spec, seed, 960, 540)
    b = traffic.Traffic(spec, seed, 960, 540)
    frames = range(0, 5000, 7)
    assert [a.gaze(f) for f in frames] == [b.gaze(f) for f in frames]
    assert a.eyes == (2 if mix == "stereo_saccade" else 1)


def test_fixate_holds_the_centre():
    t = traffic.Traffic(traffic.load(BENCH, "fixate"), 5, 960, 540)
    assert {t.gaze(f) for f in range(100)} == {(480, 270)}


def test_saccades_follow_their_parameters():
    """Fixations last the mix's milliseconds at its refresh, and saccades
    its degrees through the eye's focal length, on average."""
    spec = traffic.load(BENCH, "stereo_saccade")
    g = spec["gaze"]
    t = traffic.Traffic(spec, 9, 960, 540)
    path = np.asarray([t.gaze(f) for f in range(30000)])
    assert (path >= 0).all() and (path[:, 0] < 960).all() \
        and (path[:, 1] < 540).all()
    moves = np.nonzero(np.abs(np.diff(path, axis=0)).sum(1))[0]
    # about a thousand fixations: their means lie within 10% of the mix's
    # (a saccade that rounds to no move joins two fixations: a few %)
    held_ms = np.diff(moves).mean() * 1000.0 / g["refresh_hz"]
    assert held_ms == pytest.approx(g["fixation_ms"]["mean"], rel=0.1)
    jump = np.hypot(*np.diff(path, axis=0)[moves].T)
    deg = np.degrees(np.arctan(jump / t.px_per_radian))
    assert deg.mean() == pytest.approx(g["amplitude_deg"]["mean"], rel=0.1)
    # fov_y 90 over 540 rows: 270 px a radian, 4.71 px a degree
    assert t.px_per_radian == pytest.approx(270.0)
    other = traffic.Traffic(spec, 10, 960, 540)
    assert [other.gaze(f) for f in range(2000)] != \
        [t.gaze(f) for f in range(2000)]

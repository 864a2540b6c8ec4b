"""A seed changes only the order of a saccade mix's fixations, not which
they are, so that it does not change how much work a run holds."""

import pytest

from conftest import BENCH
from fovbench import traffic


@pytest.mark.parametrize("size", [(960, 540), (1800, 1920)])
def test_every_seed_tours_the_same_fixations(size):
    """A seed picks only the frame of the tour a run starts at: over whole
    tours every seed holds each gaze equally often, and over a window of any
    length each gaze's count differs between seeds by less than a tour's."""
    spec = traffic.load(BENCH, "stereo_saccade")
    runs = [traffic.Traffic(spec, s, *size)
            for s in (1, 2 ** 31 + 7, 4_000_000_011)]
    tour = len(runs[0]._path)
    stops = {tuple(p) for p in runs[0]._path}
    assert 2 <= len(stops) <= 2 * spec["gaze"]["tour"]["saccades"]
    per_tour = {p: int((runs[0]._path == p).all(1).sum()) for p in stops}
    for window in (tour, 3 * tour, 3001):
        counts = []
        for t in runs:
            seen = [t.gaze(f) for f in range(window)]
            counts.append({p: seen.count(p) for p in stops})
            assert set(seen) <= stops
        for p in stops:
            got = [c[p] for c in counts]
            assert max(got) - min(got) <= per_tour[p]
            if window % tour == 0:
                assert got == [per_tour[p] * (window // tour)] * len(runs)
    assert [runs[0].gaze(f) for f in range(tour)] != \
        [runs[1].gaze(f) for f in range(tour)]

"""Spans and counters at the layer boundaries inside a frame.

``span(name)`` times a block on the host clock (``time.perf_counter_ns``)
and adds to ``COUNTERS``: its self time (its duration less the part its
child spans cover) under ``"ns"`` and its whole duration under
``"ns_total"``, each keyed by the span's name. While the
PyTorch profiler records, a span also opens ``record_function(name)``, so
it lands in the profiler's Chrome trace as a ``user_annotation`` event on
the clock of the kernels, copies and runtime calls. Whether the profiler
records is read once, when the outermost span opens (a frame's
``fov.frame``), and holds for every span inside it.

``sync(site)`` is the span ``fov.sync.<site>`` around a call that waits
for the device (the live-lane ``nonzero``, a bounce's boolean narrowing,
the frame's download) and counts one sync under ``"syncs"``. ``count``
adds to an integer counter, such as ``"lanes"`` (the lanes that enter each
bounce, keyed by depth) and ``"shade"`` (the bounces shaded, keyed
``"kernel"`` or ``"plain"`` by the path ``trace_paths`` took).
``frame()`` is the span ``fov.frame`` and counts one displayed frame under
``"frames"``; ``wavefront()`` counts one ``trace_paths`` call under
``"wavefronts"`` (a mono frame makes one, a stereo pair two, a
multi-device frame one a slice).

Nothing here reads a tensor: a count that only the device knows is never
read on the frame path, so the tracing adds no sync. With the profiler off
a span costs two clock reads and a few integer additions under a lock.
Each thread keeps its own stack of open spans; the counters are shared.

``snapshot()`` copies ``COUNTERS``; ``diff(a, b)`` is what happened
between two snapshots.

The frame's spans: ``fov.frame`` (``Renderer.render`` and ``render_aov``,
``StereoRenderer.render`` a pair), ``fov.eye.<e>`` (eye ``e``'s
``render_frame`` in a stereo pair), ``fov.raygen`` (the passes' rays and
their merge in ``frame_wavefront``), ``fov.paths`` (``trace_paths``),
``fov.bounce.<depth>`` (a bounce of its loop), ``fov.k1`` and ``fov.k2``
(the traversal wrappers), ``fov.film`` (``composite_passes``),
``fov.tonemap`` (``film.finalize``); its syncs ``live_lanes``, ``narrow``,
``download`` and, for a stereo pair, ``traces``.
"""

from __future__ import annotations

import copy
import functools
import threading
import time

import torch.autograd.profiler as _autograd_profiler
from torch.profiler import record_function

FRAME = "fov.frame"
RAYGEN = "fov.raygen"
PATHS = "fov.paths"
K1 = "fov.k1"
K2 = "fov.k2"
FILM = "fov.film"
TONEMAP = "fov.tonemap"
BOUNCE_PREFIX = "fov.bounce."
EYE_PREFIX = "fov.eye."
SYNC_PREFIX = "fov.sync."

SCALARS = ("frames", "wavefronts")
GROUPS = ("ns", "ns_total", "syncs", "lanes", "shade")
COUNTERS: dict = {**{s: 0 for s in SCALARS}, **{g: {} for g in GROUPS}}

_lock = threading.Lock()  # COUNTERS' updates (the viewer renders on two
# threads at once)


class _Thread(threading.local):
    """A thread's open spans ([start ns, child ns], innermost last) and the
    profiler's state when its outermost span opened."""

    def __init__(self):
        self.open = []
        self.recording = False


_thread = _Thread()


def _add(group: str, key, n: int) -> None:
    """Add ``n`` to ``COUNTERS[group][key]``; the caller holds ``_lock``."""
    g = COUNTERS[group]
    g[key] = g.get(key, 0) + n


class _Span:
    __slots__ = ("name", "_rf")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        t = _thread
        if not t.open:
            t.recording = _autograd_profiler._is_profiler_enabled
        if t.recording:
            self._rf = record_function(self.name)
            self._rf.__enter__()
        t.open.append([time.perf_counter_ns(), 0])
        return self

    def __exit__(self, *exc):
        opened = _thread.open
        start, child = opened.pop()
        dur = time.perf_counter_ns() - start
        if opened:
            opened[-1][1] += dur
        with _lock:
            _add("ns", self.name, dur - child)
            _add("ns_total", self.name, dur)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str) -> _Span:
    """A context manager timing the block under ``name``."""
    return _Span(name)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def bounce(depth: int) -> _Span:
    """The span of bounce ``depth`` of ``trace_paths``' loop."""
    return _Span(BOUNCE_PREFIX + str(depth))


def eye(e: int) -> _Span:
    """The span of eye ``e`` of a stereo pair."""
    return _Span(EYE_PREFIX + str(e))


def sync(site: str) -> _Span:
    """The span ``fov.sync.<site>`` around a call that waits for the
    device; counts one sync at ``site``."""
    with _lock:
        _add("syncs", site, 1)
    return _Span(SYNC_PREFIX + site)


def frame() -> _Span:
    """The span of one displayed frame; counts it."""
    with _lock:
        COUNTERS["frames"] += 1
    return _Span(FRAME)


def wavefront() -> None:
    """Count one ``trace_paths`` wavefront. (Each call also makes one
    ``live_lanes`` sync today; the count is kept apart from it so that it
    still reads when that sync goes.)"""
    with _lock:
        # a table made from ``GROUPS`` and ``"frames"`` alone, as callers
        # that restart the counters have made it, lacks the key
        COUNTERS["wavefronts"] = COUNTERS.get("wavefronts", 0) + 1


def count(group: str, key, n: int) -> None:
    """Add the host integer ``n`` to counter ``key`` of ``group``."""
    with _lock:
        _add(group, key, n)


def snapshot() -> dict:
    """A copy of ``COUNTERS``."""
    with _lock:
        return copy.deepcopy(COUNTERS)


def diff(a: dict, b: dict) -> dict:
    """Snapshot ``b`` less snapshot ``a``: each scalar count that either
    holds (``frames``, ``wavefronts``) and, in each group, the keys whose
    count changed."""
    out = {s: b.get(s, 0) - a.get(s, 0) for s in SCALARS if s in a or s in b}
    for group in GROUPS:
        was, now = a.get(group, {}), b.get(group, {})
        out[group] = {k: now.get(k, 0) - was.get(k, 0)
                      for k in {**was, **now}
                      if now.get(k, 0) != was.get(k, 0)}
    return out

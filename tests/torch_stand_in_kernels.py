"""A stand-in for the port's CUDA libraries, for the CPU tests of the
kernel binding seam: the ``stand_in_kernels`` fixture replaces
``kernel_build``'s libraries by one ``StandInLibrary``, its stream by
0x5712 and its launch counts by a fresh Counter. Each launch entry's call
is recorded with a copy of its argument struct (``STRUCTS``). A test file
that uses it imports the fixture by name."""

import collections
import ctypes

import pytest

from fovpathtracing_optixcodelatest_tpu_torch.ops import frame
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops import lanes
from fovpathtracing_optixcodelatest_tpu_torch.ops import packet_traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops import shade
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

# every launch entry's argument struct
STRUCTS = {"fov_traverse": traverse.TraverseArgs,
           "fov_occluded_packets": packet_traverse.PacketArgs,
           "fov_shade": shade.ShadeArgs, "fov_resolve": shade.ResolveArgs,
           "fov_compact": lanes.CompactArgs, "fov_raygen": frame.RaygenArgs,
           "fov_film": frame.FilmArgs}


class StandInEntry:
    """One entry of a ``StandInLibrary``. Like a ctypes function, it keeps
    the ``argtypes`` it is given and converts its arguments by them."""

    def __init__(self, lib, name):
        self.lib, self.name, self.argtypes = lib, name, None

    def __call__(self, *args):
        if self.argtypes is not None:
            args = tuple(t(a) for t, a in zip(self.argtypes, args))
        cls = self.lib.structs.get(self.name)
        copy = None if cls is None else cls.from_buffer_copy(
            ctypes.string_at(args[0].value, ctypes.sizeof(cls)))
        self.lib.calls.append((self.name, args, copy))
        return self.lib.rc


class StandInLibrary:
    """Every entry returns ``rc`` and records (entry, arguments), with a
    copy of the argument struct where ``structs`` names its class (each
    launch entry's, ``STRUCTS``)."""

    def __init__(self):
        self.rc = 0
        self.calls = []
        self.structs = dict(STRUCTS)

    def __getattr__(self, entry):
        if entry.startswith("__"):
            raise AttributeError(entry)
        fn = StandInEntry(self, entry)
        setattr(self, entry, fn)  # as ctypes keeps each entry it looks up
        return fn


@pytest.fixture
def stand_in_kernels(monkeypatch):
    lib = StandInLibrary()
    monkeypatch.setattr(kernel_build, "library", lambda source: lib)
    monkeypatch.setattr(kernel_build, "stream", lambda: 0x5712)
    monkeypatch.setattr(kernel_build, "LAUNCHES", collections.Counter())
    return lib

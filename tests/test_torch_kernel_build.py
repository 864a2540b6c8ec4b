"""The seam between the ops modules and the CUDA sources, on the CPU.

Every launch entry of ``csrc/*.cu`` takes one argument struct and the
stream; each struct is declared once more in Python as a
``ctypes.Structure``, which must match the C declaration field for field.
``kernel_build.launch`` is held to its contract against a stand-in library
(the ``stand_in_kernels`` fixture of
``tests/torch_stand_in_kernels.py``): the struct and the stream go to C as
``c_void_p``, a non-zero return raises, and each launch counts once.
"""

import ctypes
import os
import re

import pytest
import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import frame as frame_ops
from fovpathtracing_optixcodelatest_tpu_torch.ops import kernel_build
from fovpathtracing_optixcodelatest_tpu_torch.ops import lanes
from fovpathtracing_optixcodelatest_tpu_torch.ops import packet_traverse
from fovpathtracing_optixcodelatest_tpu_torch.ops import shade
from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse
from torch_stand_in_kernels import STRUCTS
from torch_stand_in_kernels import stand_in_kernels  # noqa: F401 (a fixture)


def _read(*names) -> str:
    out = ""
    for name in names:
        with open(os.path.join(kernel_build.CSRC, name)) as f:
            out += f.read()
    return out


def _c_struct(src: str, name: str):
    """(C type, field name, array length or None, is pointer) of each field
    of struct ``name`` in ``src``, in order."""
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S)[1]
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        m = re.match(r"(const )?([\w ]+?)\s*(\*)?\s*(\w+(?:\[\w+\])?"
                     r"(?:, \w+(?:\[\w+\])?)*)$", decl)
        assert m, decl
        for field in m[4].split(", "):
            f = re.match(r"(\w+)(?:\[(\w+)\])?$", field)
            out.append((m[2], f[1], f[2], m[3] is not None))
    return out


_CTYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
           "unsigned int": ctypes.c_uint, "float": ctypes.c_float,
           "PassGrid": frame_ops.PassGrid, "FilmPass": frame_ops.FilmPass}
_LENGTHS = {"kMaxPasses": frame_ops.MAX_PASSES}
# the tensor dtype a pointer's C type points to
_C_DTYPES = {"int64_t": torch.int64, "float": torch.float32,
             "int32_t": torch.int32, "bool": torch.bool,
             "long long": torch.int64, "unsigned": torch.int32}


@pytest.mark.parametrize("sources,name,cls,dtypes", [
    (("shade.cu",), "ShadeArgs", shade.ShadeArgs, shade.SHADE_TENSORS),
    (("shade.cu",), "ResolveArgs", shade.ResolveArgs,
     shade.RESOLVE_TENSORS),
    (("pass_grid.cuh",), "PassGrid", frame_ops.PassGrid, None),
    (("frame.cu",), "FilmPass", frame_ops.FilmPass, None),
    (("frame.cu",), "RaygenArgs", frame_ops.RaygenArgs, None),
    (("frame.cu",), "FilmArgs", frame_ops.FilmArgs, None),
    (("traverse.cu",), "TraverseArgs", traverse.TraverseArgs, None),
    (("packet_traverse.cu",), "PacketArgs", packet_traverse.PacketArgs,
     None),
    (("lanes.cu",), "CompactArgs", lanes.CompactArgs, lanes.COMPACT_TENSORS),
], ids=lambda x: x if isinstance(x, str) else "")
def test_structs_match_the_c_declarations(sources, name, cls, dtypes):
    fields = _c_struct(_read(*sources), name)
    assert [f[1] for f in fields] == [f[0] for f in cls._fields_]
    for (ctype, fname, length, ptr), (_, ty) in zip(fields, cls._fields_):
        if ptr:
            assert ty is ctypes.c_void_p, fname
            if dtypes is not None:  # each pointer points to its dtype
                assert _C_DTYPES[ctype] == dtypes[fname], fname
        elif length is not None:
            assert ty._length_ == _LENGTHS[length], fname
            assert ty._type_ is _CTYPES[ctype], fname
        else:
            assert ty is _CTYPES[ctype], fname
    if dtypes is not None:  # the tensors first, then the integers
        assert [f[1] for f in fields][:len(dtypes)] == list(dtypes)
    # no padding between fields: each starts where the last one ended
    at = 0
    for fname, ty in cls._fields_:
        assert getattr(cls, fname).offset == at, fname
        at += ctypes.sizeof(ty)


def test_launch_passes_the_struct_and_the_stream(stand_in_kernels):
    lib = stand_in_kernels
    lib.structs["fov_traverse"] = traverse.TraverseArgs
    args = traverse.TraverseArgs(which=3, n=7, arity=32, leaf=12)
    kernel_build.launch("traverse", "fov_traverse", "occluded_instanced",
                        args)
    kernel_build.launch("traverse", "fov_traverse", "occluded_instanced",
                        args)
    assert kernel_build.LAUNCHES == {"occluded_instanced": 2}
    entry, passed, copy = lib.calls[0]
    assert entry == "fov_traverse" and len(passed) == 2
    # a bare Python int would go to C as a 32-bit int
    assert lib.fov_traverse.argtypes == (ctypes.c_void_p, ctypes.c_void_p)
    assert all(type(a) is ctypes.c_void_p for a in passed)
    assert passed[0].value == ctypes.addressof(args)
    assert passed[1].value == 0x5712
    assert (copy.which, copy.n, copy.arity, copy.leaf) == (3, 7, 32, 12)

    lib.rc = 700  # cudaErrorIllegalAddress
    with pytest.raises(RuntimeError, match="occluded_instanced.*700"):
        kernel_build.launch("traverse", "fov_traverse", "occluded_instanced",
                            args)
    assert kernel_build.LAUNCHES == {"occluded_instanced": 2}


def test_every_launch_entry_has_its_struct():
    """The stand-in records every launch entry's struct: each
    ``extern "C" int fov_<entry>(const <Struct>* a, cudaStream_t)`` of
    ``csrc/`` names the struct its ctypes twin declares."""
    src = _read(*(f"{s}.cu" for s in kernel_build.SOURCES))
    entries = dict(re.findall(
        r'extern "C" int (fov_\w+)\(const (\w+)\* a, cudaStream_t', src))
    assert entries.keys() == STRUCTS.keys()
    for entry, struct in entries.items():
        assert STRUCTS[entry].__name__ == struct, entry


def test_lane_counts_go_to_the_kernels_as_pointers():
    """The traversal and shading structs carry the lane count the device
    holds as a pointer after their other tensors, before the integers."""
    for cls, last in ((traverse.TraverseArgs, "which"),
                      (shade.ShadeArgs, "n"), (shade.ResolveArgs, "n")):
        names = [f[0] for f in cls._fields_]
        assert names[names.index(last) - 1] == "count", cls.__name__
        assert dict(cls._fields_)["count"] is ctypes.c_void_p

"""The port's public names against the JAX package's, read from both
packages' sources with ``ast`` (neither package is imported).

Modules pair by their path in the package. The one exception is JAX's
``ops/traverse.py``, the threaded BVH's per-ray walk, whose port is
``ops/traverse_threaded.py``: the port's ``ops/traverse.py`` holds K1/K2
(JAX's ``ops/traverse8.py`` walks), which JAX's ``ops/traverse8.py`` names
the port also keeps, in its own ``ops/traverse8.py``.

For each JAX module the port's must have each public function, class,
method, class-level field (a dataclass's fields), attribute set in
``__init__`` (the port's may be set in any method) and module-level name
(a constant, or an import that binds the name); each keyword a JAX
function or method takes; and JAX's positional parameters as a prefix of
the port's. ``ALLOWED`` lists what the port leaves out on purpose, each
with its reason; an entry naming a class covers its members. Arguments
that the port accepts and refuses (``ops/traverse8.py``'s ``t_seed``,
``iter_cap``, ``entry0``, ``return_pending``, ``return_pops``) are there as
keywords, so they need no entry.
"""

from __future__ import annotations

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = os.path.join(ROOT, "fovpathtracing_optixcodelatest_tpu")
PORT = os.path.join(ROOT, "fovpathtracing_optixcodelatest_tpu_torch")
# JAX's ops/traverse.py is the threaded BVH's walk; the port's
# ops/traverse.py is K1/K2, so the threaded walk took another name
RENAMED = {"ops/traverse.py": "ops/traverse_threaded.py"}

_SCHEDULE = ("a TPU schedule left out by design (ROADMAP: the integrator's "
             "compaction and phase-1 caps): it shapes XLA's fixed-shape "
             "work, not the frame")
_PYTREE = ("JAX's pytree of per-triangle or per-material arrays; the port "
           "carries them as tri_pack rows and MaterialView")
_TRAVERSE8 = ("a knob of traverse8's XLA lockstep loops (chunks, streams, "
              "drains, windows, treelet rounds); the port's kernels walk "
              "a ray a lane (or a group) to its end")
_PALLAS = ("the Pallas kernel's TPU packet of 8 sublanes x 128 lanes; K3 "
           "walks a warp's 32 rays a packet")

# "module:name" (a name), "module:func(kw=)" (a keyword) or
# "module:func(order)" (positional order) -> why the port leaves it out
ALLOWED = {
    **{f"config.py:RenderConfig.{f}": _SCHEDULE for f in (
        "compact_bounces", "frame_compaction", "traversal_phase1_cap",
        "traversal_cap_auto", "traversal_phase1_cap_primary", "need_aov")},
    "render/raygen.py:pass_active_bound": (
        "a static bound on a pass's live lanes for XLA's fixed shapes; the "
        "port's lanes are sized at run time"),
    "render/integrator.py:phase1_cap": _SCHEDULE,
    "render/integrator.py:trace_paths(rays_packed=)": _SCHEDULE,
    **{f"render/integrator.py:{c}": _SCHEDULE for c in (
        "OCCL_STAGE", "OCCL_CAP", "OCCL_STACK", "OCCL_CHUNK", "P1_CHUNK",
        "P2_INPLACE")},
    "parallel/tiles.py:AXIS": (
        "the name of JAX's device-mesh axis; the port's mesh is a list of "
        "torch devices"),
    "models/texture.py:QUAD_MAX_TEXELS": (
        "the size bound of JAX's quad rows, a TPU gather layout; the port "
        "samples its four taps from the padded array"),
    "models/texture.py:TextureArray.quad": (
        "JAX's quad rows (one gather for four taps on the TPU); the port "
        "reads the taps from the padded array"),
    "ops/bvh8.py:WideBVH.top_table": (
        "JAX's second copy of a treelet table's top rows for the TPU's "
        "VMEM; every port walk reads them from the table"),
    "models/mesh.py:SceneGeometry": _PYTREE,
    "models/material.py:MaterialTable": _PYTREE,
    "models/scene.py:Scene.geom": _PYTREE,
    "models/scene.py:Scene.materials": _PYTREE,
    "models/mesh.py:flatten_meshes(slim=)": (
        "JAX's slim SceneGeometry (no per-triangle arrays beside tri_pack); "
        "the port has only tri_pack"),
    "models/mesh.py:SLIM_TRIS_THRESHOLD": (
        "the size from which JAX builds the slim SceneGeometry; the port "
        "has no SceneGeometry"),
    "ops/intersect.py:brute_force_closest_hit(geom=)": (
        "JAX's brute force reads SceneGeometry; the port's reads tri_pack "
        "(its scene=)"),
    "ops/intersect.py:brute_force_occluded(geom=)": (
        "JAX's brute force reads SceneGeometry; the port's reads tri_pack "
        "(its scene=)"),
    "ops/spectrum.py:cie_xyz_bar_jnp": (
        "the CIE table as a jax array; the port's cie_xyz_bar gives it as "
        "a tensor"),
    **{f"parallel/multihost.py:worker({k}=)": (
        "jax.distributed's arguments; the port's worker joins "
        "torch.distributed by (rank, world, init_method)")
       for k in ("process_id", "num_processes", "coordinator",
                 "local_devices")},
    "ops/bvh_native.py:BVH_CACHE_DIR": (
        "JAX reads FOVTPU_BVH_CACHE once at import, default under /tmp; "
        "the port reads it at each build (cache_dir()), default inside "
        "its checkout"),
    "render/renderer.py:Renderer.__init__(order)": (
        "JAX's order is (meshes, scene, config, ...); the port's first "
        "positional argument takes meshes or a built Scene and keeps "
        "(scene, config, schedule) positional, which its callers use; "
        "meshes=, scene=, probe= and texture_images= are keywords of both"),
    **{f"ops/traverse8.py:{c}": _TRAVERSE8 for c in (
        "DEFAULT_DRAINS", "DEFAULT_STREAMS", "DYN_TRIP", "SUB",
        "WINDOW_ROWS", "TREELET_ROUNDS", "TREELET_K", "OCCL_TREELET")},
    **{f"ops/pallas_traverse.py:{c}": _PALLAS
       for c in ("SUBLANES", "LANES", "PACKET")},
}


def _public(name: str) -> bool:
    return not any(p.startswith("_") and p != "__init__"
                   for p in name.split("."))


def _signature(fn: ast.FunctionDef):
    a = fn.args
    positional = [x.arg for x in a.posonlyargs + a.args]
    return positional, positional + [x.arg for x in a.kwonlyargs]


def _self_attrs(fn: ast.FunctionDef) -> set:
    out = set()
    for node in ast.walk(fn):
        targets = (node.targets if isinstance(node, ast.Assign) else
                   [node.target] if isinstance(node, ast.AnnAssign) else [])
        for t in targets:
            if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                out.add(t.attr)
    return out


def names(path: str, port: bool = False) -> dict:
    """{name: signature or None} of a module's top-level functions,
    classes and assignments, and each class's methods, fields and
    attributes (``Class.name``) set in ``__init__``; a function's
    signature is (positional names, every named parameter). With ``port``
    also the names its imports bind, and attributes set in any method."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _signature(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{b.name}"] = _signature(b)
                    if port or b.name == "__init__":
                        for attr in _self_attrs(b):
                            out.setdefault(f"{node.name}.{attr}", None)
                elif isinstance(b, ast.AnnAssign) and isinstance(
                        b.target, ast.Name):
                    out[f"{node.name}.{b.target.id}"] = None
                elif isinstance(b, ast.Assign):
                    for t in b.targets:
                        if isinstance(t, ast.Name):
                            out[f"{node.name}.{t.id}"] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = None
        elif port and isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out[(alias.asname or alias.name).split(".")[0]] = None
    return out


def jax_modules() -> list:
    out = []
    for dirpath, _, files in os.walk(JAX):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, f), JAX))
    return sorted(out)


def _allowed(module: str, item: str) -> bool:
    """Whether ``item`` of ``module`` is allowed out: by its own entry, or
    by its class's."""
    if f"{module}:{item}" in ALLOWED:
        return True
    owner = item.split("(")[0].split(".")[0]
    return f"{module}:{owner}" in ALLOWED


def lacks(jax_path: str, port_path: str) -> list:
    """What the module at ``port_path`` lacks of the JAX module at
    ``jax_path``, each as an ``ALLOWED`` key names it after the colon."""
    jax_names = names(jax_path)
    port_names = names(port_path, port=True)
    out = []
    for name, sig in jax_names.items():
        if not _public(name):
            continue
        if name not in port_names:
            out.append(name)
            continue
        port_sig = port_names[name]
        if sig is None or port_sig is None:
            continue
        (j_pos, j_all), (p_pos, p_all) = sig, port_sig
        absent = [k for k in j_all if k not in p_all]
        out += [f"{name}({k}=)" for k in absent]
        if not absent and p_pos[:len(j_pos)] != j_pos:
            out.append(f"{name}(order)")
    return out


def missing(module: str) -> list:
    """What the port's counterpart of JAX's ``module`` lacks."""
    port_path = os.path.join(PORT, RENAMED.get(module, module))
    if not os.path.exists(port_path):
        return [f"{module}: no port module"]
    return lacks(os.path.join(JAX, module), port_path)


@pytest.mark.parametrize("module", jax_modules())
def test_port_has_each_public_name_of_the_jax_module(module):
    absent = [m for m in missing(module) if not _allowed(module, m)]
    assert not absent, \
        f"the port's {RENAMED.get(module, module)} lacks {absent}"


def test_every_allowance_has_a_reason_and_is_needed():
    # each entry names something JAX has and the port lacks: a repair
    # leaves no stale entry behind
    needed = {f"{m}:{x}" for m in jax_modules() for x in missing(m)}
    classes = {k.split(".")[0] for k in needed}
    for key, reason in ALLOWED.items():
        assert isinstance(reason, str) and len(reason) > 20, key
        assert key in needed or key in classes, f"stale entry {key}"


def test_the_sweep_reports_names_keywords_and_orders(tmp_path):
    # a constant, a method, a positional order and a keyword the port's
    # module lacks are reported; an attribute set in another method, a
    # name bound by an import and a private name are not
    jax_src, port_src = tmp_path / "jax.py", tmp_path / "port.py"
    jax_src.write_text(
        "X = 1\n"
        "class C:\n"
        "    y: int = 0\n"
        "    def __init__(self):\n"
        "        self.z = 0\n"
        "    def m(self):\n"
        "        pass\n"
        "def f(a, b, c=0):\n"
        "    pass\n"
        "def k(a, b=0):\n"
        "    pass\n"
        "def g():\n"
        "    pass\n"
        "def _h():\n"
        "    pass\n")
    port_src.write_text(
        "from os import path as g\n"
        "class C:\n"
        "    y: int = 0\n"
        "    def __init__(self):\n"
        "        self.reset()\n"
        "    def reset(self):\n"
        "        self.z = 0\n"
        "def f(a, c, b=0):\n"
        "    pass\n"
        "def k(a):\n"
        "    pass\n")
    assert lacks(str(jax_src), str(port_src)) == [
        "X", "C.m", "f(order)", "k(b=)"]

"""The JAX package's traversal entry points under their own names and
signatures (its ``ops/traverse8.py``), on the port's walks.

Each function takes the JAX function's arguments in its order, with the
port's ``DeviceBVH`` (``scene.bvh``) where JAX takes a ``WideBVH``, and
forwards to ``ops/traverse.py``: ``closest_hit`` (K1, or its two-level
variant) and ``occluded`` (K2, its two-level and non-culling
instantiations) on a CUDA table, their plain versions on a CPU one. The
render path calls ``ops/traverse.py`` directly.

The results are JAX's: ``closest_hit`` and its staged and treelet forms
return dict(t, tri_id, u, v, hit, pending) of (N,) tensors, and ``inst``
on a two-level table; ``occluded`` and ``occluded_treelet`` an (N,) bool
tensor. ``pending`` is all False: the port walks every ray to its end, as
JAX's full walk leaves none pending. JAX's ``pops`` (a lane's pops) and
``steps`` (its chunks' loop trips) count the TPU's lockstep loop and are
left out. The staged and treelet forms give the full walk's result, which
is their JAX contract.

Arguments that only shape the TPU's schedule are accepted and have no
effect: ``chunk`` (lanes a ``lax.map`` chunk), ``window`` (the windowed
gathers), ``max_steps`` at or above its default (a loop bound no ray
reaches), ``phase1_cap``/``phase1_stack`` (``closest_hit_staged``'s
phase 1), ``rounds``/``k_near`` (the treelet rounds). Those that change
JAX's answer raise ``NotImplementedError`` naming their TPU schedule:
``t_seed`` and ``iter_cap`` (the staged walk's re-trace and phase-1 cap),
``entry0`` (a treelet round's start entries), ``return_pending`` and
``return_pops`` (the staged occlusion's re-trace), and a ``max_steps``
below its default (rays cut off pending). ``stack_cap`` caps the stack
depth, as JAX's does: each ray answers as JAX's capped walk does where
JAX's does not flag it pending (its stack overflowed), but no ray is
flagged.
"""

from __future__ import annotations

import os

import torch

from fovpathtracing_optixcodelatest_tpu_torch.ops import traverse

# JAX's default lanes a chunk (FOVTPU_CHUNK there); a schedule argument
DEFAULT_CHUNK = 1 << 15
# JAX's default loop bound of one chunk; no walk reaches it
DEFAULT_MAX_STEPS = 100_000
# the row bound of JAX's treelet routing (FOVTPU_TMAXROWS; 0: never)
TREELET_MAX_ROWS = int(os.environ.get("FOVTPU_TMAXROWS", 0))


def _refuse(**schedule) -> None:
    """Raise for the first argument given that changes JAX's answer;
    ``schedule`` maps each to (its value is given, the TPU schedule it
    belongs to)."""
    for name, (given, where) in schedule.items():
        if given:
            raise NotImplementedError(
                f"{name} belongs to the JAX package's {where}, which the "
                "port does not run: it walks every ray to its end")


def _rays(bvh, origin, direction, active):
    """The rays as contiguous float32 tensors on the table's device and
    the (N,) bool mask (default: every ray)."""
    dev = bvh.table.device
    o = torch.as_tensor(origin, dtype=torch.float32, device=dev).contiguous()
    d = torch.as_tensor(direction, dtype=torch.float32,
                        device=dev).contiguous()
    if active is None:
        active = torch.ones((o.shape[0],), dtype=torch.bool, device=dev)
    else:
        active = torch.as_tensor(active, dtype=torch.bool,
                                 device=dev).contiguous()
    return o, d, active


def _depth(bvh, stack_cap) -> int:
    return (bvh.stack_depth if stack_cap is None
            else min(stack_cap, bvh.stack_depth))


def _closest(bvh, origin, direction, tmin, tmax, active, stack_cap=None):
    o, d, active = _rays(bvh, origin, direction, active)
    out = traverse.closest_hit(bvh.table, o, d, active, float(tmin),
                               float(tmax), _depth(bvh, stack_cap),
                               bvh.arity, bvh.leaf_size,
                               **bvh.instance_kwargs)
    out["pending"] = torch.zeros_like(out["hit"])
    return out


def _occluded(bvh, origin, direction, tmin, tmax, active, cull_backface,
              stack_cap=None):
    o, d, active = _rays(bvh, origin, direction, active)
    return traverse.occluded(bvh.table, o, d, active, float(tmin),
                             float(tmax), _depth(bvh, stack_cap), bvh.arity,
                             bvh.leaf_size, cull_backface=cull_backface,
                             **bvh.instance_kwargs)


def closest_hit(bvh, origin, direction, tmin: float, tmax: float,
                active=None, max_steps: int = DEFAULT_MAX_STEPS,
                chunk: int | None = DEFAULT_CHUNK, t_seed=None,
                iter_cap: int | None = None, stack_cap: int | None = None,
                entry0=None, window: bool = False) -> dict:
    """Closest hit of each active ray -> dict(t, tri_id, u, v, hit,
    pending), and ``inst`` on a two-level table (miss: t = inf, tri_id =
    -1, inst = -1)."""
    _refuse(t_seed=(t_seed is not None, "staged re-trace (closest_hit_staged"
                    " phase 2)"),
            iter_cap=(iter_cap is not None,
                      "phase-1 cap (closest_hit_staged)"),
            entry0=(entry0 is not None, "treelet rounds"),
            max_steps=(max_steps < DEFAULT_MAX_STEPS,
                       "lockstep loop bound"))
    return _closest(bvh, origin, direction, tmin, tmax, active, stack_cap)


def closest_hit_staged(bvh, origin, direction, tmin: float, tmax: float,
                       active=None, max_steps: int = DEFAULT_MAX_STEPS,
                       chunk: int | None = DEFAULT_CHUNK,
                       phase1_cap: int = 12, phase1_stack: int = 16) -> dict:
    """JAX's two-phase closest hit: the full walk's result (``closest_hit``'s
    dict)."""
    _refuse(max_steps=(max_steps < DEFAULT_MAX_STEPS, "lockstep loop bound"))
    return _closest(bvh, origin, direction, tmin, tmax, active)


def use_treelet(bvh) -> bool:
    """JAX's routing predicate for the treelet closest hit: a treelet-laid
    single-level table of at most ``TREELET_MAX_ROWS`` rows."""
    return (bvh.top_rows > 0 and bvh.num_instances == 0
            and bvh.num_rows <= TREELET_MAX_ROWS)


def _treelet_table(bvh) -> None:
    if bvh.top_rows <= 0 or bvh.num_instances:
        raise ValueError("the treelet walks take a treelet-laid "
                         "single-level table (top_rows > 0)")


def closest_hit_treelet(bvh, origin, direction, tmin: float, tmax: float,
                        active=None, max_steps: int = DEFAULT_MAX_STEPS,
                        chunk: int | None = DEFAULT_CHUNK,
                        rounds: int | None = None,
                        k_near: int | None = None) -> dict:
    """JAX's treelet-phased closest hit over a treelet-laid table
    (``top_rows > 0``): the full walk's result (``closest_hit``'s dict)."""
    _treelet_table(bvh)
    _refuse(max_steps=(max_steps < DEFAULT_MAX_STEPS, "lockstep loop bound"))
    return _closest(bvh, origin, direction, tmin, tmax, active)


def occluded(bvh, origin, direction, tmin: float, tmax: float, active=None,
             max_steps: int = DEFAULT_MAX_STEPS,
             chunk: int | None = DEFAULT_CHUNK, cull_backface: bool = True,
             stack_cap: int | None = None, iter_cap: int | None = None,
             return_pending: bool = False, return_pops: bool = False,
             entry0=None, window: bool = False) -> torch.Tensor:
    """Any-hit occlusion with first-hit exit -> (N,) bool; back faces
    occlude only where ``cull_backface`` is False."""
    _refuse(iter_cap=(iter_cap is not None,
                      "phase-1 cap (the staged occlusion)"),
            return_pending=(return_pending, "staged occlusion re-trace"),
            return_pops=(return_pops, "lockstep loop's pop counts"),
            entry0=(entry0 is not None, "treelet rounds"),
            max_steps=(max_steps < DEFAULT_MAX_STEPS,
                       "lockstep loop bound"))
    return _occluded(bvh, origin, direction, tmin, tmax, active,
                     cull_backface, stack_cap)


def occluded_treelet(bvh, origin, direction, tmin: float, tmax: float,
                     active=None, max_steps: int = DEFAULT_MAX_STEPS,
                     chunk: int | None = DEFAULT_CHUNK,
                     cull_backface: bool = True, rounds: int | None = None,
                     k_near: int | None = None) -> torch.Tensor:
    """JAX's treelet-phased occlusion over a treelet-laid table: the full
    walk's (N,) bool."""
    _treelet_table(bvh)
    _refuse(max_steps=(max_steps < DEFAULT_MAX_STEPS, "lockstep loop bound"))
    return _occluded(bvh, origin, direction, tmin, tmax, active,
                     cull_backface)

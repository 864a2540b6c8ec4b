"""Two-level tables for the instanced walks' tests, on the CPU and on the
card: a field of instances of one-leaf BLASes (``small_blas_field``) and a
copy of a table whose instances enter their BLAS at that leaf row
(``leaf_root``)."""

import numpy as np


def _translate(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def _rot_y(deg):
    a = np.radians(deg)
    m = np.eye(4)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = (np.cos(a), np.sin(a), -np.sin(a),
                                          np.cos(a))
    return m


def pyramid_tris():
    """A hexagonal pyramid, an apex over a ring of six corners: (6, 3, 3)
    float32 triangle corners, one leaf row of the packed layout."""
    a = np.linspace(0.0, 2.0 * np.pi, 7)[:-1]
    ring = np.stack([0.4 * np.cos(a), np.zeros(6), 0.4 * np.sin(a)], 1)
    apex = np.array([0.0, 0.8, 0.0])
    return np.stack([np.stack([apex, ring[(k + 1) % 6], ring[k]])
                     for k in range(6)]).astype(np.float32)


def quad_tris():
    """A one-sided 0.8 x 0.8 quad facing +y: (2, 3, 3) float32 corners."""
    p = np.array([[-0.4, 0.3, -0.4], [0.4, 0.3, -0.4], [0.4, 0.3, 0.4],
                  [-0.4, 0.3, 0.4]])
    return np.stack([p[[0, 2, 1]], p[[0, 3, 2]]]).astype(np.float32)


def small_blas_field():
    """(unique triangles, mesh ids, transforms) of a 4 x 4 field of pyramids
    and quads on a 1.5 grid, every third turned 35 degrees, and a mirrored
    pyramid beside it: BLASes of at most 6 triangles."""
    ids, mats = [], []
    for k in range(16):
        m = _translate((k // 4) * 1.5, 0.0, (k % 4) * 1.5)
        if k % 3 == 1:
            m = m @ _rot_y(35.0)
        ids.append(k % 2)
        mats.append(m)
    ids.append(0)
    mats.append(_translate(2.0, 0.0, 6.5) @ np.diag([-1.0, 1.0, 1.0, 1.0]))
    return [pyramid_tris(), quad_tris()], ids, mats


def leaf_root(table, inst_base, blas_base, arity):
    """A copy of the two-level ``table`` (numpy float32) whose instance rows
    enter each BLAS at its root node's only child, a leaf row: the instances
    of a BLAS whose root is a leaf."""
    out = np.array(table, dtype=np.float32, copy=True)
    words = out.view(np.uint32)
    for r in range(inst_base, blas_base):
        root = int(words[r, 0]) >> 2
        kids = words[root, 3 * arity: 4 * arity]
        kids = kids[kids != 0]
        assert len(kids) == 1 and kids[0] & 3 == 1, "not a one-leaf BLAS"
        words[r, 0] = kids[0]
    return out


def twin_tris(n: int = 10):
    """An n x n grid of unit quads in the plane y = 0, facing +y, every
    triangle twice: (4 n^2, 3, 3) float32 corners, triangle i + 2 n^2 the
    copy of triangle i. The builder keeps a triangle and its copy (the same
    centroid) in one leaf, so a ray that hits one hits both at the same t:
    the closest-hit walks must keep the lower slot."""
    cells = []
    for i in range(n):
        for k in range(n):
            x, z = i - n / 2, k - n / 2
            p = np.array([[x, 0.0, z], [x + 1, 0.0, z], [x + 1, 0.0, z + 1],
                          [x, 0.0, z + 1]])
            cells += [p[[0, 2, 1]], p[[0, 3, 2]]]
    base = np.stack(cells).astype(np.float32)
    return np.concatenate([base, base])


def leaf_slots(table, arity: int, leaf_size: int) -> dict:
    """{triangle id: (leaf row, slot)} of every real triangle of a packed
    single-level table (numpy), found by walking its node rows from the
    root."""
    ids_of = np.ascontiguousarray(
        table[:, 9 * leaf_size: 10 * leaf_size]).view(np.int32)
    codes = np.ascontiguousarray(
        table[:, 3 * arity: 4 * arity]).view(np.uint32)
    out, todo = {}, [0]
    while todo:
        row = todo.pop()
        for c in codes[row]:
            c = int(c)
            if c == 0:
                continue
            if c & 3 == 0:
                todo.append(c >> 2)
            else:
                for slot, tid in enumerate(ids_of[c >> 2]):
                    if tid >= 0:
                        out[int(tid)] = (c >> 2, slot)
    return out

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


def _facing(tri, up: bool):
    """``tri`` (3, 3) wound so that a ray going down (-y) meets its front
    (``up``) or its back: the Möller-Trumbore determinant e1 . (d x e2) is
    positive for a front face."""
    e1, e2 = tri[1] - tri[0], tri[2] - tri[0]
    det = float(np.dot(e1, np.cross([0.0, -1.0, 0.0], e2)))
    return tri if (det > 0) == up else tri[[0, 2, 1]]


def occluder_leaf_tris(leaf_size: int):
    """One BLAS leaf's worth (``leaf_size``) of triangles, (leaf_size, 3, 3)
    float32, for the occlusion walks' exit inside a leaf, as rays going
    down (-y) over x in [-0.7, 2.5], z in [-0.7, 1.7] meet them: triangle 0,
    the occluder, faces up at y = 0; the ``leaf_size // 6`` farther ones
    face up below it; the ``5 * leaf_size // 12`` back faces lie above it
    and face down; the rest lie beyond the rays at z = 3. Seen from below
    (a mirrored instance) the back faces occlude and the others do not."""
    def tri(y, x0, x1, z0, z1, up):
        return _facing(np.array([[x0, y, z0], [x1, y, z0], [x0, y, z1]]), up)

    n_far, n_back = leaf_size // 6, 5 * leaf_size // 12
    out = [tri(0.0, 0.0, 1.2, 0.0, 1.2, True)]
    out += [tri(-0.3 - 0.2 * j, 0.4, 2.0, 0.0, 1.2, True)
            for j in range(n_far)]
    out += [tri(0.3 + 0.1 * j, -0.5, 2.5, -0.5, 1.7, False)
            for j in range(n_back)]
    out += [tri(0.2, 0.5 * j, 0.5 * j + 0.4, 3.0, 3.4, True)
            for j in range(leaf_size - len(out))]
    return np.stack(out).astype(np.float32)


def occluder_order(leaf_size: int, slot: int) -> list:
    """The triangles of ``occluder_leaf_tris(leaf_size)`` slot by slot with
    the occluder (0) at ``slot``: back faces and misses before it, then the
    farther triangles (before it only where the slots after it are too
    few), then the rest."""
    n_far, n_back = leaf_size // 6, 5 * leaf_size // 12
    far = list(range(1, 1 + n_far))
    back = list(range(1 + n_far, 1 + n_far + n_back))
    miss = list(range(1 + n_far + n_back, leaf_size))
    mixed = [x for pair in zip(back, miss) for x in pair]
    mixed += back[len(miss):] + miss[len(back):]
    seq = mixed + far
    rest = seq[slot:]
    return (seq[:slot] + [0] + [x for x in rest if x in far]
            + [x for x in rest if x not in far])


def place_leaf_slots(table, inst_base, blas_base, arity, leaf_size, order):
    """A copy of the two-level ``table`` (numpy float32) of one BLAS that is
    one leaf row under its root node, with that leaf's triangles (their
    words and ids) moved so that slot k holds triangle ``order[k]``."""
    out = np.array(table, dtype=np.float32, copy=True)
    words = out.view(np.uint32)
    root = {int(words[r, 0]) >> 2 for r in range(inst_base, blas_base)}
    assert len(root) == 1, "one BLAS"
    kids = words[root.pop(), 3 * arity: 4 * arity]
    kids = kids[kids != 0]
    assert len(kids) == 1 and kids[0] & 3 == 1, "not a one-leaf BLAS"
    row = int(kids[0]) >> 2
    ids = words[row, 9 * leaf_size: 10 * leaf_size].view(np.int32).copy()
    assert sorted(ids) == list(range(leaf_size)), ids
    tris = words[row, : 9 * leaf_size].reshape(leaf_size, 9).copy()
    at = {int(t): k for k, t in enumerate(ids)}
    for k, t in enumerate(order):
        words[row, 9 * k: 9 * k + 9] = tris[at[t]]
        words[row, 9 * leaf_size + k] = np.uint32(t)
    return out


def occluder_field(leaf_size: int):
    """(unique triangles, mesh ids, transforms): ``occluder_leaf_tris`` as
    is and mirrored in y 5 to the right, whose object-space rays then come
    from below."""
    return ([occluder_leaf_tris(leaf_size)], [0, 0],
            [np.eye(4), _translate(5.0, 0.0, 0.0)
             @ np.diag([1.0, -1.0, 1.0, 1.0])])


def occluder_rays(n: int, seed: int):
    """(origins, directions) float32: rays going down onto both instances
    of ``occluder_field``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.7, 2.5, n) + 5.0 * (np.arange(n) % 2)
    o = np.stack([x, np.full(n, 3.0), rng.uniform(-0.7, 1.7, n)], 1)
    d = np.stack([rng.normal(0.0, 0.05, n), -np.ones(n),
                  rng.normal(0.0, 0.05, n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def node_rows(table, inst_base, blas_base, arity) -> list:
    """The node rows of the two-level ``table``: its TLAS rows and every
    BLAS node row reached from an instance's root."""
    words = np.ascontiguousarray(table).view(np.uint32)
    rows = set(range(inst_base))
    todo = [int(words[r, 0]) >> 2 for r in range(inst_base, blas_base)
            if int(words[r, 0]) & 3 == 0]
    while todo:
        r = todo.pop()
        if r not in rows:
            rows.add(r)
            todo += [int(c) >> 2 for c in words[r, 3 * arity: 4 * arity]
                     if c != 0 and c & 3 == 0]
    return sorted(rows)


def spread_children(table, inst_base, blas_base, arity, seed: int = 0):
    """A copy of the two-level ``table`` (numpy float32) whose node rows
    hold their children (box words and codes moved together) in groups of
    four with empty groups between them: one child a group, the groups
    spread over the row, where a node has at most ``arity / 4``; four a
    group, in every other group, where it has at most ``arity / 2``. The
    walks visit the same rows in another order."""
    out = np.array(table, dtype=np.float32, copy=True)
    words = out.view(np.uint32)
    rng = np.random.default_rng(seed)
    groups = arity // 4
    for r in node_rows(table, inst_base, blas_base, arity):
        codes = words[r, 3 * arity: 4 * arity].copy()
        boxes = words[r, : 3 * arity].reshape(arity, 3).copy()
        used = np.flatnonzero(codes).tolist()
        k = len(used)
        if k <= groups:
            gs = np.round(np.linspace(0, groups - 1, k)).astype(int)
            slots = [4 * int(g) + int(rng.integers(4)) for g in gs]
        elif k <= arity // 2:
            slots = [4 * g + j for g in range(0, groups, 2)
                     for j in range(4)][:k]
        else:
            slots = sorted(rng.permutation(arity)[:k].tolist())
        dest = slots + [s for s in range(arity) if s not in slots]
        src = used + [s for s in range(arity) if s not in used]
        for a, b in zip(src, dest):
            words[r, 3 * b: 3 * b + 3] = boxes[a]
            words[r, 3 * arity + b] = codes[a]
    return out


def gap_rows(table, inst_base, blas_base, arity) -> int:
    """The node rows of the two-level ``table`` with an empty group of four
    children between two used ones."""
    words = np.ascontiguousarray(table).view(np.uint32)
    count = 0
    for r in node_rows(table, inst_base, blas_base, arity):
        used = (words[r, 3 * arity: 4 * arity].reshape(-1, 4) != 0).any(1)
        g = np.flatnonzero(used)
        count += bool(len(g) >= 2 and (np.diff(g) > 1).any())
    return count

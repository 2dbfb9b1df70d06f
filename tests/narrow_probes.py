"""Seeded probe instances for the narrowphase kernels' tests: numpy
draws of two-geom instances near contact that reach each branch of the
nine pair functions with a kernel (`tests/test_torch_narrow_cyl.py`
checks the branches on the CPU, `tests/test_torch_cuda.py` holds the
kernels against the plain functions on them on the card)."""
import numpy as np

from mj_envs_torch.physics.model import (GEOM_BOX, GEOM_CAPSULE,
                                         GEOM_CYLINDER, GEOM_PLANE)


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    w, x, y, z = (q / np.linalg.norm(q, axis=1, keepdims=True)).T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(n, 3, 3)


def _axis_frames(rng, n):
    """Signed permutation matrices (det +1): frames along the world axes."""
    out = np.zeros((n, 3, 3))
    for i in range(n):
        p = rng.permutation(3)
        s = rng.choice([-1.0, 1.0], 3)
        m = np.eye(3)[:, p] * s
        if np.linalg.det(m) < 0:
            m[:, 0] = -m[:, 0]
        out[i] = m
    return out


def _with_axis(frames, k):
    """Each frame's columns turned so that column 2 is its column k."""
    k = np.asarray(k)
    cols = np.stack([(k + 1) % 3, (k + 2) % 3, k], -1)
    return np.take_along_axis(frames, cols[:, None, :], axis=2)


def _column(frames, j):
    """Each frame's column j[i]: (n, 3)."""
    return np.take_along_axis(frames, j[:, None, None], axis=2)[:, :, 0]


def random_pairs(rng: np.random.Generator, key, n: int):
    """(xpos (n, 2, 3), xmat (n, 2, 3, 3), size (n, 2, 3)) float32: n
    instances of pair type `key`, geom1 at index 0 and geom2 at 1, drawn
    near contact and in quarters that reach each branch: plane-cylinder
    random and standing on the plane; plane-capsule and plane-box above
    the plane (even quarters) and into it (odd); capsule-capsule random,
    and parallel and antiparallel side by side (exact frames on a grid
    of 1/256, so that `_segment_closest` finds them parallel);
    capsule-cylinder random, with parallel and antiparallel axes;
    capsule-box random, beside a box edge parallel to it (a miss), lying
    on a face along a box axis (exact frames: parallel slabs), and
    hovering over a face (the fallback contact at margin 0);
    cylinder-cylinder random, stacked (cap on cap) and side by side with
    parallel axes; cylinder-box random, standing on a face and lying on
    one; box-box a corner of box 2 into a face of box 1 (face 1), of box
    1 into box 2 (face 2), two edges crossing (edge), random."""
    t1, t2 = key
    q = np.arange(n) % 4               # the quarter of each instance
    m1, m2 = _rotations(rng, n), _rotations(rng, n)
    p1 = rng.uniform(-0.5, 0.5, (n, 3))
    rad = {GEOM_CYLINDER: (0.02, 0.1), GEOM_CAPSULE: (0.01, 0.05),
           GEOM_BOX: (0.05, 0.3), GEOM_PLANE: (1.0, 1.0)}
    half = {GEOM_CYLINDER: (0.02, 0.15), GEOM_CAPSULE: (0.02, 0.1),
            GEOM_BOX: (0.05, 0.3), GEOM_PLANE: (1.0, 1.0)}

    def sizes(t):
        s = np.zeros((n, 3))
        s[:, 0] = rng.uniform(*rad[t], n)
        s[:, 1] = rng.uniform(*half[t], n)
        s[:, 2] = rng.uniform(*half[t], n) if t == GEOM_BOX else 0.0
        return s
    s1, s2 = sizes(t1), sizes(t2)
    reach = s1.max(1) + s2.max(1)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    p2 = p1 + u * (reach * rng.uniform(0.3, 1.2, n))[:, None]
    gap = rng.uniform(-0.01, 0.01, n)

    if key == (GEOM_PLANE, GEOM_CYLINDER):
        # standing: frames along the world axes, the cylinder's axis
        # along the plane's normal or against it
        st = q >= 2
        m1[st] = _axis_frames(rng, int(st.sum()))
        m2[st] = m1[st]
        flip = q == 3
        m2[flip] = m1[flip] * np.array([-1.0, 1.0, -1.0])
        nz = m1[:, :, 2]
        ca = np.abs(np.einsum("ni,ni->n", m2[:, :, 2], nz))
        lift = s2[:, 1] * ca + s2[:, 0] * np.sqrt(np.clip(1 - ca * ca, 0, 1)) \
            + gap
        slide = rng.uniform(-0.2, 0.2, (n, 3))
        slide -= nz * np.einsum("ni,ni->n", slide, nz)[:, None]
        p2 = p1 + slide + nz * lift[:, None]
    elif key == (GEOM_CAPSULE, GEOM_CYLINDER):
        par = q >= 2
        m1[par] = m2[par]
        anti = q == 3
        m1[anti] = m2[anti] * np.array([-1.0, 1.0, -1.0])
        side = np.cross(m2[:, :, 2], u)
        side /= np.linalg.norm(side, axis=1, keepdims=True)
        p2[par] = (p1 + side * (s1[:, 0] + s2[:, 0] + gap)[:, None]
                   + m2[:, :, 2] * rng.uniform(-0.05, 0.05, n)[:, None])[par]
    elif key == (GEOM_CYLINDER, GEOM_CYLINDER):
        par = q >= 2
        m2[par] = m1[par]
        ax = m1[:, :, 2]
        radial = np.cross(ax, u)
        radial /= np.linalg.norm(radial, axis=1, keepdims=True)
        cap = q == 2
        off = rng.uniform(0.0, 0.8, n) * np.maximum(s1[:, 0], s2[:, 0])
        p2[cap] = (p1 + ax * (s1[:, 1] + s2[:, 1] + gap)[:, None]
                   * rng.choice([-1.0, 1.0], n)[:, None]
                   + radial * off[:, None])[cap]
        side = q == 3
        p2[side] = (p1 + radial * (s1[:, 0] + s2[:, 0] + gap)[:, None]
                    + ax * rng.uniform(-0.1, 0.1, n)[:, None])[side]
    elif key == (GEOM_CYLINDER, GEOM_BOX):
        k = rng.integers(0, 3, n)
        sg = rng.choice([-1.0, 1.0], n)
        face_n = np.take_along_axis(m2, k[:, None, None], axis=2)[:, :, 0] \
            * sg[:, None]
        st, ly = q == 2, q == 3
        # standing: the cylinder's axis along the face normal, above it
        m1[st] = _with_axis(m2, k)[st]
        lift = s2[np.arange(n), k] + s1[:, 1] + gap
        in_face = np.einsum("nij,nj->ni", m2, rng.uniform(-0.5, 0.5, (n, 3))
                            * s2 * (np.arange(3) != k[:, None]))
        p2[st] = (p1 - face_n * lift[:, None] - in_face)[st]
        # lying: the axis along another box axis, the side on the face
        m1[ly] = _with_axis(m2, (k + 1 + rng.integers(0, 2, n)) % 3)[ly]
        lift = s2[np.arange(n), k] + s1[:, 0] + gap
        p2[ly] = (p1 - face_n * lift[:, None] - 0.3 * in_face)[ly]
    elif key in ((GEOM_PLANE, GEOM_CAPSULE), (GEOM_PLANE, GEOM_BOX)):
        # geom 2's lowest point +-gap from the plane: above or into it
        nz = m1[:, :, 2]
        if t2 == GEOM_CAPSULE:
            low = s2[:, 1] * np.abs(np.einsum("ni,ni->n", m2[:, :, 2], nz)) \
                + s2[:, 0]
        else:
            low = np.einsum("nj,nj->n", s2,
                            np.abs(np.einsum("nij,ni->nj", m2, nz)))
        lift = low + np.where(q % 2 == 0, 1.0, -1.0) \
            * rng.uniform(0.001, 0.01, n)
        slide = rng.uniform(-0.2, 0.2, (n, 3))
        slide -= nz * np.einsum("ni,ni->n", slide, nz)[:, None]
        p2 = p1 + slide + nz * lift[:, None]
    elif key == (GEOM_CAPSULE, GEOM_CAPSULE):
        par = q >= 2
        m1[par] = _axis_frames(rng, int(par.sum()))
        m2[par] = m1[par]
        anti = q == 3
        m2[anti] = m1[anti] * np.array([-1.0, 1.0, -1.0])
        grid = lambda x: np.round(x * 256.0) / 256.0
        p1[par] = grid(p1[par])
        for sz in (s1, s2):
            sz[par, 1] = np.maximum(np.round(sz[par, 1] * 64.0), 1.0) / 64.0
        side = _column(m1, rng.integers(0, 2, n))
        p2[par] = grid(p1 + side * (s1[:, 0] + s2[:, 0] + gap)[:, None]
                       + m1[:, :, 2] * rng.uniform(-0.05, 0.05, n)[:, None]
                       )[par]
    elif key == (GEOM_CAPSULE, GEOM_BOX):
        k = rng.integers(0, 3, n)                   # a face axis of the box
        a = (k + 1 + rng.integers(0, 2, n)) % 3      # an axis in that face
        c = 3 - k - a
        exact = (q == 1) | (q == 2)
        m2[exact] = _axis_frames(rng, int(exact.sum()))
        sel = q >= 1
        m1[sel] = _with_axis(m2, a)[sel]
        col = lambda j: _column(m2, j)
        sz = lambda j: s2[np.arange(n), j]
        sg = lambda: rng.choice([-1.0, 1.0], n)[:, None]
        r = s1[:, 0]
        # a miss: beside the box edge along axis a, off both other slabs
        off = lambda j: col(j) * sg() * (
            sz(j) + r + rng.uniform(0.005, 0.05, n))[:, None]
        p2[q == 1] = (p1 - off(k) - off(c))[q == 1]
        # lying on face k (into it at q 2, above it at q 3), within it
        lift = sz(k) + r + np.where(q == 2, rng.uniform(-0.01, -0.001, n),
                                    rng.uniform(0.002, 0.02, n))
        in_face = col(a) * (rng.uniform(-0.5, 0.5, n) * sz(a))[:, None] \
            + col(c) * (rng.uniform(-0.5, 0.5, n) * sz(c))[:, None]
        face_n = col(k) * sg()
        lying = q >= 2
        p2[lying] = (p1 - face_n * lift[:, None] - in_face)[lying]
    elif key == (GEOM_BOX, GEOM_BOX):
        k = rng.integers(0, 3, n)
        sg = rng.choice([-1.0, 1.0], n)[:, None]
        gap = rng.uniform(-0.002, 0.01, n)
        support = lambda m, s, d: np.einsum(
            "nj,nj->n", s, np.abs(np.einsum("nij,ni->nj", m, d)))
        # from a box's centre to its corner deepest along -d
        corner = lambda m, s, d: -np.einsum(
            "nij,nj->ni", m, s * np.sign(np.einsum("nij,ni->nj", m, d)))
        in_face = lambda m, s: np.einsum(          # within face k
            "nij,nj->ni", m, rng.uniform(-0.3, 0.3, (n, 3)) * s
            * (np.arange(3) != k[:, None]))
        # face 1: a corner of box 2 onto (or into) face k of box 1
        n1 = _column(m1, k) * sg
        p2[q == 0] = (p1 + in_face(m1, s1) + n1 * (s1[np.arange(n), k]
                                                   + gap)[:, None]
                      - corner(m2, s2, n1))[q == 0]
        # face 2: a corner of box 1 onto face k of box 2
        n2 = _column(m2, k) * sg
        p2[q == 1] = (p1 - in_face(m2, s2) - n2 * (s2[np.arange(n), k]
                                                   + gap)[:, None]
                      + corner(m1, s1, n2))[q == 1]
        # edge: box 1 turned 45 deg about its x axis, box 2 about its y
        # axis, in one frame: box 2's lower edge across box 1's upper one
        # (each box's section across its edge square, so that no face
        # lies nearer)
        c45 = np.sqrt(0.5)
        rx = np.array([[1, 0, 0], [0, c45, -c45], [0, c45, c45]])
        ry = np.array([[c45, 0, c45], [0, 1, 0], [-c45, 0, c45]])
        ed = q == 2
        s1[ed, 2] = s1[ed, 1]              # square sections: roofs
        s2[ed, 2] = s2[ed, 0]
        base = m1.copy()
        m1[ed] = (base @ rx)[ed]
        m2[ed] = (base @ ry)[ed]
        up = base[:, :, 2]
        lift = support(m1, s1, up) + support(m2, s2, up) + gap
        lateral = np.einsum("nij,nj->ni", base, rng.uniform(-0.3, 0.3, (n, 3))
                            * np.minimum(s1, s2) * np.array([1.0, 1.0, 0.0]))
        p2[ed] = (p1 + up * lift[:, None] + lateral)[ed]
    else:
        raise ValueError(f"no narrowphase kernel for pair type {key}")
    f32 = lambda *xs: tuple(np.asarray(x, dtype=np.float32) for x in xs)
    return f32(np.stack([p1, p2], 1), np.stack([m1, m2], 1),
               np.stack([s1, s2], 1))

"""Procedural multi-view 3D benchmark: renders of parametric meshes (a copy
of `gvcnn_tf_tpu/data/procedural.py`, numpy only).

The repository's stand-in for ModelNet, where GVCNN's grouping can matter
(the class-prototype synthetic stream has no view structure):

  * 10 shape classes as parametric triangle-mesh compositions (box, tall
    box, cylinder, cone, table, chair, stool, barbell, tower, tent) with
    per-instance seeded dimension jitter, ModelNet10-like.  A 40-class
    table (CLASSES40, ModelNet40-style category names) extends the label
    space for the flagship 224x224 / 12-view config; select it with
    num_classes=40.
  * V orbit cameras (MVCNN render convention: evenly spaced azimuths at
    30 deg elevation) render each instance with a NumPy z-buffer
    rasterizer, flat Lambertian shading, white background, so the V images
    of one sample are views of one 3D object.
  * Every 4th view is rendered near-top-down (75 deg elevation), where
    several classes are deliberately confusable (box vs tall box, cylinder
    vs cone, table vs stool footprints): uninformative views the grouping
    module can learn to down-weight but a plain MVCNN max-pool cannot.

Deterministic by (seed, split); rendered once per process and cached.  The
same bytes, labels and batches as the JAX package's
(`tests/test_torch_procedural.py` pins them).  The dataset is an iterator
object (`ProceduralStream`) whose position can be saved and restored, as
`SyntheticStream`'s can, so a resumed run continues the stream; its order
(`EpochOrder`) is shared with the card-resident split
(`data/device_resident.py`).
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Mesh builders (verts (N, 3) float, faces (T, 3) int — CCW outward).
# ---------------------------------------------------------------------------

def _box(center, size) -> Tuple[np.ndarray, np.ndarray]:
    cx, cy, cz = center
    sx, sy, sz = size
    v = np.array(
        [
            [cx - sx, cy - sy, cz - sz], [cx + sx, cy - sy, cz - sz],
            [cx + sx, cy + sy, cz - sz], [cx - sx, cy + sy, cz - sz],
            [cx - sx, cy - sy, cz + sz], [cx + sx, cy - sy, cz + sz],
            [cx + sx, cy + sy, cz + sz], [cx - sx, cy + sy, cz + sz],
        ],
        np.float32,
    )
    f = np.array(
        [
            [0, 2, 1], [0, 3, 2],          # bottom (z-)
            [4, 5, 6], [4, 6, 7],          # top (z+)
            [0, 1, 5], [0, 5, 4],          # y-
            [2, 3, 7], [2, 7, 6],          # y+
            [1, 2, 6], [1, 6, 5],          # x+
            [3, 0, 4], [3, 4, 7],          # x-
        ],
        np.int32,
    )
    return v, f


def _cylinder(center, radius, half_h, n=14, taper=1.0):
    """Capped cylinder along z; taper<1 -> truncated cone; taper=0 -> cone."""
    cx, cy, cz = center
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    bot = np.stack(
        [cx + radius * np.cos(ang), cy + radius * np.sin(ang),
         np.full(n, cz - half_h)], -1
    )
    rt = radius * taper
    top = np.stack(
        [cx + rt * np.cos(ang), cy + rt * np.sin(ang),
         np.full(n, cz + half_h)], -1
    )
    cb = np.array([[cx, cy, cz - half_h]], np.float32)
    ct = np.array([[cx, cy, cz + half_h]], np.float32)
    verts = np.concatenate([bot, top, cb, ct]).astype(np.float32)
    faces: List[List[int]] = []
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + i], [j, n + j, n + i]]       # side
        faces += [[2 * n, j, i], [2 * n + 1, n + i, n + j]]  # caps
    return verts, np.asarray(faces, np.int32)


def _compose(parts):
    verts, faces, off = [], [], 0
    for v, f in parts:
        verts.append(v)
        faces.append(f + off)
        off += len(v)
    return np.concatenate(verts), np.concatenate(faces)


def _legs(rng, x, y, h, r=0.05, n=4):
    """n legs under a slab footprint (+-x, +-y), tops at z=h."""
    sign = [(-1, -1), (1, -1), (1, 1), (-1, 1)][:n] if n != 3 else [
        (-1, -1), (1, -1), (0, 1)
    ]
    return [
        _box((sx * x, sy * y, h / 2), (r, r, h / 2)) for sx, sy in sign
    ]


# Each builder: rng -> (verts, faces).  Dimension jitter keeps instances of
# one class distinct while preserving class geometry.
def _c_box(rng):
    s = rng.uniform(0.55, 0.8)
    return _box((0, 0, 0), (s, s * rng.uniform(0.85, 1.15), s))


def _c_tallbox(rng):
    w = rng.uniform(0.3, 0.42)
    return _box((0, 0, 0), (w, w * rng.uniform(0.9, 1.1),
                            rng.uniform(0.85, 1.05)))


def _c_cylinder(rng):
    return _cylinder((0, 0, 0), rng.uniform(0.45, 0.6),
                     rng.uniform(0.6, 0.85))


def _c_cone(rng):
    return _cylinder((0, 0, 0), rng.uniform(0.5, 0.68),
                     rng.uniform(0.6, 0.85), taper=0.02)


def _c_table(rng):
    x, y = rng.uniform(0.6, 0.8), rng.uniform(0.45, 0.65)
    h = rng.uniform(0.5, 0.7)
    top = _box((0, 0, h + 0.04), (x, y, 0.04))
    return _compose([top] + _legs(rng, x - 0.08, y - 0.08, h))


def _c_chair(rng):
    s = rng.uniform(0.35, 0.45)
    h = rng.uniform(0.35, 0.45)
    seat = _box((0, 0, h + 0.04), (s, s, 0.04))
    back = _box((0, s - 0.04, h + 0.5), (s, 0.04, 0.45))
    return _compose([seat, back] + _legs(rng, s - 0.07, s - 0.07, h))


def _c_stool(rng):
    r = rng.uniform(0.3, 0.4)
    h = rng.uniform(0.45, 0.6)
    seat = _cylinder((0, 0, h + 0.04), r, 0.05, n=10)
    return _compose([seat] + _legs(rng, r - 0.08, r - 0.08, h, n=3))


def _c_barbell(rng):
    s = rng.uniform(0.3, 0.38)
    gap = rng.uniform(0.55, 0.7)
    a = _box((-gap, 0, 0), (s, s, s))
    b = _box((gap, 0, 0), (s, s, s))
    bar = _box((0, 0, 0), (gap, 0.08, 0.08))
    return _compose([a, b, bar])


def _c_tower(rng):
    parts = []
    z = -0.8
    w = rng.uniform(0.55, 0.7)
    for k in range(3):
        h = rng.uniform(0.22, 0.3)
        parts.append(_box((0, 0, z + h), (w, w, h)))
        z += 2 * h
        w *= rng.uniform(0.6, 0.7)
    return _compose(parts)


def _c_tent(rng):
    return _cylinder((0, 0, 0), rng.uniform(0.55, 0.75),
                     rng.uniform(0.55, 0.8), n=4, taper=0.02)


CLASSES = [
    ("box", _c_box), ("tallbox", _c_tallbox), ("cylinder", _c_cylinder),
    ("cone", _c_cone), ("table", _c_table), ("chair", _c_chair),
    ("stool", _c_stool), ("barbell", _c_barbell), ("tower", _c_tower),
    ("tent", _c_tent),
]


# ---------------------------------------------------------------------------
# 40-class extension (the flagship mn40_12view regime).
#
# The reference's flagship benchmark is ModelNet40 at 224x224 / 12 views
# (SURVEY.md section 6); the 10-class table above only supports a
# ModelNet10-like stand-in.  These 30 extra parametric families bring the
# label space to 40 so the mn40_12view config can be exercised end-to-end at
# its real operating point.  Names follow ModelNet40 categories where the
# geometry plausibly matches.  Deliberate confusable groups (several
# collapse to similar footprints from near-overhead cameras) keep the
# grouping module's job non-trivial: {bed, bench, sofa}, {door, wardrobe,
# dresser}, {bottle, vase, rocket}, {cup, mug-less bowl, flowerpot},
# {arch, goalpost}, {pyramid, tent}, {plate, ring}.
# ---------------------------------------------------------------------------

def _c_bed(rng):
    x, y = rng.uniform(0.85, 1.0), rng.uniform(0.5, 0.6)
    base = _box((0, 0, 0.12), (x, y, 0.12))
    head = _box((-x + 0.05, 0, 0.42), (0.05, y, 0.3))
    return _compose([base, head])


def _c_bench(rng):
    x = rng.uniform(0.85, 1.0)
    h = rng.uniform(0.3, 0.4)
    seat = _box((0, 0, h + 0.05), (x, rng.uniform(0.22, 0.3), 0.05))
    return _compose([seat] + _legs(rng, x - 0.1, 0.15, h))


def _c_bookshelf(rng):
    x, z = rng.uniform(0.5, 0.65), rng.uniform(0.85, 1.0)
    left = _box((-x, 0, 0), (0.05, 0.3, z))
    right = _box((x, 0, 0), (0.05, 0.3, z))
    shelves = [
        _box((0, 0, -z + (2 * z) * (k + 0.5) / 4), (x, 0.3, 0.04))
        for k in range(4)
    ]
    return _compose([left, right] + shelves)


def _c_bottle(rng):
    r = rng.uniform(0.3, 0.4)
    body = _cylinder((0, 0, -0.25), r, rng.uniform(0.5, 0.6))
    neck = _cylinder((0, 0, 0.6), r * 0.35, 0.3)
    return _compose([body, neck])


def _c_bowl(rng):
    # Flared open form: truncated cone, wide at the top.
    return _cylinder((0, 0, 0), rng.uniform(0.3, 0.4),
                     rng.uniform(0.3, 0.42), taper=rng.uniform(1.8, 2.2))


def _c_cup(rng):
    r = rng.uniform(0.32, 0.42)
    body = _cylinder((0, 0, 0), r, rng.uniform(0.45, 0.55),
                     taper=rng.uniform(1.1, 1.25))
    handle = _box((r + 0.12, 0, 0), (0.12, 0.05, 0.18))
    return _compose([body, handle])


def _c_desk(rng):
    x, y = rng.uniform(0.75, 0.9), rng.uniform(0.4, 0.5)
    h = rng.uniform(0.5, 0.6)
    top = _box((0, 0, h + 0.04), (x, y, 0.04))
    drawers = _box((x - 0.25, 0, h / 2), (0.22, y - 0.05, h / 2))
    return _compose([top, drawers] + _legs(rng, x - 0.08, y - 0.08, h)[:2])


def _c_door(rng):
    return _box((0, 0, 0), (rng.uniform(0.4, 0.5), 0.045,
                            rng.uniform(0.95, 1.05)))


def _c_dresser(rng):
    x, z = rng.uniform(0.55, 0.7), rng.uniform(0.5, 0.62)
    body = _box((0, 0, 0), (x, 0.35, z))
    faces = [
        _box((0, 0.36, -z + (2 * z) * (k + 0.5) / 3), (x - 0.06, 0.02,
                                                       z / 3 - 0.05))
        for k in range(3)
    ]
    return _compose([body] + faces)


def _c_flowerpot(rng):
    pot = _cylinder((0, 0, -0.35), rng.uniform(0.3, 0.4),
                    rng.uniform(0.3, 0.4), taper=rng.uniform(1.3, 1.5))
    stem = _cylinder((0, 0, 0.4), 0.05, rng.uniform(0.35, 0.45), n=8)
    return _compose([pot, stem])


def _c_lamp(rng):
    base = _cylinder((0, 0, -0.8), rng.uniform(0.3, 0.4), 0.06, n=10)
    pole = _cylinder((0, 0, -0.1), 0.045, rng.uniform(0.6, 0.7), n=8)
    shade = _cylinder((0, 0, 0.75), rng.uniform(0.32, 0.42), 0.22,
                      taper=rng.uniform(0.45, 0.6))
    return _compose([base, pole, shade])


def _c_sofa(rng):
    x = rng.uniform(0.75, 0.9)
    seat = _box((0, 0, 0.1), (x, 0.4, 0.18))
    back = _box((0, 0.33, 0.45), (x, 0.08, 0.25))
    arms = [_box((s * x, 0, 0.32), (0.08, 0.4, 0.12)) for s in (-1, 1)]
    return _compose([seat, back] + arms)


def _c_stairs(rng):
    n = 4
    w = rng.uniform(0.5, 0.65)
    d = rng.uniform(0.18, 0.22)
    parts = []
    for k in range(n):
        parts.append(_box((-0.7 + d + 2 * d * k, 0, -0.8 + 0.2 * (k + 1)),
                          (d, w, 0.2 * (k + 1))))
    return _compose(parts)


def _c_toilet(rng):
    base = _box((0, 0, -0.45), (0.3, 0.3, 0.3))
    bowl = _cylinder((0.1, 0, 0.0), rng.uniform(0.28, 0.34), 0.12, n=10)
    tank = _box((-0.35, 0, 0.25), (0.1, 0.3, 0.35))
    return _compose([base, bowl, tank])


def _c_wardrobe(rng):
    return _box((0, 0, 0), (rng.uniform(0.45, 0.55),
                            rng.uniform(0.3, 0.4),
                            rng.uniform(0.95, 1.05)))


def _c_vase(rng):
    belly = _cylinder((0, 0, -0.3), rng.uniform(0.38, 0.48), 0.35,
                      taper=rng.uniform(0.5, 0.65))
    neck = _cylinder((0, 0, 0.35), rng.uniform(0.16, 0.2), 0.3,
                     taper=rng.uniform(1.4, 1.7))
    return _compose([belly, neck])


def _c_arch(rng):
    h = rng.uniform(0.6, 0.75)
    w = rng.uniform(0.55, 0.7)
    left = _box((-w, 0, 0), (0.12, 0.12, h))
    right = _box((w, 0, 0), (0.12, 0.12, h))
    top = _box((0, 0, h + 0.12), (w + 0.12, 0.12, 0.14))
    return _compose([left, right, top])


def _c_cross(rng):
    a = rng.uniform(0.75, 0.9)
    t = rng.uniform(0.14, 0.2)
    return _compose([_box((0, 0, 0), (a, t, t)),
                     _box((0, 0, 0), (t, a, t))])


def _c_lshape(rng):
    a = rng.uniform(0.7, 0.85)
    t = rng.uniform(0.18, 0.24)
    return _compose([_box((0, -a / 2 + t, 0), (a, t, t)),
                     _box((-a + t, t / 2, 0), (t, a * 0.7, t))])


def _c_tshape(rng):
    a = rng.uniform(0.7, 0.85)
    t = rng.uniform(0.18, 0.24)
    return _compose([_box((0, 0, a - t), (a, t, t)),
                     _box((0, 0, 0), (t, t, a - t))])


def _c_ring(rng):
    # Torus approximation: n boxes on a circle.
    n = 10
    r = rng.uniform(0.6, 0.75)
    t = rng.uniform(0.1, 0.14)
    parts = []
    for k in range(n):
        a = 2 * np.pi * k / n
        v, f = _box((0, 0, 0), (np.pi * r / n, t, t))
        rot = np.array([[np.cos(a), -np.sin(a), 0],
                        [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
        v = v @ rot.T + np.array([r * np.cos(a + np.pi / 2),
                                  r * np.sin(a + np.pi / 2), 0], np.float32)
        parts.append((v, f))
    return _compose(parts)


def _c_pyramid(rng):
    # Wide, flat hexagonal pyramid (tent is the tall 4-sided one).
    return _cylinder((0, 0, 0), rng.uniform(0.75, 0.9),
                     rng.uniform(0.35, 0.45), n=6, taper=0.02)


def _c_tree(rng):
    trunk = _cylinder((0, 0, -0.5), 0.1, rng.uniform(0.35, 0.45), n=8)
    canopy = _cylinder((0, 0, 0.3), rng.uniform(0.5, 0.65),
                       rng.uniform(0.55, 0.7), taper=0.05)
    return _compose([trunk, canopy])


def _c_hourglass(rng):
    r = rng.uniform(0.45, 0.58)
    h = rng.uniform(0.4, 0.5)
    top = _cylinder((0, 0, h), r, h, taper=0.1)
    v, f = _cylinder((0, 0, -h), r, h, taper=0.1)
    v = v * np.array([1, 1, -1], np.float32)       # mirror: tip up
    f = f[:, ::-1]                                 # keep winding outward
    return _compose([top, (v, f)])


def _c_mushroom(rng):
    stem = _cylinder((0, 0, -0.35), rng.uniform(0.14, 0.2),
                     rng.uniform(0.4, 0.5), n=10)
    cap = _cylinder((0, 0, 0.3), rng.uniform(0.6, 0.75), 0.18,
                    taper=rng.uniform(0.3, 0.45))
    return _compose([stem, cap])


def _c_dumbbell(rng):
    # Cylinder-plate twin of the box barbell: build along z, rotate onto x.
    r = rng.uniform(0.3, 0.38)
    gap = rng.uniform(0.55, 0.7)
    rot = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    parts = []
    for v, f in (_cylinder((0, 0, -gap), r, 0.14, n=10),
                 _cylinder((0, 0, gap), r, 0.14, n=10),
                 _cylinder((0, 0, 0), 0.07, gap, n=8)):
        parts.append((v @ rot.T, f))
    return _compose(parts)


def _c_goalpost(rng):
    h = rng.uniform(0.7, 0.85)
    w = rng.uniform(0.6, 0.75)
    left = _box((-w, 0, 0), (0.08, 0.08, h))
    right = _box((w, 0, 0), (0.08, 0.08, h))
    bar = _box((0, 0, h - 0.08), (w, 0.08, 0.08))
    return _compose([left, right, bar])


def _c_bathtub(rng):
    x, y = rng.uniform(0.75, 0.9), rng.uniform(0.42, 0.5)
    z = rng.uniform(0.3, 0.38)
    floor = _box((0, 0, -z + 0.05), (x, y, 0.05))
    walls = [
        _box((0, -y + 0.05, 0), (x, 0.05, z)),
        _box((0, y - 0.05, 0), (x, 0.05, z)),
        _box((-x + 0.05, 0, 0), (0.05, y, z)),
        _box((x - 0.05, 0, 0), (0.05, y, z)),
    ]
    return _compose([floor] + walls)


def _c_rocket(rng):
    body = _cylinder((0, 0, -0.15), rng.uniform(0.22, 0.3),
                     rng.uniform(0.6, 0.7), n=10)
    nose = _cylinder((0, 0, 0.8), rng.uniform(0.2, 0.27), 0.25, taper=0.05)
    fins = [_box((s * 0.3, 0, -0.75), (0.12, 0.03, 0.2)) for s in (-1, 1)]
    return _compose([body, nose] + fins)


def _c_plate(rng):
    return _cylinder((0, 0, 0), rng.uniform(0.8, 0.95), 0.06, n=14,
                     taper=rng.uniform(1.05, 1.15))


CLASSES40 = CLASSES + [
    ("bed", _c_bed), ("bench", _c_bench), ("bookshelf", _c_bookshelf),
    ("bottle", _c_bottle), ("bowl", _c_bowl), ("cup", _c_cup),
    ("desk", _c_desk), ("door", _c_door), ("dresser", _c_dresser),
    ("flowerpot", _c_flowerpot), ("lamp", _c_lamp), ("sofa", _c_sofa),
    ("stairs", _c_stairs), ("toilet", _c_toilet), ("wardrobe", _c_wardrobe),
    ("vase", _c_vase), ("arch", _c_arch), ("cross", _c_cross),
    ("lshape", _c_lshape), ("tshape", _c_tshape), ("ring", _c_ring),
    ("pyramid", _c_pyramid), ("tree", _c_tree), ("hourglass", _c_hourglass),
    ("mushroom", _c_mushroom), ("dumbbell", _c_dumbbell),
    ("goalpost", _c_goalpost), ("bathtub", _c_bathtub),
    ("rocket", _c_rocket), ("plate", _c_plate),
]


def class_table(num_classes: int):
    """The class list for a label-space size (10 = the ModelNet10-like
    set; 40 = the flagship set, its first 10 classes the same)."""
    if num_classes == len(CLASSES):
        return CLASSES
    if num_classes == len(CLASSES40):
        return CLASSES40
    raise ValueError(
        f"procedural dataset supports {len(CLASSES)} or {len(CLASSES40)} "
        f"classes; config asks for {num_classes}")


# ---------------------------------------------------------------------------
# Rendering: orbit cameras + z-buffer rasterizer.
# ---------------------------------------------------------------------------

def _rot(azimuth: float, elevation: float) -> np.ndarray:
    ca, sa = np.cos(azimuth), np.sin(azimuth)
    ce, se = np.cos(elevation), np.sin(elevation)
    rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
    rx = np.array([[1, 0, 0], [0, ce, -se], [0, se, ce]], np.float32)
    return rx @ rz


def rasterize(verts, faces, res: int) -> np.ndarray:
    """verts in view space (x, y in [-1, 1], z = depth toward viewer).

    Returns (res, res) float image in [0, 1]: white background, flat
    Lambertian shading by face normal.
    """
    img = np.ones((res, res), np.float32)
    zbuf = np.full((res, res), -np.inf, np.float32)
    tri = verts[faces]                                   # (T, 3, 3)
    # Pixel coords: x right, y down.
    px = (tri[..., 0] + 1.0) * 0.5 * (res - 1)
    py = (1.0 - (tri[..., 1] + 1.0) * 0.5) * (res - 1)
    pz = tri[..., 2]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    nz = n[:, 2] / (np.linalg.norm(n, axis=1) + 1e-9)
    shade = 0.15 + 0.65 * np.abs(nz)                     # viewer-side light
    for t in range(len(faces)):
        x0, x1 = px[t].min(), px[t].max()
        y0, y1 = py[t].min(), py[t].max()
        ix0, ix1 = int(np.floor(x0)), int(np.ceil(x1)) + 1
        iy0, iy1 = int(np.floor(y0)), int(np.ceil(y1)) + 1
        ix0, iy0 = max(ix0, 0), max(iy0, 0)
        ix1, iy1 = min(ix1, res), min(iy1, res)
        if ix0 >= ix1 or iy0 >= iy1:
            continue
        xs = np.arange(ix0, ix1, dtype=np.float32)
        ys = np.arange(iy0, iy1, dtype=np.float32)
        gx, gy = np.meshgrid(xs, ys)
        ax, ay = px[t, 0], py[t, 0]
        bx, by = px[t, 1], py[t, 1]
        cx, cy = px[t, 2], py[t, 2]
        den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
        if abs(den) < 1e-9:
            continue
        w0 = ((by - cy) * (gx - cx) + (cx - bx) * (gy - cy)) / den
        w1 = ((cy - ay) * (gx - cx) + (ax - cx) * (gy - cy)) / den
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        depth = w0 * pz[t, 0] + w1 * pz[t, 1] + w2 * pz[t, 2]
        zwin = zbuf[iy0:iy1, ix0:ix1]
        upd = inside & (depth > zwin)
        zwin[upd] = depth[upd]
        img[iy0:iy1, ix0:ix1][upd] = shade[t]
    return img


def render_views(
    verts: np.ndarray,
    faces: np.ndarray,
    num_views: int,
    res: int,
    azimuth0: float = 0.0,
    topdown_every: int = 4,
    topdown_deg: float = 75.0,
) -> np.ndarray:
    """-> (V, res, res) float in [0, 1].  MVCNN-style orbit: evenly spaced
    azimuths at 30 deg elevation; every `topdown_every`-th view near-top-
    down (`topdown_deg`), the deliberately less-informative views."""
    center = (verts.max(0) + verts.min(0)) / 2
    v0 = verts - center
    scale = 0.9 / (np.abs(v0).max() + 1e-9)     # one scale for ALL views
    v0 = v0 * scale
    out = np.empty((num_views, res, res), np.float32)
    for i in range(num_views):
        az = azimuth0 + 2 * np.pi * i / num_views
        el = np.deg2rad(
            topdown_deg if i % topdown_every == topdown_every - 1 else 30.0
        )
        out[i] = rasterize(v0 @ _rot(az, el).T, faces, res)
    return out


# ---------------------------------------------------------------------------
# Dataset assembly (rendered once per (args) and cached in-process).
# ---------------------------------------------------------------------------

def _disk_cache_path(kwargs: dict) -> Optional[str]:
    """Optional cross-process render cache: set GVCNN_PROC_CACHE to a
    directory and identical splits are rendered once per machine instead of
    once per process (rasterization runs on one core).  Renders are
    deterministic in the kwargs, so the key is just their repr; the JAX
    package's copy uses the same key and the same bytes."""
    import hashlib
    import os

    root = os.environ.get("GVCNN_PROC_CACHE")
    if not root:
        return None
    key = hashlib.sha256(
        repr(sorted(kwargs.items())).encode()).hexdigest()[:24]
    os.makedirs(root, exist_ok=True)
    return os.path.join(root, f"proc_{key}.npz")


@functools.lru_cache(maxsize=4)
def build_procedural_split(
    *,
    num_views: int,
    height: int,
    width: int,
    num_shapes: int,
    seed: int,
    train_split: bool,
    hard: bool = False,
    num_classes: int = len(CLASSES),
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (views uint8 (N, V, H, W, 3), labels int32 (N,)).

    Train and validation draw disjoint instance seeds of the same classes.
    `height` must equal `width` (square renders).  `hard` renders HALF the
    views from 85-degree near-overhead cameras (most classes collapse to
    their footprint) and CLUTTERS those views with random occluder
    rectangles — actively misleading features that uniform max-pooling
    propagates into the shape descriptor but score-based grouping can
    down-weight (the regime the GVCNN paper motivates: views vary in
    discriminativeness; the easy variant saturates both models).
    """
    if height != width:
        raise ValueError(f"procedural renders are square; got height "
                         f"{height}, width {width}")
    cache_path = _disk_cache_path(dict(
        num_views=num_views, height=height, width=width,
        num_shapes=num_shapes, seed=seed, train_split=train_split,
        hard=hard, num_classes=num_classes))
    if cache_path:
        import os

        if os.path.exists(cache_path):
            with np.load(cache_path) as z:
                return z["views"], z["labels"]
    table = class_table(num_classes)
    n_cls = len(table)
    labels = np.arange(num_shapes, dtype=np.int32) % n_cls
    views = np.empty((num_shapes, num_views, height, width, 3), np.uint8)
    base = seed * 2_000_003 + (0 if train_split else 1_000_003)
    for i in range(num_shapes):
        rng = np.random.RandomState(base + i)
        _, builder = table[labels[i]]
        verts, faces = builder(rng)
        az0 = rng.uniform(0, 2 * np.pi / num_views)   # per-instance orbit phase
        imgs = render_views(
            verts, faces, num_views, height, azimuth0=az0,
            topdown_every=2 if hard else 4,
            topdown_deg=85.0 if hard else 75.0,
        )
        if hard:  # clutter the degenerate views with occluder rectangles
            for v in range(1, num_views, 2):
                for _ in range(4):
                    h0 = rng.randint(0, max(height - 8, 1))
                    w0 = rng.randint(0, max(width - 8, 1))
                    dh = rng.randint(height // 8, height // 3)
                    dw = rng.randint(width // 8, width // 3)
                    shade = rng.uniform(0.0, 0.9)
                    imgs[v, h0:h0 + dh, w0:w0 + dw] = shade
        views[i] = np.repeat(
            (imgs * 255).astype(np.uint8)[..., None], 3, axis=-1
        )
    if cache_path:
        import os

        tmp = cache_path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:                  # np.savez(str) would
            np.savez(f, views=views, labels=labels)  # append ".npz"
        os.replace(tmp, cache_path)                 # atomic publish
    return views, labels


class EpochOrder:
    """The order in which a procedural split is read: each process's shard
    (every num_shards-th shape from shard_index), one permutation of it an
    epoch from `RandomState(seed + 7 + shard_index)`, cut into batches of
    indices.  Train shuffles each epoch and drops the ragged tail; eval
    reads the shard in order with its tail short.

    The base of the streaming `ProceduralStream` and the card-resident
    `DeviceResidentIter` (`data/device_resident.py`): both read the same
    batches, and both save the same position (`state_dict`), so a
    checkpoint written under either transport resumes under the other."""

    def __init__(self, *, num_shapes: int, batch_size: int, seed: int = 0,
                 train: bool = True, num_epochs: Optional[int] = None,
                 shard_index: int = 0, num_shards: int = 1):
        self._shard = np.arange(num_shapes)[shard_index::num_shards]
        self._rng = np.random.RandomState(seed + 7 + shard_index)
        self._batch_size, self._train = batch_size, train
        self._num_epochs = num_epochs
        self._epoch, self._order, self._start = 0, None, 0

    def __iter__(self):
        return self

    def _next_indices(self) -> np.ndarray:
        """The next batch's shape indices; StopIteration after the last
        epoch."""
        bs = self._batch_size
        while True:
            if self._order is None:
                if (self._num_epochs is not None
                        and self._epoch >= self._num_epochs):
                    raise StopIteration
                self._order = (self._shard[self._rng.permutation(
                    len(self._shard))] if self._train else self._shard)
                self._start = 0
            last = len(self._order) - bs + 1 if self._train else len(
                self._order)
            if self._start < last:
                idx = self._order[self._start:self._start + bs]
                self._start += bs
                return idx
            self._order = None
            self._epoch += 1

    def state_dict(self) -> dict:
        """The position: epoch, offset, shuffled order and the numpy
        generator's state, as tensors and numbers (so that
        `torch.load(weights_only=True)` reads it back)."""
        kind, keys, pos, has_gauss, gauss = self._rng.get_state()
        return {
            "epoch": self._epoch, "start": self._start,
            "order": (None if self._order is None
                      else torch.from_numpy(np.array(self._order))),
            "rng": {"kind": kind, "keys": torch.from_numpy(keys.astype(
                np.int64)), "pos": int(pos), "has_gauss": int(has_gauss),
                "gauss": float(gauss)},
        }

    def load_state_dict(self, state: dict):
        r = state["rng"]
        self._rng.set_state((r["kind"], r["keys"].numpy().astype(np.uint32),
                             r["pos"], r["has_gauss"], r["gauss"]))
        self._epoch, self._start = state["epoch"], state["start"]
        order = state["order"]
        self._order = None if order is None else order.numpy()


class ProceduralStream(EpochOrder):
    """Yields {'views': (B, V, H, W, 3), 'label': (B,) int32} batches of a
    procedural split in `EpochOrder`'s order: float32 in [-1, 1], or with
    `raw_uint8` the stored uint8 renders in [0, 255] (for
    `transfer_dtype="uint8"` runs, which normalize on the device,
    utils/images.py, and ship 4x fewer bytes).  The JAX package's
    `procedural_dataset` generator, batch for batch."""

    def __init__(self, *, num_classes: int, num_views: int, height: int,
                 width: int, batch_size: int, num_shapes: int = 400,
                 seed: int = 0, train: bool = True,
                 num_epochs: Optional[int] = None, shard_index: int = 0,
                 num_shards: int = 1, hard: bool = False,
                 raw_uint8: bool = False):
        self._views, self._labels = build_procedural_split(
            num_views=num_views, height=height, width=width,
            num_shapes=num_shapes, seed=seed, train_split=train, hard=hard,
            num_classes=num_classes,
        )
        super().__init__(num_shapes=num_shapes, batch_size=batch_size,
                         seed=seed, train=train, num_epochs=num_epochs,
                         shard_index=shard_index, num_shards=num_shards)
        self._raw_uint8 = raw_uint8

    def __next__(self) -> dict:
        idx = self._next_indices()
        v = self._views[idx]
        if not self._raw_uint8:
            v = v.astype(np.float32) / 255.0 * 2.0 - 1.0
        return {"views": v, "label": self._labels[idx]}


def procedural_dataset(**kw) -> ProceduralStream:
    """`gvcnn_tf_tpu.data.procedural.procedural_dataset`'s signature and
    stream; see `ProceduralStream`."""
    return ProceduralStream(**kw)


def class_names(num_classes: int = len(CLASSES)) -> List[str]:
    return [name for name, _ in class_table(num_classes)]

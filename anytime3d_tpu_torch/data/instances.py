"""Procedural CAD-like instance shapes: instances of a class that differ in
structure, not only in scale.

Counterpart of ``anytime3d_tpu/data/instances.py``, NumPy only. Each
(class, instance) pair maps deterministically to a part-based triangle mesh:
a family template by ``class % 8`` (table, chair, lamp, airplane, cabinet,
bench, vessel, shelf) whose per-instance draws vary the parts (counts,
presence, attachment, aspect). ``parts_to_grid`` fits the union of the added
parts into the cube once, voxelizes each part solid on its own and unions
(or carves) them, so that overlapping parts never share a parity ray.

The grids are the native voxelizer's (``data/voxelize.py``, ``native=True``):
the NumPy path gives other shapes (about a third of the occupied voxels
differ, and two instances of a class can come out near-identical), so
``parts_to_grid`` and ``instance_grid`` raise where the native library
cannot be built rather than fall back to it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from anytime3d_tpu_torch.data.voxelize import voxelize

Mesh = Tuple[np.ndarray, np.ndarray]  # (verts (V,3) f32, tris (T,3) i32)
Part = Tuple[str, Mesh]  # ("add" | "sub", mesh)


# ------------------------------------------------------------------ primitives


def box_mesh(center, half) -> Mesh:
    cx, cy, cz = center
    hx, hy, hz = half
    v = np.array(
        [
            [sx * hx + cx, sy * hy + cy, sz * hz + cz]
            for sx in (-1, 1)
            for sy in (-1, 1)
            for sz in (-1, 1)
        ],
        np.float32,
    )
    # 12 triangles over the 8 corners (index bits: x<<2 | y<<1 | z)
    t = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 7, 5], [4, 6, 7],  # +x
            [0, 5, 1], [0, 4, 5],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        np.int32,
    )
    return v, t


def frustum_mesh(center, axis: int, h: float, r0: float, r1: float, n: int = 16) -> Mesh:
    """Capped frustum (cylinder/cone) of half-height ``h`` along ``axis``
    with bottom/top radii r0/r1 (r1 ~ 0 gives a cone)."""
    ang = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    c, s = np.cos(ang), np.sin(ang)
    r1 = max(r1, 1e-3)
    bot = np.stack([r0 * c, np.full(n, -h), r0 * s], axis=-1)
    top = np.stack([r1 * c, np.full(n, h), r1 * s], axis=-1)
    centers = np.array([[0.0, -h, 0.0], [0.0, h, 0.0]], np.float32)
    v = np.concatenate([bot, top, centers]).astype(np.float32)
    tris: List[List[int]] = []
    for i in range(n):
        j = (i + 1) % n
        tris += [[i, j, n + i], [j, n + j, n + i]]  # side quads
        tris += [[2 * n, j, i], [2 * n + 1, n + i, n + j]]  # caps
    t = np.asarray(tris, np.int32)
    # orient along requested axis by swapping the y coordinate in
    if axis != 1:
        perm = [0, 1, 2]
        perm[1], perm[axis] = perm[axis], perm[1]
        v = v[:, perm]
    v = v + np.asarray(center, np.float32)
    return v.astype(np.float32), t


def ellipsoid_mesh(center, radii, n: int = 10) -> Mesh:
    """Lat-long ellipsoid, n bands x 2n segments."""
    lat = np.linspace(-np.pi / 2, np.pi / 2, n + 1)
    lon = np.linspace(0.0, 2 * np.pi, 2 * n, endpoint=False)
    la, lo = np.meshgrid(lat, lon, indexing="ij")
    rx, ry, rz = radii
    v = np.stack(
        [
            rx * np.cos(la) * np.cos(lo),
            ry * np.sin(la),
            rz * np.cos(la) * np.sin(lo),
        ],
        axis=-1,
    ).reshape(-1, 3) + np.asarray(center, np.float32)
    m = 2 * n
    tris = []
    for i in range(n):
        for j in range(m):
            j2 = (j + 1) % m
            a, b = i * m + j, i * m + j2
            c_, d = (i + 1) * m + j, (i + 1) * m + j2
            tris += [[a, b, c_], [b, d, c_]]
    return v.astype(np.float32), np.asarray(tris, np.int32)


# ------------------------------------------------------------- part families
# Canonical frame: x = right, y = up, z = front; shapes roughly in [-1, 1]^3.
# Every structural draw comes from the (class, instance)-keyed RNG so the
# SAME (class, inst) always produces the SAME structure, while different
# instances of one class differ in part counts / presence / attachment.


def _table(r: np.random.Generator) -> List[Part]:
    top_h = r.uniform(0.04, 0.10)
    top_y = r.uniform(0.3, 0.6)
    hx, hz = r.uniform(0.55, 0.95), r.uniform(0.4, 0.8)
    parts: List[Part] = [("add", box_mesh((0, top_y, 0), (hx, top_h, hz)))]
    n_legs = int(r.integers(3, 5))
    lr = r.uniform(0.05, 0.12)
    round_legs = r.random() < 0.5
    pos = [(-1, -1), (1, -1), (-1, 1), (1, 1)][:n_legs]
    for px, pz in pos:
        cx, cz = px * (hx - 0.12), pz * (hz - 0.12)
        half_leg = (top_y + 1.0) / 2 - top_h
        cy = top_y - top_h - half_leg
        if round_legs:
            parts.append(("add", frustum_mesh((cx, cy, cz), 1, half_leg, lr, lr)))
        else:
            parts.append(("add", box_mesh((cx, cy, cz), (lr, half_leg, lr))))
    if r.random() < 0.5:  # lower shelf
        sy = r.uniform(-0.6, -0.2)
        parts.append(("add", box_mesh((0, sy, 0), (hx * 0.8, 0.04, hz * 0.8))))
    return parts


def _chair(r: np.random.Generator) -> List[Part]:
    seat_y = r.uniform(-0.15, 0.1)
    hx, hz = r.uniform(0.4, 0.6), r.uniform(0.4, 0.6)
    parts: List[Part] = [("add", box_mesh((0, seat_y, 0), (hx, 0.06, hz)))]
    back_h = r.uniform(0.4, 0.9)
    parts.append(
        ("add", box_mesh((0, seat_y + back_h / 2, -hz + 0.05), (hx, back_h / 2, 0.06)))
    )
    if r.random() < 0.3:  # pedestal base
        parts.append(("add", frustum_mesh((0, (seat_y - 1) / 2, 0), 1,
                                          (seat_y + 1) / 2, 0.08, 0.08)))
        parts.append(("add", box_mesh((0, -0.95, 0), (0.4, 0.05, 0.4))))
    else:
        lr = r.uniform(0.04, 0.08)
        for px in (-1, 1):
            for pz in (-1, 1):
                parts.append(
                    ("add", box_mesh((px * (hx - 0.08), (seat_y - 1) / 2, pz * (hz - 0.08)),
                                     (lr, (seat_y + 1) / 2, lr)))
                )
    if r.random() < 0.5:  # armrests
        arm_y = seat_y + r.uniform(0.2, 0.35)
        for px in (-1, 1):
            parts.append(("add", box_mesh((px * hx, arm_y, 0), (0.05, 0.04, hz * 0.8))))
    return parts


def _lamp(r: np.random.Generator) -> List[Part]:
    parts: List[Part] = [
        ("add", frustum_mesh((0, -0.9, 0), 1, 0.08, r.uniform(0.3, 0.5), 0.25)),
        ("add", frustum_mesh((0, -0.1, 0), 1, 0.75, 0.05, 0.05)),
    ]
    kind = int(r.integers(0, 3))
    top = r.uniform(0.55, 0.8)
    if kind == 0:  # cone shade
        parts.append(("add", frustum_mesh((0, top, 0), 1, 0.25, r.uniform(0.35, 0.55), 0.1)))
    elif kind == 1:  # drum shade
        rr = r.uniform(0.25, 0.45)
        parts.append(("add", frustum_mesh((0, top, 0), 1, 0.22, rr, rr)))
    else:  # globe
        parts.append(("add", ellipsoid_mesh((0, top, 0), (0.32, 0.32, 0.32))))
    return parts


def _airplane(r: np.random.Generator) -> List[Part]:
    fus_l = r.uniform(0.7, 0.95)
    parts: List[Part] = [
        ("add", ellipsoid_mesh((0, 0, 0), (0.16, 0.14, fus_l)))
    ]
    span = r.uniform(0.6, 0.95)
    chord = r.uniform(0.12, 0.22)
    wing_z = r.uniform(-0.1, 0.25)
    parts.append(("add", box_mesh((0, 0, wing_z), (span, 0.03, chord))))
    tail_h = r.uniform(0.2, 0.4)
    parts.append(("add", box_mesh((0, tail_h / 2, -fus_l + 0.1), (0.04, tail_h / 2, 0.12))))
    if r.random() < 0.5:  # horizontal stabilizer
        parts.append(("add", box_mesh((0, 0.05, -fus_l + 0.12), (0.3, 0.025, 0.1))))
    if r.random() < 0.4:  # two underwing engines
        ex = span * 0.45
        for px in (-1, 1):
            parts.append(("add", frustum_mesh((px * ex, -0.08, wing_z), 2, 0.12, 0.06, 0.06)))
    return parts


def _cabinet(r: np.random.Generator) -> List[Part]:
    hx, hy, hz = r.uniform(0.45, 0.7), r.uniform(0.6, 0.95), r.uniform(0.3, 0.5)
    parts: List[Part] = [("add", box_mesh((0, 0, 0), (hx, hy, hz)))]
    n_slots = int(r.integers(1, 4))
    slot_h = hy * 0.8 / n_slots
    for k in range(n_slots):
        cy = -hy * 0.8 + (k + 0.5) * 2 * slot_h
        parts.append(
            ("sub", box_mesh((0, cy, hz), (hx * 0.8, slot_h * 0.35, 0.18)))
        )
    if r.random() < 0.5:  # feet
        for px in (-1, 1):
            parts.append(("add", box_mesh((px * (hx - 0.08), -hy - 0.06, 0), (0.06, 0.06, hz * 0.9))))
    return parts


def _bench(r: np.random.Generator) -> List[Part]:
    hx = r.uniform(0.7, 0.98)
    hz = r.uniform(0.2, 0.35)
    seat_y = r.uniform(-0.2, 0.1)
    parts: List[Part] = [("add", box_mesh((0, seat_y, 0), (hx, 0.06, hz)))]
    n_sup = int(r.integers(2, 4))
    for k in range(n_sup):
        cx = -hx + (k + 0.5) * 2 * hx / n_sup
        parts.append(("add", box_mesh((cx, (seat_y - 1) / 2, 0),
                                      (0.06, (seat_y + 1) / 2, hz * 0.9))))
    if r.random() < 0.5:  # backrest
        parts.append(("add", box_mesh((0, seat_y + 0.4, -hz), (hx, 0.3, 0.05))))
    return parts


def _vessel(r: np.random.Generator) -> List[Part]:
    """Bottle/vase: stacked frusta with an instance-specific radius profile."""
    n_seg = int(r.integers(2, 4))
    radii = r.uniform(0.18, 0.5, size=n_seg + 1)
    parts: List[Part] = []
    y = -0.95
    seg_h = 1.5 / n_seg
    for k in range(n_seg):
        parts.append(
            ("add", frustum_mesh((0, y + seg_h / 2, 0), 1, seg_h / 2, radii[k], radii[k + 1]))
        )
        y += seg_h
    if r.random() < 0.6:  # neck
        parts.append(("add", frustum_mesh((0, y + 0.15, 0), 1, 0.15, 0.1, 0.12)))
    return parts


def _shelf(r: np.random.Generator) -> List[Part]:
    hx, hy, hz = r.uniform(0.5, 0.8), r.uniform(0.7, 0.98), r.uniform(0.22, 0.35)
    parts: List[Part] = [
        ("add", box_mesh((-hx, 0, 0), (0.05, hy, hz))),
        ("add", box_mesh((hx, 0, 0), (0.05, hy, hz))),
    ]
    n_sh = int(r.integers(2, 5))
    for k in range(n_sh):
        cy = -hy + (k + 0.5) * 2 * hy / n_sh
        parts.append(("add", box_mesh((0, cy, 0), (hx, 0.04, hz))))
    if r.random() < 0.5:  # back panel
        parts.append(("add", box_mesh((0, 0, -hz), (hx, hy, 0.03))))
    return parts


_FAMILIES = (_table, _chair, _lamp, _airplane, _cabinet, _bench, _vessel, _shelf)


def instance_parts(cls: int, inst: int) -> List[Part]:
    """Deterministic part list for (class, instance): template by
    ``cls % 8``, structure by the (cls, inst)-keyed RNG."""
    rng = np.random.default_rng([17, int(cls), int(inst)])
    return _FAMILIES[int(cls) % len(_FAMILIES)](rng)


def parts_to_grid(parts: List[Part], dim: int, pad: float = 0.08) -> np.ndarray:
    """Voxelize a part list into one (dim,dim,dim) float32 occupancy grid.

    One shared normalization transform (fit the union of "add" parts into
    the cube), then per-part solid voxelization + boolean union/carve —
    robust where a single merged mesh would break z-parity on overlaps.
    Voxelizes natively; raises RuntimeError where the native voxelizer
    cannot be built."""
    adds = [m for op, m in parts if op == "add"]
    all_v = np.concatenate([v for v, _ in adds])
    mins, maxs = all_v.min(axis=0), all_v.max(axis=0)
    extent = float((maxs - mins).max()) or 1.0
    scale = dim * (1.0 - 2 * pad) / extent
    center = (mins + maxs) / 2.0

    grid = np.zeros((dim, dim, dim), bool)
    for op, (v, t) in parts:
        pv = (v - center) * scale + dim / 2.0
        g = voxelize(pv, t, dim=dim, solid=True, normalize=False, native=True) > 0.5
        if op == "add":
            grid |= g
        else:
            grid &= ~g
    return grid.astype(np.float32)


class InstanceShapeBank:
    """Cache of structural instance grids, keyed (class, inst, dim)."""

    def __init__(self):
        self._cache: Dict[Tuple[int, int, int], np.ndarray] = {}

    def grid(self, cls: int, inst: int, dim: int) -> np.ndarray:
        key = (int(cls), int(inst), int(dim))
        g = self._cache.get(key)
        if g is None:
            g = parts_to_grid(instance_parts(cls, inst), dim)
            self._cache[key] = g
        return g


_BANK = InstanceShapeBank()


def instance_grid(cls: int, inst: int, dim: int) -> np.ndarray:
    """The (dim, dim, dim) float32 grid of (class, instance), cached for the
    process (grids are deterministic, so sharing is safe). Native only: raises
    RuntimeError where the native voxelizer cannot be built."""
    return _BANK.grid(cls, inst, dim)

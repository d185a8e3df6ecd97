"""A procedural stand-in for Crytek Sponza's atrium: an open-roofed court
with two storeys of round-arched arcades on its long sides, and the
furnishings the scene is known for.

Coordinates: x along the court's long axis, y up, z across; the court's
floor is y = 0.  The parts are those the source's mesh groups name
(``arch``, ``bricks``, ``ceiling``, ``chain``, ``column_a``-``c``,
``details``, ``fabric_*``, ``flagpole``, ``floor``, ``leaf``, the lion
reliefs, ``roof``, ``vase``, ``vase_hanging``, ``vase_round``), each sized
from the configuration's ``scene`` entry (scene units):

* columns: closed surfaces of revolution, a base, a fluted shaft and a
  flaring capital under a square abacus, on each long side and storey;
* arcades: one closed wall a side and storey whose underside is a row of
  semicircular arches springing from the columns' axes;
* slabs and walls: a gallery slab and a roof slab with lips over the
  court, outer walls and end walls in horizontal courses;
* a lion's head in relief, on a plaque, on each end wall;
* round vases with plants of thin leaves along the court's edges;
* vases hung on chains of oval links from the upper arches' crowns;
* fabric: drapes in the lower bays, curtains in the upper ones, and
  banners hung from flagpoles over the court;
* a floor of square tiles.

Every solid is closed and made without T-junctions: a surface of
revolution, a torus or a relief is one grid closed on itself with fans at
its poles; the faces of a box share the coordinate arrays of its edges;
an arcade wall's front and back share one 2-D triangulation whose arches,
verticals and top edge are the same points as its underside, top and
ends.  Solids meet by overlapping, never in a shared plane, so no two
triangles overlap in a plane.  The floor, the leaves and the fabric are
sheets.  At a small ``target_tris`` every part is made with fewer
segments, bays and leaves.  The mesh depends on the entry alone; the
plants' leaves are drawn from a generator seeded with ``leaf_seed``.
"""

from __future__ import annotations

import math

import numpy as np

FULL = 262267   # the triangle count the full-detail layout is sized for
LEAF_TRIS = 3   # triangles a leaf


def _quads(P: np.ndarray) -> np.ndarray:
    """Two triangles a cell of the (nu + 1, nv + 1, 3) vertex grid ``P``."""
    a, b, c, d = P[:-1, :-1], P[1:, :-1], P[1:, 1:], P[:-1, 1:]
    return np.stack([np.stack([a, b, c], -2), np.stack([a, c, d], -2)], 2).reshape(-1, 3, 3)


def _plane(axis: int, value: float, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The vertex grid of the plane ``p[axis] == value`` over the other two
    axes' coordinates ``u`` and ``v``, in axis order."""
    P = np.empty((len(u), len(v), 3))
    a, b = [k for k in range(3) if k != axis]
    P[..., axis] = value
    P[..., a] = u[:, None]
    P[..., b] = v[None, :]
    return P


def _box(xs: np.ndarray, ys: np.ndarray, zs: np.ndarray) -> np.ndarray:
    """A closed box over the coordinate arrays of its three edges."""
    out = []
    for axis, (cs, u, v) in enumerate(((xs, ys, zs), (ys, xs, zs), (zs, xs, ys))):
        for value in (cs[0], cs[-1]):
            out.append(_quads(_plane(axis, value, u, v)))
    return np.concatenate(out)


def _steps(lo: float, hi: float, n: int) -> np.ndarray:
    return np.linspace(lo, hi, int(n) + 1)


def _closed_grid(P: np.ndarray, bottom: np.ndarray, top: np.ndarray) -> np.ndarray:
    """A surface closed on itself: the (seg, m + 1, 3) grid ``P``, whose
    first index runs around, joined to its first column, with fans from
    the points ``bottom`` and ``top`` to its first and last rings."""
    ring = np.concatenate([P, P[:1]])                                   # wrap around
    fans = [np.stack([np.broadcast_to(c, (len(P), 3)), r[:-1], r[1:]], 1)
            for c, r in ((bottom, ring[:, 0]), (top, ring[:, -1]))]
    return np.concatenate([_quads(ring), *fans])


def _lathe(x: float, z: float, r: np.ndarray, y: np.ndarray, seg: int,
           flute: np.ndarray | None = None) -> np.ndarray:
    """A closed surface of revolution about the vertical through (x, z):
    radius ``r[k]`` (all > 0) at height ``y[k]`` (increasing), ``seg``
    segments around; ring k's every other vertex pulled in by the fraction
    ``flute[k]``; flat fans close both ends."""
    th = 2.0 * np.pi * np.arange(seg) / seg
    pull = np.zeros(len(r)) if flute is None else np.asarray(flute)
    rad = np.asarray(r)[None, :] * (1.0 - pull[None, :] * (np.arange(seg) % 2)[:, None])
    P = np.empty((seg, len(r), 3))
    P[..., 0] = x + rad * np.cos(th)[:, None]
    P[..., 1] = np.asarray(y)[None, :]
    P[..., 2] = z + rad * np.sin(th)[:, None]
    return _closed_grid(P, np.array([x, y[0], z]), np.array([x, y[-1], z]))


def _column(x: float, z: float, y0: float, y1: float, r: float, cap_h: float, seg: int,
            rings: int, flute: float) -> np.ndarray:
    """A column from y0 to y1 on the axis (x, z): a two-step base, a
    fluted shaft of ``rings`` rows narrowing by a sixth, a necking and a
    capital flaring to 1.45 r, then a square abacus."""
    h = y1 - y0 - 0.35 * cap_h
    shaft = [(1.0 - t / 6.0, 0.1 + 0.72 * t) for t in np.linspace(0.0, 1.0, rings + 1)]
    if seg >= 16:
        base = [(1.35, 0.0), (1.35, 0.04), (1.2, 0.05), (1.2, 0.08), (1.05, 0.09)]
        top = [(0.9, 0.84), (0.95, 0.86), (0.88, 0.88), (1.1, 0.94), (1.35, 0.98), (1.45, 1.0)]
    else:   # the same outline in fewer rings
        base, top = [(1.35, 0.0), (1.2, 0.06)], [(0.9, 0.86), (1.45, 1.0)]
    prof = np.array(base + shaft + top)
    flutes = np.r_[np.zeros(len(base)), np.full(len(shaft), flute), np.zeros(len(top))]
    lathe = _lathe(x, z, r * prof[:, 0], y0 + h * prof[:, 1], seg, flutes)
    a = 1.5 * r
    abacus = _box(_steps(x - a, x + a, 1), _steps(y0 + h - 0.05 * cap_h, y1, 1),
                  _steps(z - a, z + a, 1))
    return np.concatenate([lathe, abacus])


def _fan_quads(A: np.ndarray, B: np.ndarray, C: np.ndarray, D: np.ndarray) -> np.ndarray:
    """Triangles of the planar quads (A, B, C, D) (arrays of (n, 2)
    points), each split along the diagonal that keeps both halves turned
    as the quad: A-C where it does, else B-D."""
    def area(p, q, r):
        return (q[:, 0] - p[:, 0]) * (r[:, 1] - p[:, 1]) - (q[:, 1] - p[:, 1]) * (r[:, 0] - p[:, 0])

    s = np.sign(area(A, B, C) + area(A, C, D))
    ac = (np.sign(area(A, B, C)) == s) & (np.sign(area(A, C, D)) == s)
    t1 = np.where(ac[:, None, None], np.stack([A, B, C], 1), np.stack([A, B, D], 1))
    t2 = np.where(ac[:, None, None], np.stack([A, C, D], 1), np.stack([B, C, D], 1))
    return np.concatenate([t1, t2])


def _arcade(xcol: np.ndarray, y_spring: float, y_top: float, z_front: float, z_back: float,
            n: int) -> np.ndarray:
    """The closed arcade wall over the columns at ``xcol``: between each
    two columns a semicircular arch of ``n`` segments springing at
    ``y_spring`` from the columns' axes, the wall up to ``y_top``, from
    ``z_front`` to ``z_back``."""
    left, right = xcol[:-1], xcol[1:]
    R, xc = (right - left) / 2.0, (left + right) / 2.0
    H = y_top - y_spring
    # boundary points: a up the left side, b along the top, a down the right,
    # in the arc's proportions about its center
    a = max(1, int(round(n * (math.pi - math.atan2(H, -float(R[0]))) / math.pi)))
    b = max(1, n - 2 * a)
    n = 2 * a + b
    th = np.pi * (1.0 - np.arange(n + 1) / n)
    Px = xc[:, None] + R[:, None] * np.cos(th)
    Py = y_spring + R[:, None] * np.sin(th)
    Px[:, 0], Px[:, -1] = left, right
    Py[:, 0] = Py[:, -1] = y_spring
    yv = _steps(y_spring, y_top, a)
    xt = left[:, None] + (right - left)[:, None] * (np.arange(b + 1) / b)
    xt[:, 0], xt[:, -1] = left, right
    nb = len(left)
    Qx = np.concatenate([np.repeat(left[:, None], a + 1, 1), xt[:, 1:],
                         np.repeat(right[:, None], a, 1)], 1)
    Qy = np.concatenate([np.broadcast_to(yv, (nb, a + 1)), np.full((nb, b), y_top),
                         np.broadcast_to(yv[::-1][1:], (nb, a))], 1)
    P = np.stack([Px, Py], -1)
    Q = np.stack([Qx, Qy], -1)
    # the first and last cells are triangles (P_0 = Q_0, P_n = Q_n)
    first = np.stack([P[:, 0], P[:, 1], Q[:, 1]], 1)
    last = np.stack([P[:, -2], P[:, -1], Q[:, -2]], 1)
    mid = _fan_quads(*(x.reshape(-1, 2) for x in (P[:, 1:-2], P[:, 2:-1], Q[:, 2:-1], Q[:, 1:-2])))
    flat = np.concatenate([first, last, mid])                          # (m, 3, 2)
    out = []
    for z in (z_front, z_back):
        out.append(np.concatenate([flat, np.full(flat.shape[:2] + (1,), z)], -1))
    zz = np.array([z_front, z_back])

    def strip(x, y):  # the surface swept from z_front to z_back along points (x, y)
        G = np.empty((len(x), 2, 3))
        G[..., 0], G[..., 1], G[..., 2] = x[:, None], y[:, None], zz[None, :]
        return _quads(G)

    for j in range(nb):
        out.append(strip(Px[j], Py[j]))
    top = np.concatenate([xt[:, :-1].ravel(), xcol[-1:]])
    out.append(strip(top, np.full(len(top), y_top)))
    for x in (xcol[0], xcol[-1]):
        out.append(strip(np.full(a + 1, x), yv))
    return np.concatenate(out)


def _sheet(x0: float, x1: float, y0: float, y1: float, z: float, folds: int, strips: int,
           rows: int, depth: float) -> np.ndarray:
    """Fabric from x0 to x1 hung from y0 down to y1 at ``z``, in ``folds``
    folds of ``strips`` strips and ``rows`` rows, bellying towards -z by up
    to ``depth`` at the hem."""
    u = np.linspace(0.0, 1.0, strips + 1)
    v = np.linspace(0.0, 1.0, rows + 1)
    P = np.empty((strips + 1, rows + 1, 3))
    P[..., 0] = (x0 + (x1 - x0) * u)[:, None]
    P[..., 1] = (y0 + (y1 - y0) * v)[None, :]
    fold = 0.5 * (1.0 - np.cos(2.0 * np.pi * folds * u))
    P[..., 2] = z - depth * (0.3 + 0.7 * v[None, :]) * fold[:, None]
    return _quads(P)


def _torus(c: np.ndarray, u: np.ndarray, v: np.ndarray, R: tuple[float, float], r: float,
           seg: int, sides: int) -> np.ndarray:
    """A closed oval ring about ``c`` in the plane of the unit vectors u and
    v, semi-axes R along them, tube radius r, ``seg`` x ``sides`` cells."""
    a = 2.0 * np.pi * np.arange(seg) / seg
    b = 2.0 * np.pi * np.arange(sides) / sides
    w = np.cross(u, v)
    spine = c + R[0] * np.cos(a)[:, None] * u + R[1] * np.sin(a)[:, None] * v        # (seg, 3)
    out_dir = np.cos(a)[:, None] * u + np.sin(a)[:, None] * v
    P = (spine[:, None] + r * np.cos(b)[None, :, None] * out_dir[:, None]
         + r * np.sin(b)[None, :, None] * w)                                           # (seg, sides, 3)
    P = np.concatenate([P, P[:, :1]], 1)
    P = np.concatenate([P, P[:1]], 0)
    return _quads(P)


def _chain(x: float, y_top: float, z: float, links: int, size: float, seg: int,
           sides: int) -> np.ndarray:
    """``links`` interlocking oval links hung from (x, y_top, z), each
    turned a quarter about the vertical from the last."""
    ex, ey, ez = np.eye(3)
    out = []
    pitch = 2.2 * size
    for k in range(links):
        c = np.array([x, y_top - (k + 0.5) * pitch, z])
        out.append(_torus(c, ey, ex if k % 2 == 0 else ez, (1.5 * size, 0.8 * size),
                          0.22 * size, seg, sides))
    return np.concatenate(out)


def _relief(c: np.ndarray, radii: tuple[float, float, float], lat: int, lon: int) -> np.ndarray:
    """A lion's head in relief: a closed, bumped ellipsoid about ``c`` with
    semi-axes ``radii`` (depth along x, then y and z), ``lat`` rings."""
    th = np.pi * np.arange(1, lat) / lat                     # from the top pole down
    ph = 2.0 * np.pi * np.arange(lon) / lon
    bump = 1.0 + 0.12 * np.sin(5.0 * th)[None, :] * np.cos(3.0 * ph)[:, None] \
        + 0.06 * np.cos(9.0 * ph)[:, None] * np.sin(th)[None, :] ** 2
    s, co = np.sin(th)[None, :], np.cos(th)[None, :]
    P = np.empty((lon, lat - 1, 3))
    P[..., 0] = c[0] + radii[0] * bump * s * np.cos(ph)[:, None]
    P[..., 1] = c[1] + radii[1] * bump * co
    P[..., 2] = c[2] + radii[2] * bump * s * np.sin(ph)[:, None]
    return _closed_grid(P, c + np.array([0.0, radii[1], 0.0]), c - np.array([0.0, radii[1], 0.0]))


def _plant(x: float, y: float, z: float, leaves: int, size: float,
           rng: np.random.Generator) -> np.ndarray:
    """``leaves`` thin leaves, each a folded blade of 3 triangles, rising
    from a disc of radius size / 4 at height y over (x, z) and drooping
    outwards."""
    az = rng.uniform(0.0, 2.0 * np.pi, leaves)
    el = rng.uniform(0.35, 1.35, leaves)
    length = size * rng.uniform(0.55, 1.0, leaves)
    width = length / rng.uniform(12.0, 18.0, leaves)
    rad = 0.25 * size * np.sqrt(rng.uniform(0.0, 1.0, leaves))
    base = np.stack([x + rad * np.cos(az), y + 0.05 * size * rng.uniform(0.0, 1.0, leaves),
                     z + rad * np.sin(az)], -1)
    d = np.stack([np.cos(el) * np.cos(az), np.sin(el), np.cos(el) * np.sin(az)], -1)
    side = np.stack([-np.sin(az), np.zeros(leaves), np.cos(az)], -1)
    up = np.cross(side, d)

    def at(s, w):  # the point a fraction s along the midrib, w of the width aside, rims raised
        droop = np.array([0.0, -0.45, 0.0]) * (s * s)
        return (base + (length * s)[:, None] * (d + droop) + (width * w)[:, None] * side
                + (0.15 * width * abs(w))[:, None] * up)

    l0, r0, l1, r1, tip = at(0.0, -0.3), at(0.0, 0.3), at(0.5, -0.5), at(0.5, 0.5), at(1.0, 0.0)
    return np.concatenate([np.stack([l0, r0, r1], 1), np.stack([l0, r1, l1], 1),
                           np.stack([l1, r1, tip], 1)])


def _detail(d: float) -> dict:
    """The segment and bay counts at detail ``d`` (1 at FULL triangles)."""
    def at_least(lo, x):
        return max(lo, int(round(x)))

    r = math.sqrt(d)
    return dict(bays=at_least(2, 11 * r), seg=2 * at_least(2, 14 * d), rings=at_least(1, 8 * d),
                arc=at_least(4, 48 * d), courses=at_least(1, 60 * d),
                drape_strips=at_least(4, 120 * d), drape_rows=at_least(1, 8 * d),
                curtain_strips=at_least(4, 60 * d), curtain_rows=at_least(1, 8 * d),
                banner_strips=at_least(1, 16 * d), banner_rows=at_least(1, 24 * d),
                flags=at_least(1, 4 * r), links=at_least(2, 7 * r), link_seg=at_least(4, 12 * r),
                link_sides=at_least(3, 6 * r), vase_seg=at_least(4, 32 * d),
                relief_lat=at_least(3, 40 * r), relief_lon=at_least(4, 60 * r),
                tiles=at_least(2, 60 * r))


VASE = (np.array([0.45, 0.75, 0.95, 1.0, 0.9, 0.6, 0.5, 0.62, 0.7]),
        np.array([0.0, 0.08, 0.3, 0.5, 0.7, 0.85, 0.92, 0.98, 1.0]))   # (radius, height) / size


def _vase(x: float, y0: float, z: float, size: float, seg: int, rings: int = 1) -> np.ndarray:
    """A closed vase of height ``size`` standing at (x, y0, z), its outline
    ``VASE`` in ``rings`` rows a segment (every third point below 16
    segments around)."""
    r, y = VASE if seg >= 16 else (VASE[0][::3], VASE[1][::3])
    t = np.linspace(0.0, 1.0, (len(y) - 1) * rings + 1)
    k = np.linspace(0.0, 1.0, len(y))
    return _lathe(x, z, 0.5 * size * np.interp(t, k, r), y0 + size * np.interp(t, k, y), seg)


def _building(s: dict, k: dict) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(solids, sheets) of the atrium at the counts ``k``, all but the
    plants' leaves."""
    L, W, G = s["length"], s["width"], s["gallery_depth"]
    t, to, te = s["arcade_thickness"], s["outer_wall_thickness"], s["end_wall_thickness"]
    h1, h2, slab, lip = s["gallery_floor"], s["roof"], s["slab_thickness"], s["lip"]
    sink = 0.5 * slab                      # how far feet and tops are sunk into what holds them
    xend = L / 2.0 + 0.4 * s["column_radius"][0]   # the end columns' axes, inside the end walls
    zin = W / 2.0 + t + G                  # the outer walls' inner faces
    solids, sheets = [], []
    for side in (-1.0, 1.0):
        zf, zb = sorted((side * W / 2.0, side * (W / 2.0 + t)))
        zc = side * (W / 2.0 + t / 2.0)
        for storey, (base, spring, top) in enumerate(((0.0, s["spring"][0], h1 - slab / 2.0),
                                                      (h1, s["spring"][1], h2 - slab / 2.0))):
            xcol = _steps(-xend, xend, k["bays"] * (storey + 1))
            r = s["column_radius"][storey]
            for x in xcol:
                solids.append(_column(x, zc, base - sink * (0.5 + 0.1 * storey), spring + 0.01,
                                      r, s["capital_height"][storey], k["seg"], k["rings"],
                                      s["flute"]))
            solids.append(_arcade(xcol, spring, top, zf, zb, k["arc"]))
        # the gallery slab and the roof slab, lips over the court, ends inside the walls
        zl, zo = side * (W / 2.0 - lip), side * (zin + to / 2.0)
        for y0, y1, extra in ((h1 - slab, h1, 0.0), (h2 - slab, h2, 0.5 * lip)):
            zl_ = zl - side * extra
            solids.append(_box(_steps(-(L / 2.0 + 0.45 * te), L / 2.0 + 0.45 * te, k["courses"]),
                               _steps(y0, y1, 1), np.sort([zl_, zo])))
        # the outer wall, in courses
        solids.append(_box(_steps(-(L / 2.0 + 0.6 * te), L / 2.0 + 0.6 * te, 1),
                           _steps(-0.3 * slab, h2 + s["parapet"], k["courses"]),
                           np.sort([side * zin, side * (zin + to)])))
        lower, upper = _steps(-xend, xend, k["bays"]), _steps(-xend, xend, 2 * k["bays"])
        # drapes from the gallery slab's lip in every other lower bay, curtains
        # behind every other upper arch
        for j in range(0, k["bays"], 2):
            m = 0.06 * (lower[j + 1] - lower[j])
            sheets.append(_sheet(lower[j] + m, lower[j + 1] - m, h1 - slab / 2.0, s["drape_hem"],
                                 side * (W / 2.0 - lip - s["drape_offset"]), s["drape_folds"],
                                 k["drape_strips"], k["drape_rows"], side * s["drape_depth"]))
        for j in range(1, 2 * k["bays"], 2):
            m = 0.1 * (upper[j + 1] - upper[j])
            sheets.append(_sheet(upper[j] + m, upper[j + 1] - m, s["spring"][1], h1 + 0.05,
                                 side * (W / 2.0 + t + s["drape_offset"]), s["drape_folds"] - 2,
                                 k["curtain_strips"], k["curtain_rows"], -side * s["drape_depth"]))
        # vases hung on chains from every other upper arch's crown
        size = s["hanging_vase"]
        for j in range(0, 2 * k["bays"], 2):
            x = 0.5 * (upper[j] + upper[j + 1])
            crown = s["spring"][1] + 0.5 * (upper[j + 1] - upper[j])
            chain = _chain(x, crown + 0.01, zc, k["links"], s["link"], k["link_seg"], k["link_sides"])
            solids.append(chain)
            y_end = crown + 0.01 - k["links"] * 2.2 * s["link"]
            solids.append(_vase(x, y_end - 0.9 * size, zc, size, k["vase_seg"]))
        # round vases along the court's edge, between every third pair of columns
        size = s["round_vase"]
        for j in range(1, k["bays"], 3):
            solids.append(_vase(0.5 * (lower[j] + lower[j + 1]), -0.005,
                                side * (W / 2.0 - s["vase_inset"]), size, k["vase_seg"], 2))
        # flagpoles over the court from the roof slab's lip, banners hung from them
        for x in _steps(-0.3 * L, 0.3 * L, max(1, k["flags"] - 1))[: k["flags"]]:
            # from inside the upper arcade wall, over its crowns, out over the court
            z0, z1 = side * (W / 2.0 + t / 2.0), side * (W / 2.0 - s["pole"])
            y = 0.5 * (s["spring"][1] + h2)
            solids.append(_box(_steps(x - 0.008, x + 0.008, 1), _steps(y - 0.008, y + 0.008, 1),
                               _steps(min(z0, z1), max(z0, z1), 2)))
            sheets.append(_sheet(x - 0.06, x + 0.06, y - 0.012, y - s["banner"],
                                 side * (W / 2.0 - 0.6 * s["pole"]), 1, k["banner_strips"],
                                 k["banner_rows"], 0.004 * side))
    zall = zin + to + s["buttress"]        # the end walls stand out of the outer walls' faces
    for side in (-1.0, 1.0):
        xs = np.sort([side * L / 2.0, side * (L / 2.0 + te)])
        solids.append(_box(xs, _steps(-0.4 * slab, h2 + 2.0 * s["parapet"], k["courses"]),
                           _steps(-zall, zall, 1)))
        # a plaque sunk into the end wall, a lion's head on it
        xi = side * L / 2.0
        solids.append(_box(np.sort([xi + side * 0.01, xi - side * 0.025]), _steps(0.26, 0.5, 1),
                           _steps(-0.11, 0.11, 1)))
        solids.append(_relief(np.array([xi - side * 0.025, 0.38, 0.0]), (0.045, 0.1, 0.085),
                              k["relief_lat"], k["relief_lon"]))
    # the floor, a sheet of square tiles under the court, galleries and walls
    x = L / 2.0 + te / 2.0
    z = zin + to / 2.0
    nx = k["tiles"]
    sheets.append(_quads(_plane(1, 0.0, _steps(-x, x, nx), _steps(-z, z, max(1, round(nx * z / x))))))
    return solids, sheets


def _plants(s: dict, k: dict, leaves: int) -> list[np.ndarray]:
    """The round vases' plants, ``leaves`` leaves in all, shared out in
    turn."""
    L, W = s["length"], s["width"]
    xend = L / 2.0 + 0.4 * s["column_radius"][0]
    lower = _steps(-xend, xend, k["bays"])
    rng = np.random.default_rng(int(s["leaf_seed"]))
    size = s["round_vase"]
    spots = [(0.5 * (lower[j] + lower[j + 1]), side * (W / 2.0 - s["vase_inset"]))
             for side in (-1.0, 1.0) for j in range(1, k["bays"], 3)]
    return [_plant(x, size * 0.96, z, leaves // len(spots) + (i < leaves % len(spots)),
                   s["plant"], rng) for i, (x, z) in enumerate(spots)]


def generate(scene: dict) -> np.ndarray:
    """(T, 3, 3) float32 triangles of the atrium at about
    ``scene["target_tris"]`` triangles (module docstring): the parts at
    the detail the count allows, then the plants' leaves to the count."""
    target = int(scene["target_tris"])
    d = min(1.0, target / FULL)
    while True:
        k = _detail(d)
        solids, sheets = _building(scene, k)
        rest = sum(len(p) for p in solids + sheets)
        plants = 2 * len(range(1, k["bays"], 3))
        if rest <= target - plants * LEAF_TRIS * 8 or d < 1e-3:
            break
        d *= 0.9
    # the leaves take what the rest leaves; the last leaf may lose its tip
    leaves = np.concatenate(_plants(scene, k, -(-(target - rest) // LEAF_TRIS)))
    parts = solids + sheets + [leaves[: max(0, target - rest)]]
    return np.ascontiguousarray(np.concatenate(parts), dtype=np.float32)

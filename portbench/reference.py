"""The plain reference the benchmark holds the program's frames to.

It imports nothing of the program and takes nothing the program made:
from the triangles, the sky and the gestures that the benchmark generated
and handed to both sides, it works out again the scene's frame (center
and extent), the viewer's camera and object transforms after each
gesture (a frozen copy of the viewer's trackball: the reference
renderer's ray.cpp:76-173, 891-918, 1076-1085), its own bounding volume
hierarchy, and the colour of a sample of pixels: pinhole rays at the
frame's sub-pixel jitters, ``bounces`` rounds of closest hit against the
triangles' flat normals with Schlick reflection and a Lambert term behind
a hard shadow ray, the lat-long environment's bilinear term, the mean of
the samples and the filmic tonemap (the reference shader,
raytracer.es.fs:58-149, 445-482, 524-550).

Precision: every ray, matrix and triangle test is computed in float64
from the float32 inputs, so the reference is the answer the float32
program approximates.  ``precision="tf32"`` is the control: the same
function in float32 with every operand of a transform product and of the
triangle test rounded to TF32 (10 mantissa bits), as TF32 matrix products
would compute them; it has to come out not correct.

The hierarchy is a complete binary tree of median splits along the
longest axis of each node's centroids, 2**depth leaves of up to ``slots``
triangles; the walk is vectorised over rays in plain PyTorch (one node a
ray a step, nearer child first), on whatever device the tensors are on.
The walk also counts the work a sequential walk with early exits does on
these rays, which the roofline's operation bound charges (costs.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

INFINITELY_FAR = 1.0e7   # a miss's distance (fs:300)
PI = 3.14159265259       # the shader's own pi (fs:116), kept verbatim
TAU = 2.0 * PI
BUMPOUT = 1e-5           # triangle box padding (vectormath.h:191)
SURFACE_FUDGE = 1e-4     # reflect origin offset (fs:87)
STACK = 64

# (name, F0, metal) of ray.cpp:54-65, and the diffuse colours of :68-73
MATERIALS = [
    ("gold", (1.0, 0.71, 0.29), True),
    ("silver", (0.95, 0.95, 0.88), True),
    ("copper", (0.95, 0.64, 0.54), True),
    ("iron", (0.56, 0.57, 0.58), True),
    ("aluminum", (0.91, 0.92, 0.92), True),
    ("plastic/glass (low)", (0.03, 0.03, 0.03), False),
    ("plastic high", (0.05, 0.05, 0.05), False),
]
DIFFUSE_COLORS = [(1.0, 1.0, 1.0), (1.0, 0.5, 0.5), (0.25, 1.0, 0.25), (0.5, 0.5, 1.0)]


# --- 4x4 matrices, float32 as the viewer keeps them (vectormath.h) ----------

def _translation(x, y, z) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 3], m[1, 3], m[2, 3] = x, y, z
    return m


def _rotation(a, x, y, z) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    t = 1.0 - c
    return np.array([
        [t * x * x + c, t * x * y - s * z, t * x * z + s * y, 0.0],
        [t * x * y + s * z, t * y * y + c, t * y * z - s * x, 0.0],
        [t * x * z - s * y, t * y * z + s * x, t * z * z + c, 0.0],
        [0.0, 0.0, 0.0, 1.0],
    ], dtype=np.float32)


def _mult(m1: np.ndarray, m2: np.ndarray) -> np.ndarray:
    """vectormath.h's mat4_mult(m1, m2): m2 @ m1."""
    return (m2.astype(np.float64) @ m1.astype(np.float64)).astype(np.float32)


def _invert(m: np.ndarray) -> np.ndarray:
    return np.linalg.inv(m.astype(np.float64)).astype(np.float32)


def _zero_bottom_row(m: np.ndarray) -> np.ndarray:
    r = m.copy()
    r[3, 0:3] = 0.0
    return r


def _axis_angle(m: np.ndarray) -> np.ndarray:
    """[angle, x, y, z] of a rotation matrix (vectormath.h:519-557)."""
    cosine = float(np.clip((m[0, 0] + m[1, 1] + m[2, 2] - 1.0) / 2.0, -1.0, 1.0))
    r = np.zeros(4, dtype=np.float32)
    r[0] = np.arccos(cosine)
    r[1], r[2], r[3] = m[2, 1] - m[1, 2], m[0, 2] - m[2, 0], m[1, 0] - m[0, 1]
    d = np.sqrt(r[1] * r[1] + r[2] * r[2] + r[3] * r[3])
    if d > 0:
        r[1:] /= d
    return r


def _trackball(prev: np.ndarray, dx: float, dy: float) -> np.ndarray:
    """A drag of (dx, dy) in window fractions composed onto an axis-angle
    rotation (ray.cpp:76-98)."""
    if dx == 0 and dy == 0:
        return prev
    dist = float(np.sqrt(dx * dx + dy * dy))
    rot = np.array([np.pi * dist, dy / dist, dx / dist, 0.0], dtype=np.float32)
    m1 = _rotation(prev[0], prev[1], prev[2], prev[3])
    m2 = _rotation(rot[0], rot[1], rot[2], rot[3])
    return _axis_angle(_mult(m2, m1))


class View(NamedTuple):
    """One frame's uniforms, float32 as the viewer hands them over."""

    camera_normal: np.ndarray   # (4, 4) eye -> world directions
    camera_origin: np.ndarray   # (3,)
    object_matrix: np.ndarray   # (4, 4) world -> object points
    object_normal: np.ndarray   # (4, 4) world -> object directions
    normal_inverse: np.ndarray  # (4, 4) object -> world normals
    light_dir: np.ndarray       # (3,)
    specular: np.ndarray        # (3,)
    diffuse: np.ndarray         # (3,)
    image_plane_width: float    # 2 tan(fov / 2), rounded to float32


def scene_frame(tri: np.ndarray) -> tuple[np.ndarray, float]:
    """(center, extent) of the triangles: the center of their padded
    bounding box, twice the largest vertex distance from it
    (world.cpp:106-117)."""
    boxmin = (tri - BUMPOUT).min(axis=1).astype(np.float32).min(axis=0)
    boxmax = (tri + BUMPOUT).max(axis=1).astype(np.float32).max(axis=0)
    center = ((boxmin + boxmax) * 0.5).astype(np.float32)
    d = center[None, None, :] - tri
    return center, float(np.sqrt((d * d).sum(axis=-1).max())) * 2.0


DRAG_KEYS = {"light": "l", "object": "o"}   # the App's key that makes a drag turn the target


def replay_views(tri: np.ndarray, width: int, height: int, fov_degrees: float,
                 material: int, diffuse_color: int, gestures, wanted, drags=()) -> dict[int, View]:
    """The viewer's uniforms after each gesture index in ``wanted``: the
    viewer starts with the scene framed (zoom extent / 2 / sin(fov / 2)),
    no rotation and the light at -20 degrees about (1, -1, 0); then each
    of the configuration's ``drags`` in order, ``{"target": "light" |
    "object", "x", "y"}`` with x and y fractions of the window's width and
    height; gesture i is then a press at the window's center, a move by
    (dx, dy) pixels and a release, which turns the object by the
    trackball (ray.cpp:891-918).  A drag turns the light's trackball by
    (+dx / width, +dy / height) and the object's by (-dx / width,
    -dy / height), as the viewer does."""
    center, extent = scene_frame(tri)
    fov = float(fov_degrees) * np.pi / 180.0
    zoom = float(extent / 2.0 / np.sin(fov / 2.0))
    cam = _translation(0.0, 0.0, zoom)
    cam_normal = _zero_bottom_row(np.ascontiguousarray(_invert(cam).T))
    x0, y0 = width / 2.0, height / 2.0

    def moved(dx: float, dy: float) -> tuple[float, float]:
        # the move as the viewer sees it: press at the center, release at center + (dx, dy)
        return ((x0 + dx) - x0) / width, ((y0 + dy) - y0) / height

    light_rot = np.array([-20.0 * np.pi / 180.0, 0.707, -0.707, 0.0], dtype=np.float32)
    rotation = np.zeros(4, dtype=np.float32)
    for d in drags:
        if d["target"] not in DRAG_KEYS:
            raise ValueError(f"drag target {d['target']!r}: use one of {sorted(DRAG_KEYS)}")
        mx, my = moved(float(d["x"]) * width, float(d["y"]) * height)
        if d["target"] == "light":
            light_rot = _trackball(light_rot, mx, my)
        else:
            rotation = _trackball(rotation, -mx, -my)
    light_m = _rotation(*light_rot)
    light_normal = _zero_bottom_row(_invert(np.ascontiguousarray(light_m.T)))
    light = light_normal[:3, :3] @ np.array([0.0, 0.0, 1.0], np.float32)
    _, f0, metal = MATERIALS[material % len(MATERIALS)]
    spec = np.asarray(f0, np.float32)
    diff = np.zeros(3, np.float32) if metal else np.asarray(
        DIFFUSE_COLORS[diffuse_color % len(DIFFUSE_COLORS)], np.float32)
    ipw = float(np.float32(2.0 * np.tan(fov / 2.0)))
    wanted = set(wanted)
    views = {}
    for i, (dx, dy) in enumerate(gestures):
        if i > max(wanted, default=-1):
            break
        mx, my = moved(dx, dy)
        rotation = _trackball(rotation, -mx, -my)
        if i not in wanted:
            continue
        rot_m = _rotation(rotation[0], rotation[1], rotation[2], rotation[3])
        obj = _mult(rot_m, _translation(center[0], center[1], center[2]))
        views[i] = View(
            camera_normal=cam_normal, camera_origin=cam[:3, 3].copy(), object_matrix=obj,
            object_normal=_zero_bottom_row(_invert(np.ascontiguousarray(obj.T))),
            normal_inverse=_zero_bottom_row(np.ascontiguousarray(obj.T)),
            light_dir=light, specular=spec, diffuse=diff, image_plane_width=ipw)
    return views


def halton(i: int, b: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= b
        r += f * (i % b)
        i //= b
    return r


def halton_jitters(samples: int) -> np.ndarray:
    """(K, 2) sub-pixel jitters of a progressive batch of K samples: the
    Halton points (s + 1) in bases 2 and 3, less 0.5, float32."""
    return np.asarray([[halton(s + 1, 2) - 0.5, halton(s + 1, 3) - 0.5] for s in range(samples)],
                      np.float32)


# --- precision ---------------------------------------------------------------

def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero), as a TF32 matrix unit reads its operands."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Arith:
    """The arithmetic of one precision: ``dtype`` and the rounding ``q``
    of a transform's or a triangle test's operands."""

    def __init__(self, precision: str):
        if precision not in ("f64", "tf32"):
            raise ValueError(f"precision {precision!r}: use f64 or tf32")
        self.dtype = torch.float64 if precision == "f64" else torch.float32
        self.q = (lambda x: x) if precision == "f64" else tf32

    def mat(self, m: np.ndarray, device) -> torch.Tensor:
        return self.q(torch.as_tensor(np.asarray(m, np.float32), device=device)).to(self.dtype)

    def apply(self, m: torch.Tensor, v: torch.Tensor, w: float) -> torch.Tensor:
        """(4, 4) ``m``, or one (R, 4, 4) matrix a row, on the (R, 3) rows
        of ``v`` (w = 1 points, 0 directions), each product term by term."""
        v = self.q(v)
        out = v[..., 0:1] * m[..., :3, 0] + v[..., 1:2] * m[..., :3, 1] + v[..., 2:3] * m[..., :3, 2]
        return out + m[..., :3, 3] if w else out


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _normalize(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


# --- the hierarchy and its walk ----------------------------------------------

class Work(NamedTuple):
    """What a sequential walk with early exits does on a set of rays:
    slab tests of non-empty boxes, triangle tests, the tests that passed
    the distance test, and those that then passed u."""

    slabs: int
    tris: int
    tris_t: int
    tris_u: int


class BVH:
    """A complete binary tree of median splits over (T, 3, 3) triangles
    (module docstring).  Node k's children are 2k + 1 and 2k + 2; leaf j
    is node 2**depth - 1 + j and holds triangle slots j * slots to
    (j + 1) * slots - 1 of ``order`` (T where empty)."""

    def __init__(self, tri: torch.Tensor, leaf_target: int = 4):
        dev = tri.device
        T = tri.shape[0]
        self.tri = tri
        self.depth = max(0, math.ceil(math.log2(max(T, 1) / leaf_target)))
        n_leaves = 1 << self.depth
        self.slots = max(1, -(-T // n_leaves))
        n = n_leaves * self.slots
        cent = torch.full((n, 3), math.inf, dtype=tri.dtype, device=dev)
        cent[:T] = tri.mean(dim=1)
        order = torch.arange(n, device=dev)
        for level in range(self.depth):
            seg = torch.arange(n, device=dev) // (n >> level)
            c = cent[order]
            finite = torch.isfinite(c)
            nseg = 1 << level
            lo = torch.full((nseg, 3), math.inf, dtype=c.dtype, device=dev).scatter_reduce(
                0, seg[:, None].expand(n, 3), torch.where(finite, c, math.inf), "amin")
            hi = torch.full((nseg, 3), -math.inf, dtype=c.dtype, device=dev).scatter_reduce(
                0, seg[:, None].expand(n, 3), torch.where(finite, c, -math.inf), "amax")
            axis = torch.nan_to_num(hi - lo, nan=-1.0, posinf=-1.0, neginf=-1.0).argmax(dim=1)
            key = c.gather(1, axis[seg][:, None])[:, 0]
            by_key = torch.sort(key, stable=True).indices
            by_seg = torch.sort(seg[by_key], stable=True).indices
            order = order[by_key[by_seg]]
        self.order = torch.where(order < T, order, T)
        # boxes: leaves from their triangles, then each level from its children
        padded = torch.cat([tri, torch.full((1, 3, 3), math.nan, dtype=tri.dtype, device=dev)])
        slot_tris = padded[self.order].reshape(n_leaves, self.slots * 3, 3)
        empty = torch.isnan(slot_tris)
        levels = [(torch.where(empty, math.inf, slot_tris).amin(dim=1),
                   torch.where(empty, -math.inf, slot_tris).amax(dim=1))]
        while levels[0][0].shape[0] > 1:
            lo, hi = levels[0]
            levels.insert(0, (torch.minimum(lo[0::2], lo[1::2]), torch.maximum(hi[0::2], hi[1::2])))
        self.lo = torch.cat([lo for lo, _ in levels])
        self.hi = torch.cat([hi for _, hi in levels])
        self.first_leaf = n_leaves - 1

    def trace(self, P: torch.Tensor, D: torch.Tensor, active: torch.Tensor, any_hit: bool,
              q=lambda x: x) -> tuple[torch.Tensor, torch.Tensor, Work]:
        """(t, triangle id, work) of the rays (P, D), object space, where
        ``active``: the closest hit's distance (INFINITELY_FAR and -1 on a
        miss) or, ``any_hit``, any hit's.  ``q`` rounds the triangle test's
        operands."""
        dev, dtype = P.device, P.dtype
        R = P.shape[0]
        best_t = torch.full((R,), math.inf, dtype=dtype, device=dev)
        best_id = torch.full((R,), -1, dtype=torch.long, device=dev)
        inv = 1.0 / D
        stack = torch.zeros((R, STACK), dtype=torch.long, device=dev)
        sp = active.long()
        tri = self.tri.to(dtype)
        v0, e0, e1 = q(tri[:, 0]), q(tri[:, 1] - tri[:, 0]), q(tri[:, 0] - tri[:, 2])
        slot_range = torch.arange(self.slots, device=dev)
        work = torch.zeros(4, dtype=torch.long, device=dev)
        live = torch.nonzero(active)[:, 0]
        while live.numel():
            sp[live] -= 1
            node = stack[live, sp[live]]
            leaf = node >= self.first_leaf
            rays, nodes = live[~leaf], node[~leaf]
            if rays.numel():
                kids = torch.stack([2 * nodes + 1, 2 * nodes + 2], dim=1)           # (n, 2)
                lo, hi = self.lo[kids], self.hi[kids]                                # (n, 2, 3)
                o, iv = P[rays][:, None], inv[rays][:, None]
                t1, t2 = (lo - o) * iv, (hi - o) * iv
                near = torch.nan_to_num(torch.fmin(t1, t2), nan=-math.inf).amax(dim=2)
                far = torch.nan_to_num(torch.fmax(t1, t2), nan=math.inf).amin(dim=2) * (1 + 1e-9)
                full = lo[..., 0] <= hi[..., 0]
                hit = full & (near <= far) & (far >= 0) & (near <= best_t[rays][:, None])
                work[0] += full.sum()
                first = near[:, 0] <= near[:, 1]
                close = torch.where(first, kids[:, 0], kids[:, 1])
                far_kid = torch.where(first, kids[:, 1], kids[:, 0])
                both = hit[:, 0] & hit[:, 1]
                one = hit[:, 0] ^ hit[:, 1]
                only = torch.where(hit[:, 0], kids[:, 0], kids[:, 1])
                r1 = rays[both]
                stack[r1, sp[r1]] = far_kid[both]
                stack[r1, sp[r1] + 1] = close[both]
                sp[r1] += 2
                r2 = rays[one]
                stack[r2, sp[r2]] = only[one]
                sp[r2] += 1
            rays, nodes = live[leaf], node[leaf]
            if rays.numel():
                ids = self.order[((nodes - self.first_leaf) * self.slots)[:, None] + slot_range]
                real = ids < tri.shape[0]
                ids = torch.where(real, ids, 0)
                o, d = q(P[rays])[:, None], q(D[rays])[:, None]
                a0, a1, b0 = v0[ids], e0[ids], e1[ids]
                M = _cross(b0, d.expand_as(b0))
                det = _dot(a1, M)
                ok = real & (det != 0)
                inv_det = 1.0 / torch.where(ok, det, torch.ones_like(det))
                Tv = o - a0
                Q = _cross(Tv, a1)
                t = -_dot(b0, Q) * inv_det
                u = _dot(Tv, M) * inv_det
                v = _dot(d.expand_as(Q), Q) * inv_det
                t_ok = ok & (t >= 0.0) & (t <= best_t[rays][:, None])
                u_ok = t_ok & (u >= 0.0) & (u <= 1.0)
                hit = u_ok & (v >= 0.0) & (u + v <= 1.0) & (t <= 1e8)
                work[1] += real.sum()
                work[2] += t_ok.sum()
                work[3] += u_ok.sum()
                t = torch.where(hit, t, math.inf)
                tmin, k = t.min(dim=1)
                better = tmin < best_t[rays]
                rb = rays[better]
                best_t[rb] = tmin[better]
                best_id[rb] = ids[better, k[better]]
                if any_hit:
                    sp[rb] = 0
            live = live[sp[live] > 0]
        best_t = torch.where(torch.isfinite(best_t) & (best_t < INFINITELY_FAR), best_t,
                             torch.full_like(best_t, INFINITELY_FAR))
        return best_t, torch.where(best_t < INFINITELY_FAR, best_id, -1), Work(*work.tolist())


# --- the render model ----------------------------------------------------------

def env_bilinear(sky: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """Level-0 bilinear lat-long radiance along directions D (R, 3):
    u = 1 + atan2(-z, x) / tau, v = 1 - acos(y) / pi, row 0 the +y pole,
    REPEAT wrap in both axes (fs:121-125)."""
    h, w = sky.shape[:2]
    u = 1.0 + torch.atan2(-D[:, 2], D[:, 0]) / TAU
    v = 1.0 - torch.arccos(torch.clamp(D[:, 1], -1.0, 1.0)) / PI
    x = u * w - 0.5
    y = (1.0 - v) * h - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()

    def at(dy, dx):
        return sky[torch.remainder(yi + dy, h), torch.remainder(xi + dx, w)].to(D.dtype)

    return (at(0, 0) * (1 - fx) + at(0, 1) * fx) * (1 - fy) + (at(1, 0) * (1 - fx) + at(1, 1) * fx) * fy


def filmic(c: torch.Tensor) -> torch.Tensor:
    """The shader's filmic curve, per channel (fs:527-531)."""
    x = torch.clamp(c - 0.004, min=0.0)
    return (x * (6.2 * x + 0.5)) / (x * (6.2 * x + 1.7) + 0.06)


class Reference:
    """The scene as the reference holds it: triangles, flat normals, its
    own hierarchy and the sky, on ``device``, in ``precision``."""

    def __init__(self, tri: np.ndarray, sky: np.ndarray, device="cpu", precision: str = "f64"):
        self.ar = Arith(precision)
        dt = self.ar.dtype
        t = torch.as_tensor(np.asarray(tri, np.float32), device=device).to(dt)
        self.bvh = BVH(t)
        n = _cross(t[:, 1] - t[:, 0], t[:, 2] - t[:, 0])
        self.normals = n / torch.sqrt(_dot(n, n)).clamp_min(1e-300)[:, None]
        self.sky = torch.as_tensor(np.asarray(sky, np.float32), device=device)
        self.device = device

    def render(self, views: list[View], width: int, height: int, pixels: list[np.ndarray],
               jitters: np.ndarray, bounces: int = 3, shadows: bool = True,
               rays: int = 1 << 18) -> tuple[np.ndarray, Work]:
        """Tonemapped colours (n, 3) float64 of the pixels (indices row *
        width + column) ``pixels[f]`` of the frame at ``views[f]``, frame
        after frame: the mean over the (K, 2) ``jitters`` of each pixel's
        linear colour, then the filmic curve; and the walks' work.  The
        frames' rays go through the walks together, in blocks of about
        ``rays``."""
        frame = np.concatenate([np.full(len(p), f) for f, p in enumerate(pixels)])
        pix = np.concatenate([np.asarray(p, np.int64) for p in pixels])
        K = len(jitters)
        total = np.zeros((len(pix), 3))
        work = np.zeros(4, np.int64)
        per_block = max(1, rays // K)
        for b0 in range(0, len(pix), per_block):
            b1 = min(b0 + per_block, len(pix))
            col, w = self._linear(views, frame[b0:b1], width, height, pix[b0:b1], jitters,
                                  bounces, shadows)
            total[b0:b1] = col.reshape(K, b1 - b0, 3).mean(dim=0).cpu().numpy()
            work += np.asarray(w, np.int64)
        return filmic(torch.from_numpy(total)).numpy(), Work(*(int(x) for x in work))

    def _linear(self, views, frame, width, height, pix, jitters, bounces, shadows):
        ar, dev, dt = self.ar, self.device, self.ar.dtype
        jit = torch.as_tensor(np.asarray(jitters, np.float32), device=dev).to(dt)
        K, n = jit.shape[0], len(pix)
        f = torch.as_tensor(frame, device=dev).repeat(K)

        def per_ray(name, as_matrix=False):
            x = [getattr(v, name) for v in views]
            x = torch.stack([ar.mat(m, dev) for m in x]) if as_matrix else \
                torch.as_tensor(np.asarray(x, np.float32), device=dev).to(dt)
            return x[f]

        pixel = torch.as_tensor(pix, device=dev).repeat(K)
        jj, ii = (pixel // width).to(dt), (pixel % width).to(dt)
        jx, jy = jit[:, 0].repeat_interleave(n), jit[:, 1].repeat_interleave(n)
        ipw, aspect = per_ray("image_plane_width"), height / width
        u = (ii + 0.5 + jx) / width
        v = 1.0 - (jj + 0.5 + jy) / height
        eye = _normalize(torch.stack([ipw * (u - 0.5), ipw * aspect * (v - 0.5), -torch.ones_like(u)], 1))
        D = _normalize(ar.apply(per_ray("camera_normal", True), eye, 0))
        P = per_ray("camera_origin")
        om, onm, oni = (per_ray(m, True) for m in ("object_matrix", "object_normal", "normal_inverse"))
        light, spec_c, diff_c = per_ray("light_dir"), per_ray("specular"), per_ray("diffuse")
        R = D.shape[0]
        acc = torch.zeros((R, 3), dtype=dt, device=dev)
        mod = torch.ones((R, 3), dtype=dt, device=dev)
        alive = torch.ones(R, dtype=torch.bool, device=dev)
        oL = ar.apply(onm, light, 0)
        work = np.zeros(4, np.int64)
        for _ in range(bounces):
            t, which, w = self.bvh.trace(ar.apply(om, P, 1), ar.apply(onm, D, 0), alive, False, ar.q)
            work += w
            hit = alive & (t < INFINITELY_FAR)
            n_world = ar.apply(oni, self.normals[which.clamp_min(0)], 0)
            n_world = torch.where((_dot(n_world, D) > 0)[:, None], -n_world, n_world)
            newP = P + D * t[:, None] + n_world * SURFACE_FUDGE
            refl = D - 2.0 * _dot(D, n_world)[:, None] * n_world
            h = _dot(D, refl) * 0.5 + 0.5
            spec = spec_c + (1.0 - spec_c) * (h ** 5)[:, None]
            lcos = torch.clamp(_dot(n_world, light), min=0.0)
            if shadows:
                facing = hit & (lcos > 0)
                st, _, w = self.bvh.trace(ar.apply(om, newP, 1), oL, facing, True, ar.q)
                work += w
                lcos = lcos * (st >= INFINITELY_FAR)
            acc = torch.where(hit[:, None], acc + mod * diff_c * lcos[:, None], acc)
            mod = torch.where(hit[:, None], mod * spec, mod)
            P = torch.where(hit[:, None], newP, P)
            D = torch.where(hit[:, None], refl, D)
            alive = hit
        return acc + mod * env_bilinear(self.sky, D), work

"""The fused frame kernel: raygen, 3 bounces of closest-hit walk +
Schlick/Lambert shading + any-hit shadow walk, the env term, bad-ray
paint and the jitter-sample mean, for a whole frame batch.

Replaces the TPU kernel ``mega_kernel``
(shader_ray_tpu/ops/pallas/kernel_mega.py, launched by
packet_mega.packet_shade) with its walker ``make_wide_walker``
(kernel_wide.py), the leaf math ``slot_hit``/``slot_normal``/
``safe_inv`` (kernel_body.py) and the fused env sampler
(envwin.env_window_body, trig.env_coords_kernel), in both its forms:
``which = 0`` (level-0 bilinear env term), and ``with_grads``, where
raygen seeds the ray differentials, each hit transfers them (the fs:92-93
quirk kept) and the env term is ``which = 1`` textureGrad (trilinear,
``env_aniso`` probes) or the ``which = 2`` dY picture.  The kernel has
one instantiation a mode (``FRAME_MODES``) and form: raygen, or given
rays (``GivenRays``: the K sample sets of the frame read from memory
instead of generated, kernel_mega.py:172-173, :233-241; the fused
``which = 5`` frame runs its 25 sub-ray sets so), and each of those in
both leaf test forms of the walk, the form the tables were packed in
(``PackedWide.isect``, ``Config.leaf_isect``: Woop rows, or
Moller-Trumbore on v0 and the two edges; the Moller-Trumbore kernels
count their launches as ``frame_kernel_mt``).  ``FrameSettings.
min_contrib`` > 0 retires a lane after a bounce before the last once its
Schlick modulation is at or below it in every component
(kernel_mega.py:368-381): its shadow ray of that bounce is cast, its env
term uses its current direction, and it casts no further ray.

``frame_kernel`` is the wrapper: CPU tensors run ``frame_plain``, the
same function in plain PyTorch; CUDA tensors launch the hand-written
kernel in ``csrc/frame_kernel.cu`` (built with nvcc at first use into
``shader_ray_tpu_torch/build/``) or raise.  Both return the linear
colour mean over the jitter samples and an int64 counter row:
``[0]`` rays cast (live bounce rays + lcos-gated shadow rays), then per
walk phase p (bounce walks and shadow walks interleaved, as the
reference stats row) ``[1+3p]`` node pops, ``[2+3p]`` leaf visits,
``[3+3p]`` triangle tests.  Given ``tile_rows``, an int64
(n_tiles, 1 + 3 * phases) tensor, both also write the same counts of
each pixel tile (all K samples) into its row, tiles row-major; the rows'
column sums are the frame's row.

A block of 256 threads renders one tile, one thread a pixel.  The tile's
shape and which pixels a warp covers are launch arguments
(``FrameSettings.tile_w`` and ``warp_map``; ``Config.frame_tile`` and
``frame_warp``): tiles ``tile_w`` x 256 / ``tile_w`` pixels, ``tile_w``
one of ``TILE_WIDTHS``; ``"rows"`` puts thread t at (t mod w, t div w)
of the tile, ``"bricks"`` each warp on an 8 x 4 brick of it.  They change
which thread walks which pixel, not what a pixel gets: colour and
counter row are the same bit for bit under every shape; the per-tile
rows follow the tiles.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from shader_ray_tpu_torch.ops import _build
from shader_ray_tpu_torch.ops.env_kernel import MAX_LEVELS, env_sample_plain
from shader_ray_tpu_torch.ops.envmap import TEXEL, dy_picture, sample_env
from shader_ray_tpu_torch.ops.pack_wide import LEAF_STRIDE, WIDE, PackedWide
from shader_ray_tpu_torch.ops.trace_kernel import (
    INFINITELY_FAR,
    MAX_STACK,
    WalkResult,
    isect_code,
    launch_name,
    walk_plain,
)

MAX_PHASES = 16          # walk phases the kernel's counter row holds
BLOCK = 256              # threads a block: a tile of BLOCK pixels
TILE = 16                # the default tile width (Config.frame_tile): 16 x 16 pixels
TILE_WIDTHS = (8, 16, 32, 64)
WARP_MAPS = ("rows", "bricks")  # the kernel's warp_map argument, in its order
FRAME_MODES = ("bilinear", "grad", "probes", "dy")  # the kernel's instantiations

# uniform table layout (kernel_mega.py:43-54; ops/engine_frame.pack_uniforms)
UNI_OBJECT_MATRIX = 0    # [:3,:4] row-major, world->object points
UNI_NORMAL_MATRIX = 12   # [:3,:3] row-major, world->object directions
UNI_NORMAL_INVERSE = 21  # [:3,:3] row-major, object->world normals
UNI_LIGHT_DIR = 30       # (3,) world light direction
UNI_SPECULAR = 33        # (3,) specular color
UNI_DIFFUSE = 36         # (3,) diffuse color
UNI_CAM_ORIGIN = 39      # (3,) world camera position
UNI_CAM_NORMAL = 42      # [:3,:3] row-major camera normal matrix
UNI_IPW = 51             # () image plane width = 2*tan(fov/2)
UNI_SIZE = 52


def stats_phases(bounce_count: int, cast_shadows: bool, enable_diffuse: bool) -> list[str]:
    """The walk phases of the counter row, in order (packet_mega.py:70-81
    of the reference): each bounce's closest-hit walk, then its shadow
    walk where shadows are cast (``cast_shadows and enable_diffuse``)."""
    phases = []
    for b in range(bounce_count):
        phases.append(f"bounce{b}")
        if cast_shadows and enable_diffuse:
            phases.append(f"shadow{b}")
    return phases


class FrameSettings(NamedTuple):
    """The frame kernel's static arguments."""

    width: int
    height: int
    bounce_count: int = 3
    cast_shadows: bool = True
    enable_diffuse: bool = True
    surface_fudge: float = 1.0e-4
    mt_eps: float = 1.0e-7
    max_steps: int = 0          # node pops per walk; 0 = n_wide + 2
    which: int = 0              # env term: 0 level-0 bilinear, 1 textureGrad, 2 dY picture
    env_aniso: int = 1          # which = 1: probes when > 1
    min_contrib: float = 0.0    # lane retirement threshold (Config.min_contrib); 0 = none
    tile_w: int = TILE          # tile width in pixels (TILE_WIDTHS); height BLOCK / tile_w
    warp_map: str = "rows"      # the pixels a warp covers (WARP_MAPS)

    def phases(self) -> int:
        return len(stats_phases(self.bounce_count, self.cast_shadows, self.enable_diffuse))

    def mode(self) -> str:
        """The kernel instantiation of this frame (``FRAME_MODES``)."""
        if self.which not in (0, 1, 2) or self.env_aniso < 1:
            raise ValueError(f"frame_kernel: which={self.which} env_aniso={self.env_aniso}: "
                             "need which 0, 1 or 2 and env_aniso >= 1")
        if self.which == 1:
            return "probes" if self.env_aniso > 1 else "grad"
        return "dy" if self.which == 2 else "bilinear"

    def tile(self) -> tuple[int, int]:
        """(width, height) of a tile; raises on a shape the kernel has not."""
        if self.tile_w not in TILE_WIDTHS or self.warp_map not in WARP_MAPS:
            raise ValueError(f"frame_kernel: tile_w={self.tile_w} warp_map={self.warp_map!r}: "
                             f"need a width in {TILE_WIDTHS} and a map in {WARP_MAPS}")
        return self.tile_w, BLOCK // self.tile_w

    def n_tiles(self) -> int:
        tw, th = self.tile()
        return -(-self.width // tw) * -(-self.height // th)


class GivenRays(NamedTuple):
    """The K sample sets of a frame handed to the kernel instead of its
    raygen (pixel p = row * width + column)."""

    P: torch.Tensor                    # (W*H, 3) origins, shared by the K sets
    D: torch.Tensor                    # (K, W*H, 3) directions
    dDdx: torch.Tensor | None = None   # (K, W*H, 3), read in the grad modes only
    dDdy: torch.Tensor | None = None


def frame_plain(
    packed: PackedWide,
    uni: torch.Tensor,
    jitters: torch.Tensor | None,
    fs: FrameSettings,
    probe: dict | None = None,
    tile_rows: torch.Tensor | None = None,
    rays: GivenRays | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The frame kernel's function in plain PyTorch, vectorized over all
    K * H * W sample rays (ray r = k * H * W + pixel), its walks
    ``walk_plain`` with the tables' leaf test (``packed.isect``): returns the
    (H, W, 3) linear colour mean over the K jitters (or the K given ray
    sets, ``jitters`` None) and the counter row, and fills ``tile_rows``
    if given (module docstring).
    Arithmetic follows the kernel op by op (kernel_mega.py:174-453).  A
    ``probe`` dict receives what an operation and byte count of the
    frame needs: ``"walks"``, each walk phase's ``WalkResult`` in order,
    and ``"env_D"``, the (K * H * W, 3) directions of the env lookup,
    with ``"env_dDdx"`` and ``"env_dDdy"``, their differentials, in the
    grad modes."""
    fs.mode()  # a mode the kernel has
    tw, th = fs.tile()  # and a tile shape
    W, H = fs.width, fs.height
    K = _samples(jitters, rays, fs)
    HW = W * H
    dev = uni.device
    u = [uni[i] for i in range(UNI_SIZE)]
    m = u[UNI_OBJECT_MATRIX : UNI_OBJECT_MATRIX + 12]
    nm = u[UNI_NORMAL_MATRIX : UNI_NORMAL_MATRIX + 9]
    ni = u[UNI_NORMAL_INVERSE : UNI_NORMAL_INVERSE + 9]
    Lx, Ly, Lz = u[UNI_LIGHT_DIR : UNI_LIGHT_DIR + 3]
    csp = u[UNI_SPECULAR : UNI_SPECULAR + 3]
    cdf = u[UNI_DIFFUSE : UNI_DIFFUSE + 3]
    counters = torch.zeros(1 + 3 * fs.phases(), dtype=torch.long, device=dev)

    pix = torch.arange(HW, device=dev).repeat(K)
    grads = fs.which in (1, 2)
    R = K * HW
    if rays is None:
        rays = raygen_rays(uni, jitters, fs)
    # the rays of sample k of pixel p (kernel_mega.py:233-241)
    Px, Py, Pz = rays.P[pix].unbind(1)
    Dx, Dy, Dz = rays.D.reshape(R, 3).unbind(1)
    if grads:
        gx = list(rays.dDdx.reshape(R, 3).unbind(1))
        gy = list(rays.dDdy.reshape(R, 3).unbind(1))
    # the tile of each ray's pixel, for the per-tile rows
    tiles_x = -(-W // tw)
    tile = (pix // W) // th * tiles_x + (pix % W) // tw
    if tile_rows is not None:
        _build.check("frame_plain", "tile_rows", tile_rows, torch.long,
                     (fs.n_tiles(), 1 + 3 * fs.phases()))
        tile_rows.zero_()

    def count(col: int, per_ray: torch.Tensor) -> None:
        counters[col] += per_ray.sum()
        if tile_rows is not None:
            tile_rows[:, col].index_add_(0, tile, per_ray.long())

    oLx = nm[0] * Lx + nm[1] * Ly + nm[2] * Lz
    oLy = nm[3] * Lx + nm[4] * Ly + nm[5] * Lz
    oLz = nm[6] * Lx + nm[7] * Ly + nm[8] * Lz
    oL = torch.stack([oLx, oLy, oLz]).expand(R, 3)

    acc = [torch.zeros(R, device=dev) for _ in range(3)]
    mod = [torch.ones(R, device=dev) for _ in range(3)]
    act = torch.ones(R, dtype=torch.bool, device=dev)
    badv = torch.zeros(R, dtype=torch.bool, device=dev)
    shadows = fs.cast_shadows and fs.enable_diffuse
    phase = 0

    def record(w: WalkResult) -> None:
        nonlocal phase
        count(1 + 3 * phase, w.steps)
        count(2 + 3 * phase, w.leafs)
        count(3 + 3 * phase, w.tris)
        phase += 1
        if probe is not None:
            probe.setdefault("walks", []).append(w)

    for b in range(fs.bounce_count):
        count(0, act)
        oP = torch.stack([
            m[0] * Px + m[1] * Py + m[2] * Pz + m[3],
            m[4] * Px + m[5] * Py + m[6] * Pz + m[7],
            m[8] * Px + m[9] * Py + m[10] * Pz + m[11],
        ], dim=1)
        oD = torch.stack([
            nm[0] * Dx + nm[1] * Dy + nm[2] * Dz,
            nm[3] * Dx + nm[4] * Dy + nm[5] * Dz,
            nm[6] * Dx + nm[7] * Dy + nm[8] * Dz,
        ], dim=1)
        w = walk_plain(packed, oP, oD, act, False, fs.mt_eps, fs.max_steps)
        record(w)
        t = w.t
        hit_ok = act & ~w.bad & (t < INFINITELY_FAR)
        badv |= act & w.bad

        # object -> world normal, flipped against the incoming ray
        nx, ny, nz = w.normal[:, 0], w.normal[:, 1], w.normal[:, 2]
        wnx = ni[0] * nx + ni[1] * ny + ni[2] * nz
        wny = ni[3] * nx + ni[4] * ny + ni[5] * nz
        wnz = ni[6] * nx + ni[7] * ny + ni[8] * nz
        flip = torch.where(wnx * Dx + wny * Dy + wnz * Dz > 0.0, -1.0, 1.0)
        wnx, wny, wnz = wnx * flip, wny * flip, wnz * flip

        # transfer + fudged reflect (fs:65-96)
        rPx = Px + t * Dx + wnx * fs.surface_fudge
        rPy = Py + t * Dy + wny * fs.surface_fudge
        rPz = Pz + t * Dz + wnz * fs.surface_fudge
        ddn = Dx * wnx + Dy * wny + Dz * wnz
        rDx = Dx - 2.0 * ddn * wnx
        rDy = Dy - 2.0 * ddn * wny
        rDz = Dz - 2.0 * ddn * wnz

        # Schlick in (view . reflected) half-angle form (fs:479-482)
        h = (Dx * rDx + Dy * rDy + Dz * rDz) * 0.5 + 0.5
        h2 = h * h
        fres = h2 * h2 * h
        spec = [c + (1.0 - c) * fres for c in csp]

        if fs.enable_diffuse:
            lcos = torch.clamp(wnx * Lx + wny * Ly + wnz * Lz, min=0.0)
            if fs.cast_shadows:
                # light-facing hits only (fs:454-464 cast unconditionally;
                # lcos == 0 adds no diffuse either way)
                sact = hit_ok & (lcos > 0.0)
                count(0, sact)
                sP = torch.stack([
                    m[0] * rPx + m[1] * rPy + m[2] * rPz + m[3],
                    m[4] * rPx + m[5] * rPy + m[6] * rPz + m[7],
                    m[8] * rPx + m[9] * rPy + m[10] * rPz + m[11],
                ], dim=1)
                sw = walk_plain(packed, sP, oL, sact, True, fs.mt_eps, fs.max_steps)
                record(sw)
                badv |= sact & sw.bad
                irr = lcos * (sw.t >= INFINITELY_FAR).float()
            else:
                irr = lcos
            acc = [torch.where(hit_ok, a + mo * c * irr, a) for a, mo, c in zip(acc, mod, cdf)]

        mod = [torch.where(hit_ok, mo * s, mo) for mo, s in zip(mod, spec)]
        Px = torch.where(hit_ok, rPx, Px)
        Py = torch.where(hit_ok, rPy, Py)
        Pz = torch.where(hit_ok, rPz, Pz)
        Dx = torch.where(hit_ok, rDx, Dx)
        Dy = torch.where(hit_ok, rDy, Dy)
        Dz = torch.where(hit_ok, rDz, Dz)
        if grads:
            # the fs:92-93 quirk kept verbatim: the SCALAR 2 dot(dD, n)
            # off each component (kernel_mega.py:356-366)
            gdx = gx[0] * wnx + gx[1] * wny + gx[2] * wnz
            gdy = gy[0] * wnx + gy[1] * wny + gy[2] * wnz
            gx = [torch.where(hit_ok, c - 2.0 * gdx, c) for c in gx]
            gy = [torch.where(hit_ok, c - 2.0 * gdy, c) for c in gy]
        act = hit_ok
        if fs.min_contrib > 0.0 and b + 1 < fs.bounce_count:
            # throughput cutoff (kernel_mega.py:368-381): a retired lane's
            # env term uses its current direction and modulation
            mc = fs.min_contrib
            act = act & ((mod[0] > mc) | (mod[1] > mc) | (mod[2] > mc))

    env_D = torch.stack([Dx, Dy, Dz], dim=1)
    if probe is not None:
        probe["env_D"] = env_D
    if grads:
        env_gx, env_gy = torch.stack(gx, dim=1), torch.stack(gy, dim=1)
        if probe is not None:
            probe["env_dDdx"], probe["env_dDdy"] = env_gx, env_gy
        if fs.which == 1:
            env = env_sample_plain(packed.env_pyramid, env_D, env_gx, env_gy, grad=True,
                                   aniso=fs.env_aniso)
        else:
            env = dy_picture(env_D, env_gx, env_gy)
    else:
        env = sample_env(packed.env, env_D)
    col = torch.stack([a + mo * env[:, c] for c, (a, mo) in enumerate(zip(acc, mod))], dim=1)
    red = torch.tensor([1.0, 0.0, 0.0], device=dev)
    col = torch.where(badv[:, None], red, col).reshape(K, HW, 3)
    total = col[0]
    for k in range(1, K):
        total = total + col[k]
    return (total / K).reshape(H, W, 3), counters


def raygen_rays(uni: torch.Tensor, jitters: torch.Tensor, fs: FrameSettings,
                rows: tuple[int, int] | None = None) -> GivenRays:
    """The rays the kernel generates for the (K, 2) ``jitters``, in plain
    PyTorch: pinhole raygen (kernel_mega.py:203-220, two normalisations)
    and, in the grad modes, the seeded differentials (:221-232).  With
    ``rows`` = (r0, r1), only the pixels of image rows r0 to r1 - 1 of
    the W x H frame, each ray bit for bit the whole frame's (elementwise
    arithmetic)."""
    W, H = fs.width, fs.height
    r0, r1 = rows or (0, H)
    K, HW = jitters.shape[0], W * (r1 - r0)
    u = [uni[i] for i in range(UNI_SIZE)]
    cm = u[UNI_CAM_NORMAL : UNI_CAM_NORMAL + 9]
    ipw = u[UNI_IPW]
    pix = torch.arange(HW, device=uni.device).repeat(K)
    iif = (pix % W).float()
    jf = (pix // W + r0).float()
    jx = jitters[:, 0].repeat_interleave(HW)
    jy = jitters[:, 1].repeat_interleave(HW)
    inv_w, inv_h, aspect = _raygen_scalars(W, H)
    uu = (iif + 0.5 + jx) * inv_w
    vv = 1.0 - (jf + 0.5 + jy) * inv_h
    ex = ipw * (uu - 0.5)
    ey = (ipw * aspect) * (vv - 0.5)
    inv_e = 1.0 / torch.sqrt(ex * ex + ey * ey + 1.0)
    dex, dey, dez = ex * inv_e, ey * inv_e, -inv_e
    Dx = cm[0] * dex + cm[1] * dey + cm[2] * dez
    Dy = cm[3] * dex + cm[4] * dey + cm[5] * dez
    Dz = cm[6] * dex + cm[7] * dey + cm[8] * dez
    inv_d = 1.0 / torch.sqrt(Dx * Dx + Dy * Dy + Dz * Dz)
    Dx, Dy, Dz = Dx * inv_d, Dy * inv_d, Dz * inv_d
    P = uni[UNI_CAM_ORIGIN : UNI_CAM_ORIGIN + 3].expand(HW, 3).contiguous()
    sets = lambda *c: torch.stack(c, dim=1).reshape(K, HW, 3)
    if fs.which not in (1, 2):
        return GivenRays(P, sets(Dx, Dy, Dz))
    # seeded differentials: the camera matrix's columns at the image
    # plane's pixel spacing
    sx = ipw * inv_w
    sy = (ipw * aspect) * inv_h
    rx, ry, rz = cm[0] * sx, cm[3] * sx, cm[6] * sx
    ux, uy, uz = cm[1] * sy, cm[4] * sy, cm[7] * sy
    dr = Dx * rx + Dy * ry + Dz * rz
    du = Dx * ux + Dy * uy + Dz * uz
    return GivenRays(P, sets(Dx, Dy, Dz), sets(rx - dr * Dx, ry - dr * Dy, rz - dr * Dz),
                     sets(ux - du * Dx, uy - du * Dy, uz - du * Dz))


def _samples(jitters: torch.Tensor | None, rays: GivenRays | None, fs: FrameSettings) -> int:
    """K, the sample sets of the frame: the jitters' rows for raygen, the
    given rays' sets otherwise (exactly one of the two); raises on given
    rays of the wrong shape."""
    if (jitters is None) == (rays is None):
        raise ValueError("frame_kernel: pass either jitters (raygen) or given rays, not both")
    if rays is None:
        return jitters.shape[0]
    K = rays.D.shape[0]
    n = fs.width * fs.height
    check = functools.partial(_build.check, "frame_kernel")
    check("rays.P", rays.P, torch.float32, (n, 3))
    check("rays.D", rays.D, torch.float32, (None, n, 3))
    if fs.which in (1, 2):
        if rays.dDdx is None or rays.dDdy is None:
            raise ValueError(f"frame_kernel: which={fs.which} reads the given rays' dDdx and dDdy")
        check("rays.dDdx", rays.dDdx, torch.float32, (K, n, 3))
        check("rays.dDdy", rays.dDdy, torch.float32, (K, n, 3))
    return K


def _raygen_scalars(W: int, H: int) -> tuple[float, float, float]:
    """1/W, 1/H and H/W rounded to f32 once, shared by both versions."""
    return (float(np.float32(1.0 / W)), float(np.float32(1.0 / H)),
            float(np.float32(H / W)))


@functools.cache
def _entry():
    """The library's entry point with its C signature set."""
    fn = _build.library("frame_kernel")[0].srt_frame_kernel
    P = ctypes.c_void_p
    I = ctypes.c_int
    F = ctypes.c_float
    fn.argtypes = [
        P, P, P, I,                # nodes, leaves, normals, leaf test form
        P, P, I, I, I,             # env texels, level table, levels, which, aniso
        P, P,                      # uni, jitters
        P, P, P, P,                # given rays: P, D, dDdx, dDdy
        I, I, I,                   # K, W, H
        F, F, F,                   # 1/W, 1/H, H/W
        I, I, I, F, F, F, I, I,    # bounces, shadows, diffuse, fudge, eps, min_contrib, max_steps, stack
        I, I,                      # tile width, warp map
        P, P, P, P,                # out, counters, tile rows, stream
    ]
    fn.restype = I
    return fn


def launch_info(stack_depth: int, mode: str = "bilinear", given: bool = False,
                isect: str = "woop", tile_w: int = TILE, warp_map: str = "rows") -> dict[str, int]:
    """The launch of the frame kernel of ``mode`` (one of ``FRAME_MODES``)
    in its raygen or given-rays form with leaf test ``isect`` on the
    current card for a scene's stack bound, in tiles ``tile_w`` pixels
    wide under ``warp_map``: registers a thread, static and dynamic
    (stack, and the differentials in the grad modes) shared bytes a
    block, local bytes a thread, resident blocks an SM, threads a block
    and the tile's ``tile_w`` and ``tile_h``."""
    return _build.launch_info("frame_kernel", "srt_frame_kernel_info", stack_depth,
                              FRAME_MODES.index(mode), int(given),
                              isect_code("launch_info", isect), tile_w, _warp_code(warp_map),
                              keys=(*_build.INFO_KEYS, "tile_w", "tile_h"))


def _warp_code(warp_map: str) -> int:
    """The kernel's code of a warp map; an unknown map gets -1, which the
    kernel refuses."""
    return WARP_MAPS.index(warp_map) if warp_map in WARP_MAPS else -1


def frame_kernel(
    packed: PackedWide,
    uni: torch.Tensor,
    jitters: torch.Tensor | None,
    fs: FrameSettings,
    tile_rows: torch.Tensor | None = None,
    rays: GivenRays | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Render K samples of a W x H frame, from the (K, 2) ``jitters`` or
    from the K sets of given ``rays`` (``jitters`` None): (H, W, 3) f32
    linear colour mean and the int64 counter row; fills ``tile_rows`` if
    given (module docstring).  The walks test leaves in the tables' form
    (``packed.isect``).  CPU tensors run ``frame_plain``; CUDA tensors
    launch the CUDA kernel."""
    env = packed.env_pyramid
    isect = isect_code("frame_kernel", packed.isect)
    tensors = dict(
        nodes=packed.nodes, leaves=packed.leaves, normals=packed.normals, env=env.texels,
        uni=uni, jitters=jitters, tile_rows=tile_rows,
        **({} if rays is None else {f"rays.{k}": v for k, v in rays._asdict().items()}),
    )
    device = _build.one_device("frame_kernel", {k: v for k, v in tensors.items() if v is not None})
    if device.type == "cpu":
        return frame_plain(packed, uni, jitters, fs, tile_rows=tile_rows, rays=rays)
    fs.mode()  # a mode the kernel has
    K = _samples(jitters, rays, fs)
    Nw = packed.n_wide
    check = functools.partial(_build.check, "frame_kernel")
    check("nodes", packed.nodes, torch.float32, (Nw, WIDE, 8))
    check("leaves", packed.leaves, torch.float32, (None, LEAF_STRIDE))
    check("normals", packed.normals, torch.float32, (packed.leaves.shape[0], LEAF_STRIDE))
    check("env", env.texels, torch.float32, (None, TEXEL))
    check("uni", uni, torch.float32, (UNI_SIZE,))
    if jitters is not None:
        check("jitters", jitters, torch.float32, (None, 2))
    if tile_rows is not None:
        check("tile_rows", tile_rows, torch.long, (fs.n_tiles(), 1 + 3 * fs.phases()))
    if K < 1 or fs.width < 1 or fs.height < 1:
        raise ValueError("frame_kernel: need K >= 1 and a non-empty frame")
    if not fs.min_contrib >= 0.0:
        raise ValueError(f"frame_kernel: min_contrib={fs.min_contrib}: need >= 0")
    if not 1 <= packed.stack_depth <= MAX_STACK:
        raise ValueError(f"frame_kernel: stack depth {packed.stack_depth} > {MAX_STACK}")
    if fs.phases() > MAX_PHASES:
        raise ValueError(f"frame_kernel: {fs.phases()} walk phases > {MAX_PHASES}")
    if not 1 <= env.n_levels <= MAX_LEVELS:
        raise ValueError(f"frame_kernel: {env.n_levels} env levels, the kernel takes 1 to {MAX_LEVELS}")

    fn = _entry()
    out = torch.empty((fs.height, fs.width, 3), dtype=torch.float32, device=device)
    counters = torch.zeros(1 + 3 * fs.phases(), dtype=torch.long, device=device)
    levels = (ctypes.c_int * (3 * env.n_levels))(*(x for row in env.levels for x in row))
    inv_w, inv_h, aspect = _raygen_scalars(fs.width, fs.height)
    ptr = lambda x: None if x is None else x.data_ptr()
    given = rays or GivenRays(None, None)
    name = launch_name("frame_kernel", packed.isect)
    with torch.cuda.device(device), _build.traced(name):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(
            packed.nodes.data_ptr(), packed.leaves.data_ptr(), packed.normals.data_ptr(), isect,
            env.texels.data_ptr(), levels, env.n_levels, fs.which, fs.env_aniso,
            uni.data_ptr(), ptr(jitters), *(ptr(x) for x in given), K, fs.width, fs.height,
            inv_w, inv_h, aspect,
            fs.bounce_count, int(fs.cast_shadows), int(fs.enable_diffuse),
            fs.surface_fudge, fs.mt_eps, fs.min_contrib, fs.max_steps or Nw + 2,
            packed.stack_depth, fs.tile_w, _warp_code(fs.warp_map),
            out.data_ptr(), counters.data_ptr(),
            None if tile_rows is None else tile_rows.data_ptr(), stream,
        )
    _build.launched(name, err)
    return out, counters

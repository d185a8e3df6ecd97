"""trisrc format parser + writer (the Python parsers of
shader_ray_tpu/models/trisrc.py; reference trisrc-support.cpp:43-104).

Repeating records of

    "texture-name" tag  sr sg sb sa shininess
    x y z  nx ny nz  r g b a  u v      (x3 vertices)

Behavior preserved from the reference:
* texture name ``"*"`` means none (:50-53); materials/texcoords are
  parsed but discarded — only position/normal/color are kept (:88);
* shininess in (0, 1) is scaled by 10 (:66-69);
* vertex colors are gamma-decoded by pow(c, screen_gamma) unless
  ``Config.colors_are_linear`` (COLORS_ARE_LINEAR) is set (:24, :93-97);
* positions are scaled by ``Config.geometry_scale`` (:36-39, :92);
* normals are renormalized (:99).

``write_trisrc`` writes fixtures (the reference has no writer).
"""

from __future__ import annotations

import re

import numpy as np

from shader_ray_tpu_torch import native
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.triangle_set import TriangleSet

_QUOTED = re.compile(r'"([^"]*)"')


def parse_trisrc(path: str, config: Config | None = None) -> TriangleSet:
    """Parse a trisrc file: through the native reader where
    ``Config.use_native`` lets it (native.py), else in Python."""
    cfg = config or Config()
    if native.wanted(cfg.use_native):
        pos, nrm, col = native.parse_trisrc_file(path, cfg.geometry_scale, cfg.screen_gamma,
                                                 cfg.colors_are_linear)
        return TriangleSet.from_arrays(pos, nrm, col)
    with open(path, "r") as f:
        text = f.read()
    return parse_trisrc_text(text, cfg)


def parse_trisrc_text(text: str, config: Config | None = None) -> TriangleSet:
    cfg = config or Config()

    # quoted strings are single tokens, the rest is whitespace-split (the
    # reference's fscanf grammar)
    tokens: list[str] = []
    pos = 0
    n = len(text)
    while pos < n:
        ch = text[pos]
        if ch.isspace():
            pos += 1
            continue
        if ch == '"':
            m = _QUOTED.match(text, pos)
            if m is None:
                raise ValueError("unterminated quoted texture name in trisrc")
            tokens.append('"' + m.group(1) + '"')
            pos = m.end()
        else:
            end = pos
            while end < n and not text[end].isspace():
                end += 1
            tokens.append(text[pos:end])
            pos = end

    tri_pos = []
    tri_norm = []
    tri_color = []
    i = 0
    ntok = len(tokens)
    # a record: quoted texture, tag, 5 specular floats, 3 x 12 floats = 43 tokens
    while i < ntok:
        tex = tokens[i]
        if not (tex.startswith('"') and tex.endswith('"')):
            raise ValueError(f"expected quoted texture name, got {tex!r}")
        i += 1
        if i >= ntok:
            raise ValueError("couldn't read tag name")
        i += 1  # the tag
        if i + 5 > ntok:
            raise ValueError("couldn't read specular properties")
        _specular = [float(x) for x in tokens[i : i + 5]]  # parsed, then discarded (:88)
        i += 5
        if i + 36 > ntok:
            raise ValueError("couldn't read Vertex")
        vals = np.array([float(x) for x in tokens[i : i + 36]], dtype=np.float64).reshape(3, 12)
        i += 36

        v = vals[:, 0:3] * cfg.geometry_scale
        nrm = vals[:, 3:6]
        c = vals[:, 6:9]
        if not cfg.colors_are_linear:
            c = np.power(np.abs(c), cfg.screen_gamma) * np.sign(c)
        length = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.where(length == 0, 1.0, length)
        tri_pos.append(v.astype(np.float32))
        tri_norm.append(nrm.astype(np.float32))
        tri_color.append(c.astype(np.float32))

    if not tri_pos:
        return TriangleSet().finish()
    return TriangleSet.from_arrays(np.stack(tri_pos), np.stack(tri_norm), np.stack(tri_color))


def write_trisrc(
    path: str,
    tri_pos: np.ndarray,
    tri_norm: np.ndarray | None = None,
    tri_color: np.ndarray | None = None,
    specular=(1.0, 1.0, 1.0, 1.0),
    shininess: float = 10.0,
    config: Config | None = None,
) -> None:
    """Write (T, 3, 3) triangle arrays as a trisrc file.  Colors are
    written gamma-encoded (pow(c, 1/screen_gamma)), so the gamma-decoding
    parser reads back the linear colors."""
    cfg = config or Config()
    tri_pos = np.asarray(tri_pos, dtype=np.float64)
    T = tri_pos.shape[0]
    if tri_norm is None:
        e1 = tri_pos[:, 1] - tri_pos[:, 0]
        e2 = tri_pos[:, 2] - tri_pos[:, 0]
        fn = np.cross(e1, e2)
        fn /= np.maximum(np.linalg.norm(fn, axis=-1, keepdims=True), 1e-30)
        tri_norm = np.repeat(fn[:, None, :], 3, axis=1)
    if tri_color is None:
        tri_color = np.ones_like(tri_pos)
    enc = np.power(np.clip(tri_color, 0.0, None), 1.0 / cfg.screen_gamma)
    with open(path, "w") as f:
        for t in range(T):
            f.write('"*" default %g %g %g %g %g\n' % (*specular, shininess))
            for j in range(3):
                x, y, z = tri_pos[t, j]
                nx, ny, nz = tri_norm[t, j]
                r, g, b = enc[t, j]
                f.write(
                    f"{x:.9g} {y:.9g} {z:.9g} {nx:.9g} {ny:.9g} {nz:.9g} "
                    f"{r:.9g} {g:.9g} {b:.9g} 1 0 0\n"
                )

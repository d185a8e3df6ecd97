"""Wavefront OBJ loader (the Python parser of
shader_ray_tpu/models/obj.py; reference obj-support.cpp:226-350):
* handles only ``o v vn vt f`` records, skipping blanks/comments
  (:248-252, 270-297);
* 1-based indices converted to 0-based (:186-189), negative ones
  relative to the elements so far;
* n-gon faces are fan-triangulated (:324-347);
* if the file carries no normals, area-weighted vertex normals are
  computed from face normals (compute_normals, :104-146), indexed by
  position index;
* vertex colors are forced to white (:344); texcoords parsed but unused.
"""

from __future__ import annotations

import numpy as np

from shader_ray_tpu_torch import native
from shader_ray_tpu_torch.config import Config
from shader_ray_tpu_torch.models.triangle_set import TriangleSet


def parse_obj(path: str, config: Config | None = None) -> TriangleSet:
    """Parse an OBJ file: through the native reader where
    ``Config.use_native`` lets it (native.py; colors white, :344), else
    in Python."""
    if native.wanted((config or Config()).use_native):
        pos, nrm = native.parse_obj_file(path)
        return TriangleSet.from_arrays(pos, nrm, np.ones_like(pos))
    with open(path, "r") as f:
        return parse_obj_text(f.read())


def parse_obj_text(text: str) -> TriangleSet:
    positions: list[list[float]] = []
    normals: list[list[float]] = []
    texcoords: list[list[float]] = []
    # each face: list of (v, vt, vn) index triples; -1 = absent
    faces: list[list[tuple[int, int, int]]] = []
    faces_have_normals: list[bool] = []

    for raw in text.splitlines():
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        kind = parts[0]
        data = parts[1:]
        if kind == "v":
            positions.append([float(x) for x in data[:3]] + [0.0] * (3 - min(3, len(data))))
        elif kind == "vn":
            normals.append([float(x) for x in data[:3]] + [0.0] * (3 - min(3, len(data))))
        elif kind == "vt":
            texcoords.append([float(x) for x in data[:2]] + [0.0] * (2 - min(2, len(data))))
        elif kind == "f":
            idxs = []
            has_n = False

            def resolve(raw: int, count: int) -> int:
                # negative indices are relative to the elements defined
                # so far (OBJ spec); positive are 1-based
                return count + raw if raw < 0 else raw - 1

            for tup in data:
                elems = tup.split("/")
                v = resolve(int(elems[0]), len(positions))
                vt = (
                    resolve(int(elems[1]), len(texcoords))
                    if len(elems) > 1 and elems[1] else -1
                )
                vn = (
                    resolve(int(elems[2]), len(normals))
                    if len(elems) > 2 and elems[2] else -1
                )
                if vn >= 0:
                    has_n = True
                idxs.append((v, vt, vn))
            faces.append(idxs)
            faces_have_normals.append(has_n)
        # 'o' and anything else: ignored (reference prints object names)

    pos = np.asarray(positions, dtype=np.float32).reshape(-1, 3)

    computed_normals = None
    if not normals:
        # Area-weighted vertex normals over fan-triangulated faces,
        # accumulated per POSITION index (reference obj-support.cpp:104-146).
        acc = np.zeros_like(pos)
        for face in faces:
            vi0 = face[0][0]
            for t in range(len(face) - 2):
                vi1 = face[t + 1][0]
                vi2 = face[t + 2][0]
                fn = np.cross(pos[vi1] - pos[vi0], pos[vi2] - pos[vi0])
                acc[vi0] += fn
                acc[vi1] += fn
                acc[vi2] += fn
        length = np.linalg.norm(acc, axis=1, keepdims=True)
        computed_normals = acc / np.where(length == 0, 1.0, length)

    nrm_arr = (
        np.asarray(normals, dtype=np.float32).reshape(-1, 3)
        if normals
        else computed_normals
    )

    tri_pos = []
    tri_norm = []
    for fi, face in enumerate(faces):
        i0 = face[0]
        for t in range(len(face) - 2):
            i1 = face[t + 1]
            i2 = face[t + 2]
            tri_pos.append([pos[i0[0]], pos[i1[0]], pos[i2[0]]])
            if normals and faces_have_normals[fi]:
                tri_norm.append([nrm_arr[i0[2]], nrm_arr[i1[2]], nrm_arr[i2[2]]])
            elif not normals:
                # computed normals are indexed by position index
                tri_norm.append([nrm_arr[i0[0]], nrm_arr[i1[0]], nrm_arr[i2[0]]])
            else:
                # file has normals but this face lacks them: zero normal
                # (reference leaves vertex.n default-constructed)
                z = np.zeros(3, np.float32)
                tri_norm.append([z, z, z])

    if not tri_pos:
        return TriangleSet().finish()
    tp = np.asarray(tri_pos, dtype=np.float32)
    tn = np.asarray(tri_norm, dtype=np.float32)
    tc = np.ones_like(tp)  # colors forced white, reference obj-support.cpp:344
    return TriangleSet.from_arrays(tp, tn, tc)

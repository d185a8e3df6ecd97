"""Deduplicating triangle mesh store (host side, numpy).

A vertex pool deduplicated on exact (position, normal, color) equality,
an indexed triangle list with per-triangle AABB + barycenter, and a
whole-set AABB (reference triangle-set.h:46-102).  Per-point AABB
insertion bumps by 1e-5 in every axis (reference vectormath.h:189-195).

Built incrementally, as the reference builds it (``TriangleSet()``,
``add`` or ``add_batch``, then ``finish``), or at once from (T, 3, 3)
arrays (``from_arrays``); both number the vertices in first-occurrence
order.
"""

from __future__ import annotations

import numpy as np

BUMPOUT = 1e-5  # reference vectormath.h:191


class TriangleSet:
    def __init__(
        self,
        positions: np.ndarray | None = None,
        normals: np.ndarray | None = None,
        colors: np.ndarray | None = None,
        indices: np.ndarray | None = None,
    ) -> None:
        """The finished set of these arrays, or with none an empty builder
        for ``add`` / ``add_batch`` and ``finish``."""
        # the builder's vertex pool and triangles, until finish
        self._positions: list[np.ndarray] = []
        self._normals: list[np.ndarray] = []
        self._colors: list[np.ndarray] = []
        self._vertex_map: dict[bytes, int] = {}
        self._tri_indices: list[tuple[int, int, int]] = []
        self.positions = self.normals = self.colors = self.indices = None
        self.tri_boxmin = self.tri_boxmax = self.barycenters = None
        self.boxmin = self.boxmax = None
        if indices is not None:
            self._freeze(positions, normals, colors, indices)

    def _freeze(self, positions, normals, colors, indices) -> None:
        self.positions = positions   # (V, 3) f32
        self.normals = normals       # (V, 3) f32
        self.colors = colors         # (V, 3) f32
        self.indices = indices       # (T, 3) i32
        T = indices.shape[0]
        tri_pos = positions[indices]                      # (T, 3, 3)
        self.tri_boxmin = (tri_pos - BUMPOUT).min(axis=1).astype(np.float32)
        self.tri_boxmax = (tri_pos + BUMPOUT).max(axis=1).astype(np.float32)
        self.barycenters = tri_pos.mean(axis=1).astype(np.float32)
        if T > 0:
            self.boxmin = self.tri_boxmin.min(axis=0)
            self.boxmax = self.tri_boxmax.max(axis=0)
        else:
            self.boxmin = np.full(3, np.finfo(np.float32).max, np.float32)
            self.boxmax = np.full(3, -np.finfo(np.float32).max, np.float32)

    # --- building (reference triangle-set.h:76-102) ---

    def _find_vertex(self, v: np.ndarray, n: np.ndarray, c: np.ndarray) -> int:
        """The index of vertex (v, n, c), added if new: exact equality on
        the float32 bytes, the reference map's grouping."""
        key = v.tobytes() + n.tobytes() + c.tobytes()
        idx = self._vertex_map.get(key)
        if idx is None:
            idx = len(self._positions)
            self._vertex_map[key] = idx
            self._positions.append(v)
            self._normals.append(n)
            self._colors.append(c)
        return idx

    def add(self, verts: np.ndarray, normals: np.ndarray, colors: np.ndarray) -> int:
        """Add one triangle, (3, 3) positions, normals and colors; returns
        its index."""
        verts = np.asarray(verts, dtype=np.float32)
        normals = np.asarray(normals, dtype=np.float32)
        colors = np.asarray(colors, dtype=np.float32)
        i0 = self._find_vertex(verts[0], normals[0], colors[0])
        i1 = self._find_vertex(verts[1], normals[1], colors[1])
        i2 = self._find_vertex(verts[2], normals[2], colors[2])
        self._tri_indices.append((i0, i1, i2))
        return len(self._tri_indices) - 1

    def add_batch(self, verts: np.ndarray, normals: np.ndarray, colors: np.ndarray) -> None:
        """``add`` each triangle of (T, 3, 3) arrays in order."""
        verts = np.ascontiguousarray(verts, dtype=np.float32)
        normals = np.ascontiguousarray(normals, dtype=np.float32)
        colors = np.ascontiguousarray(colors, dtype=np.float32)
        for t in range(verts.shape[0]):
            self.add(verts[t], normals[t], colors[t])

    def finish(self) -> "TriangleSet":
        """Freeze the added triangles into the arrays, boxes and
        barycenters; drops the dedup map, as the reference's finish."""
        self._vertex_map.clear()
        V, T = len(self._positions), len(self._tri_indices)
        self._freeze(
            np.asarray(self._positions, dtype=np.float32).reshape(V, 3),
            np.asarray(self._normals, dtype=np.float32).reshape(V, 3),
            np.asarray(self._colors, dtype=np.float32).reshape(V, 3),
            np.asarray(self._tri_indices, dtype=np.int32).reshape(T, 3),
        )
        return self

    # --- queries ---

    @property
    def triangle_count(self) -> int:
        return len(self._tri_indices) if self.indices is None else int(self.indices.shape[0])

    @property
    def vertex_count(self) -> int:
        return len(self._positions) if self.positions is None else int(self.positions.shape[0])

    def box_center(self) -> np.ndarray:
        """(boxmin + boxmax) / 2 (reference vectormath.h:181-184)."""
        return ((self.boxmin + self.boxmax) * 0.5).astype(np.float32)

    def get(self, i: int) -> np.ndarray:
        """Triangle i's (3, 3) positions, of a finished set."""
        return self.positions[self.indices[i]]

    @staticmethod
    def from_arrays(
        tri_pos: np.ndarray,
        tri_norm: np.ndarray | None = None,
        tri_color: np.ndarray | None = None,
    ) -> "TriangleSet":
        """Build from (T, 3, 3) arrays.  Vertices are deduplicated with
        np.unique over packed (position, normal, color) records and
        numbered in first-occurrence order, the reference map's
        incremental insertion order.  Missing normals become flat face
        normals; missing colors are white."""
        tri_pos = np.ascontiguousarray(tri_pos, dtype=np.float32)
        T = tri_pos.shape[0]
        if tri_norm is None:
            e1 = tri_pos[:, 1] - tri_pos[:, 0]
            e2 = tri_pos[:, 2] - tri_pos[:, 0]
            fn = np.cross(e1, e2)
            nrm = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = fn / np.maximum(nrm, 1e-30)
            tri_norm = np.repeat(fn[:, None, :], 3, axis=1)
        tri_norm = np.ascontiguousarray(tri_norm, dtype=np.float32)
        if tri_color is None:
            tri_color = np.ones_like(tri_pos)
        tri_color = np.ascontiguousarray(tri_color, dtype=np.float32)

        if T == 0:
            empty = np.zeros((0, 3), np.float32)
            return TriangleSet(empty, empty, empty, np.zeros((0, 3), np.int32))
        records = np.concatenate(
            [tri_pos.reshape(-1, 3), tri_norm.reshape(-1, 3), tri_color.reshape(-1, 3)],
            axis=1,
        )  # (3T, 9)
        void_view = np.ascontiguousarray(records).view(
            np.dtype((np.void, records.dtype.itemsize * records.shape[1]))
        ).ravel()
        _, first_idx, inverse = np.unique(
            void_view, return_index=True, return_inverse=True
        )
        order = np.argsort(first_idx, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(order.size)
        uniq = records[np.sort(first_idx)]
        return TriangleSet(
            positions=np.ascontiguousarray(uniq[:, 0:3], np.float32),
            normals=np.ascontiguousarray(uniq[:, 3:6], np.float32),
            colors=np.ascontiguousarray(uniq[:, 6:9], np.float32),
            indices=rank[inverse.reshape(-1)].reshape(T, 3).astype(np.int32),
        )

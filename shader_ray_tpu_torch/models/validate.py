"""Scene-data structural sanitizer (counterpart of
shader_ray_tpu/models/validate.py).

The reference guards its flattening with hard asserts (index bounds in
generate_group_indices, world.cpp:147-173; hitmiss stack depth,
world.cpp:273).  The kernels index the packed tables without bounds
checks, so the tables are checked here, at pack time, where a violation
can still be attributed: ``engine.Renderer`` runs
``validate_scene_data`` when ``Config.validate_scene`` is set
(SRT_VALIDATE).
"""

from __future__ import annotations

import numpy as np

from shader_ray_tpu_torch.models.world import SceneData


class SceneValidationError(AssertionError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SceneValidationError(msg)


def validate_scene_data(data: SceneData) -> None:
    """Invariants every engine relies on; raises SceneValidationError.

    * leaf (start, count) ranges lie within the triangle array and
      tile it exactly (each BVH-order triangle in exactly one leaf);
    * hitmiss links, where present, are -1 or valid node indices for
      all 8 octants;
    * node boxes are ordered (min <= max) and children's boxes are
      contained in their parent's;
    * child indices are valid and each non-root node has exactly one
      parent; the root reaches every node.
    """
    n = data.group_count
    T = data.triangle_count
    obj = data.node_objects
    _check(0 <= data.tree_root < max(n, 1), "tree_root out of range")

    is_leaf = obj[:, 1] > 0
    starts, counts = obj[is_leaf, 0], obj[is_leaf, 1]
    _check((starts >= 0).all(), "negative leaf start")
    _check(
        (starts + counts <= max(T, 0)).all() or T == 0,
        "leaf range exceeds triangle count",
    )
    if T > 0:
        covered = np.zeros(T, np.int32)
        for s, c in zip(starts, counts):
            covered[s : s + c] += 1
        _check(
            (covered == 1).all(),
            "leaf ranges must tile the triangle array exactly once",
        )

    hm = data.hitmiss
    if hm is not None:  # scenes converted without links have none
        _check(hm.shape == (8, n, 2), f"hitmiss shape {hm.shape}")
        _check(
            ((hm >= -1) & (hm < n)).all(),
            "hitmiss link out of node range",
        )

    boxes = data.node_boxes
    _check(
        (boxes[:, 0:3] <= boxes[:, 3:6] + 1e-6).all(),
        "node box min > max",
    )

    if data.node_children is not None and n > 0:
        ch = data.node_children
        internal = ~is_leaf
        valid_child = (ch >= 0) & (ch < n)
        _check(
            valid_child[internal].all() or not internal.any(),
            "internal node with invalid child index",
        )
        _check((ch[is_leaf] == -1).all(), "leaf node with children")
        # each non-root node has exactly one parent; all reachable
        indeg = np.zeros(n, np.int32)
        kids = ch[internal].reshape(-1)
        kids = kids[kids >= 0]
        np.add.at(indeg, kids, 1)
        root_mask = np.arange(n) == data.tree_root
        _check(indeg[data.tree_root] == 0, "root has a parent")
        _check(
            (indeg[~root_mask] == 1).all(),
            "non-root node without exactly one parent",
        )
        # containment: child box inside parent box
        pmin = boxes[internal][:, 0:3]
        pmax = boxes[internal][:, 3:6]
        for side in (0, 1):
            c = ch[internal][:, side]
            _check(
                (boxes[c][:, 0:3] >= pmin - 1e-4).all()
                and (boxes[c][:, 3:6] <= pmax + 1e-4).all(),
                "child box escapes parent box",
            )

"""The port's 8-wide pack against the reference packer
(shader_ray_tpu/ops/pallas/pack_wide.pack_scene_wide, isect="woop",
collapse="sah") on the same scene: same wide-node count and stack
bound, same child sets per node, same octant orders, each dequantised
16-bit reference box contains the port's exact f32 box, and the Woop
records match pack._woop_records.  The port's node table packs a
child's box, meta and one octant's order into two float4s; the tests
read it back through ``child_boxes``, ``child_meta`` and ``orders``."""

import numpy as np
import pytest

from shader_ray_tpu.ops.pallas.pack import GROUP_ROWS, WOOP_LEAF_RECORD, WOOP_LEAVES_PER_GROUP
from shader_ray_tpu.ops.pallas.pack import _woop_records as ref_woop_records
from shader_ray_tpu.ops.pallas.pack_wide import pack_scene_wide as ref_pack_scene_wide
from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops.pack_wide import COUNT_SHIFT, FIRST_MASK, pack_scene_wide, woop_records

SCENES = {
    "bunny2k": lambda: bunny_class_scene(2000),
    "uv_sphere": lambda: uv_sphere(lat=12, lon=16),
}


@pytest.fixture(scope="module", params=sorted(SCENES))
def packs(request):
    pos, nrm = SCENES[request.param]()
    data = get_shader_data(make_world(TriangleSet.from_arrays(pos, nrm)))
    env = procedural_sky(64)
    ref = ref_pack_scene_wide(
        data, env, node_src="smem", collapse="sah", isect="woop",
        env_mode="dense", leaf_src="vmem",
    )
    return data, ref, pack_scene_wide(data, env)


def test_node_count_stack_and_orders(packs):
    _, ref, port = packs
    assert port.n_wide == ref.n_wide
    assert port.stack_depth == ref.stack_depth
    assert port.max_count == ref.max_count
    ref_order = np.asarray(ref.order_smem).reshape(ref.n_wide, 8)
    np.testing.assert_array_equal(port.orders.numpy(), ref_order)
    assert port.nodes.shape == (ref.n_wide, 8, 8) and port.nodes.is_contiguous()


def test_child_sets_and_boxes(packs):
    data, ref, port = packs
    Nw = ref.n_wide
    ref_meta = np.asarray(ref.cmeta_smem).reshape(Nw, 8)
    tribase = np.asarray(ref.tribase_smem)
    meta = port.child_meta.numpy()
    # the same child in each slot: the reference's leaf row maps to its
    # first triangle through the tribase table
    for w in range(Nw):
        for k in range(8):
            r, p = int(ref_meta[w, k]), int(meta[w, k])
            if r == -1 or p == -1:
                assert r == p == -1
            elif (r >> COUNT_SHIFT) & 0x1F:
                assert p >> COUNT_SHIFT == (r >> COUNT_SHIFT) & 0x1F
                assert p & FIRST_MASK == tribase[r & FIRST_MASK]
            else:
                assert p == r
    # conservative 16-bit boxes contain the exact ones (f64 dequant;
    # 1e-9 of the scene extent covers the dequant's own rounding)
    q = np.asarray(ref.boxes_smem).view(np.uint32).reshape(Nw, 8, 3).astype(np.int64)
    off = np.array(ref.box_quant[:3])
    scale = np.array(ref.box_quant[3:])
    lo = (q >> 16) * scale + off
    hi = (q & 0xFFFF) * scale + off
    boxes = port.child_boxes.numpy().astype(np.float64)
    filled = meta != -1
    slack = 1e-9 * np.abs(off).max() + 1e-9
    assert (lo[filled] <= boxes[..., 0:3][filled] + slack).all()
    assert (hi[filled] >= boxes[..., 3:6][filled] - slack).all()
    assert (boxes[..., 0:3][filled] <= boxes[..., 3:6][filled]).all()


def test_woop_records(packs):
    data, ref, port = packs
    want = ref_woop_records(data.tri_positions, data.tri_normals)
    np.testing.assert_allclose(woop_records(data.tri_positions, data.tri_normals), want, atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.leaves.numpy()[:, :21], want, atol=1e-6, rtol=0)
    assert port.leaves.shape == (len(want), 24) and not port.leaves[:, 21:].any()
    # and record by record against the reference's leaf-group layout
    leaves = np.asarray(ref.leaves)
    tribase = np.asarray(ref.tribase_smem)
    counts = np.minimum(data.node_objects[:, 1], 10)
    leaf_counts = counts[data.node_objects[:, 1] > 0]
    for row, (tb, cnt) in enumerate(zip(tribase, leaf_counts)):
        grp, sub = divmod(row, WOOP_LEAVES_PER_GROUP)
        c0 = sub * WOOP_LEAF_RECORD
        block = leaves[grp * GROUP_ROWS : grp * GROUP_ROWS + cnt, c0 : c0 + WOOP_LEAF_RECORD]
        np.testing.assert_allclose(port.leaves.numpy()[tb : tb + cnt, :21], block, atol=1e-6, rtol=0)

"""The plain reference against the port's plain CPU path at a tiny size,
its hierarchy's walk against brute force, and its control (TF32) far off;
the viewer's uniforms it replays against the App's."""

import copy
import hashlib

import numpy as np
import pytest
import torch

from portbench import reference as ref
from portbench import scene
from portbench.conftest import tiny_cell
from portbench.harness import compare


def _brute(tri, P, D):
    """Closest hit distance of each ray over every triangle (Moller-Trumbore, f64)."""
    v0, e0, e1 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 0] - tri[:, 2]
    best = np.full(len(P), ref.INFINITELY_FAR)
    for r in range(len(P)):
        M = np.cross(e1, D[r])
        det = (e0 * M).sum(1)
        ok = det != 0
        inv = 1.0 / np.where(ok, det, 1.0)
        Tv = P[r] - v0
        Q = np.cross(Tv, e0)
        t = -(e1 * Q).sum(1) * inv
        u = (Tv * M).sum(1) * inv
        v = (D[r] * Q).sum(1) * inv
        hit = ok & (t >= 0) & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
        if hit.any():
            best[r] = t[hit].min()
    return best


def test_walk_matches_brute_force():
    tri = scene.bunny_class_scene(1500).astype(np.float64)
    rng = np.random.default_rng(4)
    P = rng.normal(size=(300, 3)) * 2.5
    D = -P / np.linalg.norm(P, axis=1, keepdims=True) + rng.normal(size=(300, 3)) * 0.3
    D /= np.linalg.norm(D, axis=1, keepdims=True)
    bvh = ref.BVH(torch.from_numpy(tri))
    t, which, work = bvh.trace(torch.from_numpy(P), torch.from_numpy(D),
                               torch.ones(300, dtype=torch.bool), False)
    np.testing.assert_allclose(t.numpy(), _brute(tri, P, D), rtol=1e-12)
    assert (which.numpy() >= 0).sum() == (t.numpy() < ref.INFINITELY_FAR).sum() > 100
    assert work.slabs > 0 and work.tris >= work.tris_t >= work.tris_u > 0
    any_t, _, _ = bvh.trace(torch.from_numpy(P), torch.from_numpy(D),
                            torch.ones(300, dtype=torch.bool), True)
    assert np.array_equal(any_t.numpy() < ref.INFINITELY_FAR, t.numpy() < ref.INFINITELY_FAR)


@pytest.mark.parametrize("samples", [1, 4])
def test_reference_matches_the_ports_plain_path(tiny_session, samples):
    """The viewer's frames after three drags, rendered by the port's plain
    versions, against the reference at every pixel."""
    cell = tiny_cell("bunny69k.interactive")
    app = tiny_session.app(cell.traffic, tiny_session.renderer)
    gestures = [(5.0, -3.0), (-7.5, 2.25), (0.5, 6.0)]
    frames = []
    for dx, dy in gestures:
        app.drag(dx, dy)
        frames.append(app.render() if samples == 1 else app.render_progressive(samples))
    views = ref.replay_views(tiny_session.tri, 48, 32, 40.0, 6, 0, gestures, [0, 2])
    R = ref.Reference(tiny_session.tri, tiny_session.sky)
    C = ref.Reference(tiny_session.tri, tiny_session.sky, precision="tf32")
    jit = ref.halton_jitters(samples) if samples > 1 else np.zeros((1, 2), np.float32)
    pix = [np.arange(48 * 32)] * 2
    want, work = R.render([views[0], views[2]], 48, 32, pix, jit)
    got = np.concatenate([frames[0].reshape(-1, 3), frames[2].reshape(-1, 3)])
    ours = compare(np.abs(got - want))
    assert ours["max_err"] < 1e-5 and ours["off_share"] == 0.0
    control = compare(np.abs(C.render([views[0], views[2]], 48, 32, pix, jit)[0] - want))
    assert control["mean_err"] > 1000 * ours["mean_err"] and control["off_share"] > 0.01


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, 3.14159265], dtype=torch.float32)
    y = ref.tf32(x)
    assert y[0] == 1.0 and y[2] == 1.0 + 2**-10
    m = y.view(torch.int32) & 0x1FFF
    assert (m == 0).all()
    assert abs(float(y[3]) - 3.14159265) <= 3.14159265 * 2**-11


GESTURES = [(5.0, -3.0), (-7.5, 2.25), (0.5, 6.0), (12.0, 0.0), (-3.0, -9.5)]
# sha256 of each View's fields (float32 bytes, in field order) after
# GESTURES on bunny_class_scene(2000) in a 48 x 32 window, recorded from the
# commit before view drags
RECORDED_VIEWS = {
    0: "14675efc9e8baf001b5e21fdb8d9e4fe88f96574ac1dec767e036a6f15966dee",
    2: "6feed6c40d8958b079f5aae1eb9e7da4d847125ac7e4cff5f8f633ed33da041f",
    4: "cb573664be5a6722b472ade3d71704e87139a34bcb37fec7484e4c0011c5b10e",
}


def _digest(view: ref.View) -> str:
    h = hashlib.sha256()
    for x in view:
        a = np.ascontiguousarray(np.asarray(x, np.float32))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("drags", [None, []])
def test_views_without_drags_are_the_recorded_ones(drags):
    tri = scene.bunny_class_scene(2000)
    args = (tri, 48, 32, 40.0, 6, 0, GESTURES, [0, 2, 4])
    views = ref.replay_views(*args) if drags is None else ref.replay_views(*args, drags)
    assert {i: _digest(v) for i, v in views.items()} == RECORDED_VIEWS


DRAGS = [{"target": "light", "x": 0.21, "y": -0.13}, {"target": "object", "x": -0.07, "y": 0.33},
         {"target": "light", "x": -0.05, "y": 0.02}]


def test_drags_replay_as_the_app_turns_light_and_object(tiny_session):
    """The configuration's drags through Session.app's keys and drags,
    then one traffic gesture: the reference's light and object matrices
    equal the App's bit for bit, and each drag moved them."""
    cell = tiny_cell("bunny69k.interactive")
    session = copy.copy(tiny_session)
    session.config = copy.deepcopy(tiny_session.config)
    session.config["view"]["drags"] = DRAGS
    app = session.app(cell.traffic, session.renderer)
    assert app.motion_target.name == "OBJECT"
    app.drag(7.0, -2.5)
    view = ref.replay_views(session.tri, 48, 32, 40.0, 6, 0, [(7.0, -2.5)], [0], DRAGS)[0]
    w = app.world
    assert np.array_equal(view.light_dir, app.light_dir)
    assert np.array_equal(view.object_matrix, w.object_matrix)
    assert np.array_equal(view.object_normal, w.object_normal_matrix)
    assert np.array_equal(view.normal_inverse, w.object_normal_inverse)
    assert np.array_equal(view.camera_normal, w.camera_normal_matrix)
    plain = ref.replay_views(session.tri, 48, 32, 40.0, 6, 0, [(7.0, -2.5)], [0])[0]
    for drags, same_light in ((DRAGS[1:2], True), (DRAGS[0:1] + DRAGS[2:], False)):
        moved = ref.replay_views(session.tri, 48, 32, 40.0, 6, 0, [(7.0, -2.5)], [0], drags)[0]
        assert np.array_equal(moved.light_dir, plain.light_dir) == same_light
        assert np.array_equal(moved.object_matrix, plain.object_matrix) != same_light


def test_an_unknown_drag_target_raises(tiny_session):
    with pytest.raises(ValueError, match="sun"):
        ref.replay_views(tiny_session.tri, 48, 32, 40.0, 6, 0, [], [], [{"target": "sun", "x": 0, "y": 0}])
    session = copy.copy(tiny_session)
    session.config = copy.deepcopy(tiny_session.config)
    session.config["view"]["drags"] = [{"target": "sun", "x": 0.1, "y": 0.0}]
    with pytest.raises(KeyError, match="sun"):
        session.app(tiny_cell("bunny69k.interactive").traffic, session.renderer)

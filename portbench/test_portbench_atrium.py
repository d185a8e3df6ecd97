"""The atrium scene (scenes/atrium.py) and its cell, sponza262k.converge:
the generator's mesh at the published count and at the tiny size, the
cell run whole and correct on the CPU over an SBVH with duplicated
references, and the walk-counter metrics read from a traced run."""

import numpy as np
import pytest

from portbench import harness, spec
from portbench.conftest import tiny_cell

CELL = "sponza262k.converge"


def _scene(**kw) -> dict:
    return dict(spec.find_cell(CELL).config["scene"], **kw)


def _aspect(tri: np.ndarray) -> np.ndarray:
    """Longest edge over the height onto it, of each triangle (float64)."""
    t = tri.astype(np.float64)
    edges = np.stack([t[:, 1] - t[:, 0], t[:, 2] - t[:, 1], t[:, 0] - t[:, 2]], 1)
    longest = (edges ** 2).sum(-1).max(1)
    return longest / np.linalg.norm(np.cross(edges[:, 0], edges[:, 1]), axis=1)


def test_the_generator_makes_sponzas_count_of_mostly_thin_or_small_triangles():
    """Sponza's count, at least a quarter of it thin, and no part a filler:
    the floor (the triangles in the plane y = 0) holds under 5%."""
    generate = spec.module("scenes", "atrium").generate
    tri = generate(_scene())
    assert tri.dtype == np.float32 and tri.ndim == 3 and tri.shape[1:] == (3, 3)
    assert np.array_equal(tri, generate(_scene()))
    assert abs(len(tri) - 262267) <= 0.01 * 262267
    assert spec.find_cell(CELL).config["triangles"] == len(tri)
    area = np.linalg.norm(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]), axis=1)
    assert (area > 0).all()
    assert (_aspect(tri) > 10).mean() >= 0.25
    assert (tri[:, :, 1] == 0).all(1).mean() < 0.05


@pytest.mark.parametrize("target", [2000, 262267])
def test_every_solid_is_closed_without_t_junctions(target):
    """Each solid part (all but the floor, the leaves and the fabric,
    which are sheets) is a closed surface: every edge, between float32
    vertices, is shared by exactly two triangles."""
    atrium = spec.module("scenes", "atrium")
    solids, sheets = atrium._building(_scene(target_tris=target),
                                      atrium._detail(min(1.0, target / atrium.FULL)))
    assert len(solids) > len(sheets) > 2
    for part in solids:
        v = part.astype(np.float32).reshape(-1, 3)
        _, ids = np.unique(v, axis=0, return_inverse=True)
        ids = ids.reshape(-1, 3)
        edges = np.sort(np.concatenate([ids[:, [0, 1]], ids[:, [1, 2]], ids[:, [2, 0]]]), 1)
        _, uses = np.unique(edges, axis=0, return_counts=True)
        assert (uses == 2).all()


@pytest.fixture(scope="module")
def atrium_session():
    return harness.Session(tiny_cell(CELL).config, "cpu")


def test_the_tiny_cell_runs_correct_over_duplicated_references(atrium_session):
    cell = tiny_cell(CELL)
    session = atrium_session
    assert session.cfg.splits == "sbvh" and len(session.tri) == 2000
    assert len(session.world.tri_order) > len(session.tri)   # spatial splits took place
    seed = 2**31 + 2017
    run, gestures, kept = harness.run_window(session, cell.name, cell.traffic, seed, 1.0, False)
    assert run.requests >= 2
    harness.check(session, run, gestures, kept, seed)
    assert harness.verdict(run.check, cell.limits), run.check


def test_the_walk_counter_metrics_read_a_traced_run(atrium_session):
    cell = tiny_cell(CELL)
    run, _, _ = harness.run_window(atrium_session, cell.name, cell.traffic, 2**31 + 2018, 1.0, True)
    assert {"shadow_pops_share.converge", "tri_tests_per_ray.converge"} <= {m["name"] for m in cell.per_layer}
    share = spec.reader("shadow_pops_share.converge")(run)
    shadow = sum(run.counters[k] for k in run.counters if k.startswith("shadow") and k.endswith(".node_pops"))
    assert 0 < share < 100 and share == pytest.approx(100 * shadow / run.node_pops)
    tests = spec.reader("tri_tests_per_ray.converge")(run)
    assert tests == pytest.approx(sum(run.counters[k] for k in run.counters if k.endswith(".tri_tests"))
                                  / run.rays_cast) and tests > 0
    untraced = harness.Run(cell.name, cell.config, cell.traffic, 2000)
    assert spec.reader("shadow_pops_share.converge")(untraced) is None
    assert spec.reader("tri_tests_per_ray.converge")(untraced) is None

"""The scenes: scene.py's generators against the port's fixtures and
against the arrays recorded before generator files existed, and a
generator found as a file of a checkout."""

import hashlib

import numpy as np
import pytest

from portbench import scene, spec
from portbench.conftest import copy_checkout

# sha256 of make_scene's triangles and sky for each configuration, recorded
# from the commit before generator files (dtype, shape and bytes hashed)
RECORDED = {
    "bunny69k": ("7b17caaef26e94ab96ae48851719890f11403641d3c52b766ff89bffc49eb2f6",
                 "c2d99118eea2d81ead03071159003e3fad4344c335dcba753a354c5a536a60ad"),
    "bunny1m": ("e622890fe0fd2b2791b642fa4c2a5bb934db8a614f259e188650f577749ee73f",
                "c2d99118eea2d81ead03071159003e3fad4344c335dcba753a354c5a536a60ad"),
}

RIDGES = '''"""A test height field over [-1, 1]^2 with ridges, tilted by ``lift``."""

import numpy as np


def generate(scene: dict) -> np.ndarray:
    n = max(8, int(np.sqrt(scene["target_tris"] / 2.0)))
    xs = np.linspace(-1.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    Z = 0.3 * np.abs(np.sin(3.1 * np.pi * X) * np.sin(2.7 * np.pi * Y)) + scene["lift"] * X
    P = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    p00, p01, p10, p11 = P[:-1, :-1], P[:-1, 1:], P[1:, :-1], P[1:, 1:]
    both = np.stack([np.stack([p00, p10, p01], axis=2), np.stack([p01, p10, p11], axis=2)], axis=2)
    return both.reshape(-1, 3, 3)
'''


def digest(a: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(RECORDED))
def test_configured_scenes_keep_their_bytes(name):
    config = spec.load_json(spec.ROOT / "portbench" / "configs" / f"{name}.json")
    tri, sky = scene.make_scene(config["scene"])
    assert (digest(tri), digest(sky)) == RECORDED[name]
    assert len(tri) == config["triangles"]


def test_generators_match_the_ports_fixtures():
    from shader_ray_tpu_torch.models import fixtures

    for target in (2000, 5001):
        assert np.array_equal(scene.bunny_class_scene(target), fixtures.bunny_class_scene(target)[0])
    assert np.array_equal(scene.procedural_sky(256), fixtures.procedural_sky(256))


def test_a_generator_file_in_a_checkout(tmp_path):
    root = copy_checkout(tmp_path)
    (root / "portbench" / "scenes").mkdir()
    (root / "portbench" / "scenes" / "ridges.py").write_text(RIDGES)
    entry = {"generator": "ridges", "target_tris": 800, "sky_width": 64, "lift": 0.25}
    tri, sky = scene.make_scene(entry, root)
    assert tri.dtype == np.float32 and tri.shape == (2 * 20 * 20, 3, 3) and sky.shape == (32, 64, 3)
    assert tri[..., 2].max() > 0.25          # the entry's own key reached the generator
    with pytest.raises(KeyError, match="ridges"):
        scene.make_scene(entry)               # not in this checkout
    with pytest.raises(KeyError, match="no_such_generator"):
        scene.make_scene(dict(entry, generator="no_such_generator"), root)


def test_a_generator_that_returns_the_wrong_array_is_refused(tmp_path):
    root = copy_checkout(tmp_path)
    (root / "portbench" / "scenes").mkdir()
    (root / "portbench" / "scenes" / "flat.py").write_text(
        "import numpy as np\n\ndef generate(scene):\n    return np.zeros((4, 3, 3))\n")
    with pytest.raises(ValueError, match="float32"):
        scene.make_scene({"generator": "flat", "target_tris": 4, "sky_width": 64}, root)

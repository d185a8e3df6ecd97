"""The App's frame to the host (app/driver.App._to_host): on the CPU a
frame is returned as it is and counted as ``copy_to_host:plain`` in
``ops/_build.LAUNCHES``; on a card it goes in one stream-ordered copy
into page-locked memory of its own, counted as ``copy_to_host:pinned``,
bit for bit what ``.cpu()`` gives.  No returned frame is overwritten by a
later one on either route, and on a card dropped frames give their
blocks back to PyTorch's caching host allocator.  Besides, the benchmark's
reader of that counter, ``portbench/metrics/pinned_copy_pct.interactive.py``.
This file imports no jax, so its card tests run where jax is not
installed."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from portbench.harness import Run
from shader_ray_tpu_torch.app.driver import App
from shader_ray_tpu_torch.engine import Renderer
from shader_ray_tpu_torch.models.fixtures import bunny_class_scene, procedural_sky, uv_sphere
from shader_ray_tpu_torch.models.triangle_set import TriangleSet
from shader_ray_tpu_torch.models.world import get_shader_data, make_world
from shader_ray_tpu_torch.ops import _build
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC = os.path.join(ROOT, "portbench", "metrics", "pinned_copy_pct.interactive.py")
N = 8  # CPU frames of N x N pixels: the plain version's time is the tests' time


@pytest.fixture(scope="module")
def cpu_app_parts():
    world = make_world(TriangleSet.from_arrays(*uv_sphere(lat=6, lon=8)))
    return world, Renderer(get_shader_data(world), procedural_sky(32), device="cpu")


def _frames(app: App, request: str, count: int) -> list[np.ndarray]:
    """``count`` frames of ``app``, a drag before each, by ``request``
    (``render`` or ``progressive``, 4 samples)."""
    out = []
    for i in range(count):
        app.drag(9.0 + 5.0 * i, -4.0 - 3.0 * i)
        out.append(app.render() if request == "render" else app.render_progressive(4))
    return out


@pytest.mark.parametrize("request_kind", ["render", "progressive"])
def test_cpu_frames_take_the_plain_route_and_stay_as_returned(cpu_app_parts, request_kind):
    world, renderer = cpu_app_parts
    app = App(world, renderer, width=N, height=N)
    plain, pinned = _build.LAUNCHES["copy_to_host:plain"], _build.LAUNCHES["copy_to_host:pinned"]
    first = _frames(app, request_kind, 1)[0]
    kept = first.copy()
    assert _build.LAUNCHES["copy_to_host:plain"] == plain + 1
    second = _frames(app, request_kind, 1)[0]
    assert _build.LAUNCHES["copy_to_host:plain"] == plain + 2
    assert _build.LAUNCHES["copy_to_host:pinned"] == pinned
    assert first.shape == second.shape == (N, N, 3)
    assert not np.array_equal(first, second)  # the drag moved the view
    assert np.array_equal(first, kept)


def _metric():
    spec = importlib.util.spec_from_file_location("pinned_copy_pct_interactive", METRIC)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@pytest.mark.parametrize("launches,requests,want", [
    ({"copy_to_host:pinned": 9731, "frame_kernel": 9731}, 9731, 100.0),
    ({"copy_to_host:pinned": 4000}, 8000, 50.0),
    ({"frame_kernel": 9731, "plans.frame_kernel": 9731}, 9731, None),
    ({}, 0, None),
])
def test_pinned_copy_pct_reads_the_pinned_count_over_the_requests(launches, requests, want):
    run = Run("bunny69k.interactive", {}, {}, 0, requests=requests, launches=launches)
    got = _metric()(run)
    assert got == pytest.approx(want) if want is not None else got is None


# --- on the card -------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_world():
    pos, nrm = bunny_class_scene(5000)
    return make_world(TriangleSet.from_arrays(pos, nrm))


class Holding:
    """The Renderer, with every output of its frame functions kept in
    ``outs``."""

    def __init__(self, renderer):
        self.renderer, self.outs = renderer, []

    def __getattr__(self, name):
        return getattr(self.renderer, name)

    def make_fn(self, statics):
        return self._held(self.renderer.make_fn(statics))

    def make_progressive_fn(self, statics, samples, reduce_sum=False):
        return self._held(self.renderer.make_progressive_fn(statics, samples, reduce_sum))

    def _held(self, fn):
        def call(params):
            self.outs.append(fn(params))
            return self.outs[-1]
        return call


def _card_app(world, device, width: int, height: int) -> App:
    renderer = Renderer(get_shader_data(world), procedural_sky(256), device=device)
    return App(world, Holding(renderer), width=width, height=height)


def _pinned(frame: np.ndarray) -> bool:
    return torch.from_numpy(frame).is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("request_kind,width,height", [("render", 512, 512),
                                                       ("progressive", 1024, 768)])
def test_pinned_frame_is_the_cpu_copy_bit_for_bit_on_card(cuda_device, card_world, request_kind,
                                                          width, height):
    """The frame function's output, held back, against the frame the App
    returned: ``.cpu().numpy()`` of it, byte for byte, in page-locked
    memory, one ``copy_to_host:pinned`` a frame and no plain copy."""
    app = _card_app(card_world, cuda_device, width, height)
    pinned, plain = _build.LAUNCHES["copy_to_host:pinned"], _build.LAUNCHES["copy_to_host:plain"]
    frames = _frames(app, request_kind, 2)
    assert _build.LAUNCHES["copy_to_host:pinned"] == pinned + 2
    assert _build.LAUNCHES["copy_to_host:plain"] == plain
    for frame, out in zip(frames, app.renderer.outs, strict=True):
        want = out.cpu().numpy()
        assert frame.shape == want.shape == (height, width, 3) and frame.dtype == want.dtype
        assert frame.tobytes() == want.tobytes()
        assert _pinned(frame)


@pytest.mark.cuda
def test_pinned_frames_are_not_overwritten_on_card(cuda_device, card_world):
    """Three frames from three views: each in its own page-locked block,
    and the first unchanged after the third."""
    app = _card_app(card_world, cuda_device, 512, 512)
    frames = _frames(app, "render", 1)
    kept = frames[0].copy()
    frames += _frames(app, "render", 2)
    assert all(_pinned(f) for f in frames)
    assert len({f.ctypes.data for f in frames}) == 3
    assert not np.array_equal(frames[0], frames[2])
    assert frames[0].tobytes() == kept.tobytes()
    # the blocks of dropped frames go back to the allocator; the held one does not
    del frames[1:]
    _frames(app, "render", 3)
    assert frames[0].tobytes() == kept.tobytes()


@pytest.mark.cuda
def test_dropped_frames_reuse_pinned_blocks_on_card(cuda_device, card_world):
    """After warm-up, 20 frames that the caller drops allocate no new
    page-locked memory: each reuses a block an earlier frame gave back."""
    app = _card_app(card_world, cuda_device, 512, 512)
    _frames(app, "render", 3)
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    for _ in range(20):
        app.drag(7.0, -5.0)
        assert _pinned(app.render())
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before

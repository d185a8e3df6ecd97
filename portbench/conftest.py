"""Fixtures of the benchmark's CPU tests: the cells at a tiny size, run
through the port's plain PyTorch versions (``device="cpu"``)."""

import copy
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness, spec


def tiny_cell(name: str, bench: dict | None = None, root: Path = spec.ROOT) -> spec.Cell:
    """Cell ``name`` (of ``bench`` in the checkout ``root``) with a
    2,000-triangle scene, a 256-wide sky, a 48 x 32 window and progressive
    batches of 8 samples: the same code, the CPU's size."""
    cell = spec.find_cell(name, bench, root)
    config = copy.deepcopy(cell.config)
    config["scene"].update(target_tris=2000, sky_width=256)
    mix = dict(cell.traffic, width=48, height=32, warmup=1, trace_seconds=0.5,
               check=dict(cell.traffic["check"], pixels=256))
    if "samples" in mix:
        mix["samples"] = 8
    return cell._replace(config=config, traffic=mix)


def copy_checkout(to: Path) -> Path:
    """A checkout at ``to`` holding ``BENCHMARK.json`` and a copy of this
    package, for tests that add files as a later change would."""
    shutil.copytree(spec.PACKAGE, to / spec.PACKAGE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", to / "BENCHMARK.json")
    return to


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_session():
    """A tiny bunny69k Session on the CPU, built once a module."""
    return harness.Session(tiny_cell("bunny69k.interactive").config, "cpu")

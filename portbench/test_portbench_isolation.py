"""What the benchmark imports: nothing whose top-level name is jax,
jaxlib, flax or the JAX package (shader_ray_tpu), compared whole; and the
yardstick's modules (reference, scene, costs, traffic, trace, spec, the
metric readers and the scene generator files) nothing of the port
either."""

import ast
import subprocess
import sys

import pytest

from portbench import run, spec
from portbench.conftest import copy_checkout

FORBIDDEN = {"jax", "jaxlib", "flax", "shader_ray_tpu"}
YARDSTICK = ("reference", "scene", "costs", "traffic", "trace", "spec")


def _imports(path) -> set[str]:
    """Top-level names of every module ``path`` imports (relative imports
    excluded)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources(package=spec.PACKAGE):
    return sorted(p for p in package.rglob("*.py") if not p.name.startswith("test_"))


def _yardstick(package=spec.PACKAGE):
    return ([package / f"{name}.py" for name in YARDSTICK] + sorted((package / "metrics").glob("*.py"))
            + sorted((package / "scenes").glob("*.py")))


def _port_importers(package=spec.PACKAGE) -> list[str]:
    """The yardstick's files that import the port or any forbidden module."""
    return [p.name for p in _yardstick(package) if _imports(p) & (FORBIDDEN | {"shader_ray_tpu_torch"})]


def _jax_importers(package=spec.PACKAGE) -> list[str]:
    return [p.name for p in _sources(package) if _imports(p) & FORBIDDEN]


def test_no_module_imports_jax_or_the_jax_package():
    assert _jax_importers() == []


def test_the_yardstick_imports_nothing_of_the_port():
    assert _port_importers() == []


@pytest.mark.parametrize("module,caught_as", [("shader_ray_tpu_torch.models.fixtures", "port"),
                                              ("jax.numpy", "jax"), ("numpy", None)])
def test_a_scene_generator_file_counts_as_yardstick(tmp_path, module, caught_as):
    pkg = copy_checkout(tmp_path) / "portbench"
    (pkg / "scenes").mkdir()
    (pkg / "scenes" / "mesh.py").write_text(f"import {module}\n\n\ndef generate(scene):\n    pass\n")
    assert _port_importers(pkg) == ([] if caught_as is None else ["mesh.py"])
    assert _jax_importers(pkg) == (["mesh.py"] if caught_as == "jax" else [])


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "shader_ray_tpu_torch.engine", object())
    assert "shader_ray_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.forbidden_modules()


def test_importing_the_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference, portbench.scene, portbench.costs, "
            "portbench.traffic, portbench.trace, portbench.spec; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'shader_ray_tpu_torch', 'shader_ray_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_a_run_without_a_card_prints_no_result(monkeypatch, capsys):
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    code = run.main(["--workload", "bunny69k.interactive", "--seed", str(2**33 + 1), "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "no CUDA device" in out.err


def test_srt_variables_do_not_reach_a_run(monkeypatch):
    monkeypatch.setenv("SRT_ISECT", "mt")
    monkeypatch.setattr(run.torch.cuda, "is_available", lambda: False)
    run.main(["--workload", "bunny69k.interactive", "--seed", "1", "--seconds", "1"])
    import os

    assert "SRT_ISECT" not in os.environ


@pytest.mark.parametrize("name", ["jax", "flax", "shader_ray_tpu"])
def test_a_forbidden_module_is_named(monkeypatch, name):
    monkeypatch.setitem(sys.modules, name, object())
    assert name in run.forbidden_modules()

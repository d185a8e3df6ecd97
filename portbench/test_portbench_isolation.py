"""What the benchmark imports: nothing whose top-level name is jax,
jaxlib, flax or the JAX package (shader_ray_tpu), compared whole; and the
yardstick's modules (reference, scene, costs, traffic, trace, spec)
nothing of the port either."""

import ast
import subprocess
import sys

import pytest

from portbench import run, spec

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


def _sources():
    return sorted(p for p in spec.PACKAGE.rglob("*.py") if not p.name.startswith("test_"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & FORBIDDEN
        assert not bad, f"{path.name} imports {bad}"


def test_the_yardstick_imports_nothing_of_the_port():
    for name in YARDSTICK:
        assert "shader_ray_tpu_torch" not in _imports(spec.PACKAGE / f"{name}.py"), name
    for path in (spec.PACKAGE / "metrics").glob("*.py"):
        assert "shader_ray_tpu_torch" not in _imports(path), path.name


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

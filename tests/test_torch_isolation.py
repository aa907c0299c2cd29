"""The port stands alone: no module of symbiont_tpu_torch, and neither
chip_smoke.py nor scripts/port_kernels_ab.py, imports `jax` or the JAX package
`symbiont_tpu` (or any of its submodules). Checked on the syntax tree, so
an import inside a function counts too. `symbiont_tpu_torch` itself is
allowed. No string in those files names a module of the JAX package either
(a `-m` argv, an `importlib` name): a child process launched by such a
string would run the JAX package. The supervisor's specs launch the
port's runner and broker."""

import ast
import importlib.util
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "symbiont_tpu"}
FILES = sorted((ROOT / "symbiont_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "port_kernels_ab.py"]


def imported_top_levels(source: str) -> set:
    names = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_scan_covers_the_package():
    rel = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert {"chip_smoke.py", "scripts/port_kernels_ab.py",
            "symbiont_tpu_torch/engine/engine.py",
            "symbiont_tpu_torch/ops/flash_attention.py",
            "symbiont_tpu_torch/models/bert.py",
            "symbiont_tpu_torch/memory/vector_store.py",
            "symbiont_tpu_torch/train/trainer.py",
            "symbiont_tpu_torch/train/checkpoint.py",
            "symbiont_tpu_torch/models/convert.py",
            "symbiont_tpu_torch/models/gpt.py",
            "symbiont_tpu_torch/engine/lm.py",
            "symbiont_tpu_torch/engine/batcher.py",
            "symbiont_tpu_torch/obs/usage.py",
            "symbiont_tpu_torch/resilience/admission.py",
            "symbiont_tpu_torch/models/quant.py",
            "symbiont_tpu_torch/obs/device.py",
            "symbiont_tpu_torch/obs/engine_timeline.py",
            "symbiont_tpu_torch/obs/hbm.py",
            "symbiont_tpu_torch/obs/xprof.py",
            "symbiont_tpu_torch/utils/telemetry.py",
            "symbiont_tpu_torch/kv/__init__.py",
            "symbiont_tpu_torch/kv/paged.py",
            "symbiont_tpu_torch/kv/pool.py",
            "symbiont_tpu_torch/kv/radix.py",
            "symbiont_tpu_torch/runner.py",
            "symbiont_tpu_torch/services/api.py",
            "symbiont_tpu_torch/bus/inproc.py",
            "symbiont_tpu_torch/schema/frames.py",
            "symbiont_tpu_torch/config.py",
            "symbiont_tpu_torch/bus/tcp.py",
            "symbiont_tpu_torch/bus/pybroker.py",
            "symbiont_tpu_torch/resilience/procsup.py",
            "symbiont_tpu_torch/resilience/genlog.py",
            "symbiont_tpu_torch/obs/fleet.py"} <= rel


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_jax_package_import(path):
    bad = imported_top_levels(path.read_text()) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


@pytest.mark.parametrize("src,bad", [
    ("import jax", {"jax"}),
    ("import jax.numpy as jnp", {"jax"}),
    ("from symbiont_tpu.engine import bucketing", {"symbiont_tpu"}),
    ("def f():\n    from symbiont_tpu import config", {"symbiont_tpu"}),
    ("import symbiont_tpu_torch.ops", set()),
    ("from symbiont_tpu_torch.engine.engine import TorchEngine", set()),
    ("from . import _build", set()),
    ("__import__('jax')", {"jax"}),
])
def test_scanner_matches_exact_top_level_name(src, bad):
    assert imported_top_levels(src) & FORBIDDEN == bad


_JAX_MODULE = re.compile(r"\bsymbiont_tpu\.[A-Za-z_]")


def jax_module_strings(source: str) -> list:
    """String constants (f-string parts included) that name a module of
    the JAX package, e.g. "symbiont_tpu.runner"."""
    return [node.value for node in ast.walk(ast.parse(source))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and _JAX_MODULE.search(node.value)]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_string_names_a_jax_package_module(path):
    bad = jax_module_strings(path.read_text())
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


@pytest.mark.parametrize("src,flagged", [
    ('argv = [sys.executable, "-m", "symbiont_tpu.runner"]', True),
    ('importlib.import_module("symbiont_tpu.bus.pybroker")', True),
    ('f"{x} symbiont_tpu.resilience"', True),
    ('argv = [sys.executable, "-m", "symbiont_tpu_torch.runner"]', False),
    ('"""the port of symbiont_tpu."""', False),
    ('"symbiont_tpu/bus/tcp.py"', False),
])
def test_string_scanner_matches_module_names(src, flagged):
    assert bool(jax_module_strings(src)) is flagged


def test_supervisor_specs_launch_the_ports_modules():
    from symbiont_tpu_torch.resilience.procsup import pybroker_spec, runner_spec

    runner = runner_spec("gen1", "text_generator", "symbus://127.0.0.1:4233")
    broker = pybroker_spec(4233, "data/symbus")
    assert runner.argv == [sys.executable, "-m", "symbiont_tpu_torch.runner"]
    assert broker.argv[:3] == [sys.executable, "-m", "symbiont_tpu_torch.bus.pybroker"]
    for mod in (runner.argv[2], broker.argv[2]):
        assert importlib.util.find_spec(mod) is not None

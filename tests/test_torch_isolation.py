"""The port stands alone: no module of symbiont_tpu_torch, and neither
chip_smoke.py nor scripts/port_kernels_ab.py, imports `jax` or the JAX package
`symbiont_tpu` (or any of its submodules). Checked on the syntax tree, so
an import inside a function counts too. `symbiont_tpu_torch` itself is
allowed."""

import ast
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
            "symbiont_tpu_torch/kv/radix.py"} <= rel


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

"""The port stands alone: no module of drivescenegen_torch/ and nothing in
chip_smoke.py imports JAX, flax, optax, orbax or the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "drivescenegen_tpu")
PKG = ROOT / "drivescenegen_torch"
# build/ holds what the kernels' build writes, not the port's sources.
FILES = sorted(p for p in PKG.rglob("*.py") if "build" not in p.relative_to(PKG).parts[:1])
FILES.append(ROOT / "chip_smoke.py")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


def test_the_port_has_its_modules():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    for required in ("drivescenegen_torch/config.py", "drivescenegen_torch/models/unet2d.py",
                     "drivescenegen_torch/diffusion/samplers.py", "chip_smoke.py"):
        assert required in names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"

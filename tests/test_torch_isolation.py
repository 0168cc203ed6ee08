"""The port stands alone: no module of drivescenegen_torch/ and nothing in
chip_smoke.py imports JAX, flax, optax, orbax or the JAX package, and no
module of the port names a path under drivescenegen_tpu/ to read. At run
time, the port's protobuf bindings load only modules of the port, even
after the JAX package's (which put their own directory on sys.path)."""

import ast
import subprocess
import sys
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
                     "drivescenegen_torch/diffusion/samplers.py", "chip_smoke.py",
                     "drivescenegen_torch/scripts/end_to_end.py",
                     "drivescenegen_torch/scripts/vectorization.py",
                     "drivescenegen_torch/ops/morphology.py",
                     "drivescenegen_torch/ops/lane_mask.py",
                     "drivescenegen_torch/ops/raster.py",
                     "drivescenegen_torch/scripts/data_preprocess.py",
                     "drivescenegen_torch/scripts/data_rasterization.py",
                     "drivescenegen_torch/scripts/compute_map_metrics.py",
                     "drivescenegen_torch/scripts/run_demo.py",
                     "drivescenegen_torch/parallel/mesh.py",
                     "drivescenegen_torch/utils/profiling.py",
                     "drivescenegen_torch/models/import_diffusers.py",
                     "drivescenegen_torch/scripts/import_reference.py",
                     "drivescenegen_torch/utils/flops.py",
                     "drivescenegen_torch/scripts/eval_cond_agents.py",
                     "drivescenegen_torch/scripts/validate_waymo.py",
                     "drivescenegen_torch/scripts/visualize.py",
                     "drivescenegen_torch/visualization.py"):
        assert required in names
    # The weights bridge imports orbax and flax: a tool beside the packages,
    # not a file of the port.
    assert (ROOT / "tools" / "params_bridge.py").exists()
    assert not [n for n in names if n.startswith("tools/")]


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _path_literals(path: Path):
    """String constants other than docstrings that name a path under
    drivescenegen_tpu/ (the package's name at the start of a path or as one
    of its parts)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = {id(node.body[0].value) for node in ast.walk(tree)
                  if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                       ast.AsyncFunctionDef))
                  and node.body and isinstance(node.body[0], ast.Expr)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docstrings):
            text = node.value.strip()
            if text == "drivescenegen_tpu" or text.startswith("drivescenegen_tpu/") or \
                    "/drivescenegen_tpu" in text:
                yield node.lineno, text


@pytest.mark.parametrize("path", FILES[:-1], ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_package_paths(path):
    bad = list(_path_literals(path))
    assert not bad, f"{path.name} names paths of the JAX package: {bad}"


def test_the_path_check_sees_a_path(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text('"""drivescenegen_tpu/ in a docstring is prose."""\n'
                     'SRC = os.path.join(ROOT, "drivescenegen_tpu", "native")\n'
                     'LIB = "drivescenegen_tpu/vectorize/native_graph.py"\n')
    assert sorted(line for line, _ in _path_literals(probe)) == [2, 3]


PROTOS_PROBE = """
import sys
import drivescenegen_tpu.data.protos
from drivescenegen_tpu.data.preprocess import decode_scenario as jax_decode
from drivescenegen_tpu.data.synthetic import make_synthetic_scenario
before = set(sys.modules)
import drivescenegen_torch.data.protos
from drivescenegen_torch.data.preprocess import decode_scenario
loaded = [m for m in set(sys.modules) - before if "pb2" in m or "protos" in m]
print(sorted((m, getattr(sys.modules[m], "__file__", None)) for m in loaded))
data = make_synthetic_scenario(3, rich=True)
a, b = decode_scenario(data), jax_decode(data)
assert a["scenario_id"] == b["scenario_id"] and a["lane"].keys() == b["lane"].keys()
assert all((a["lane"][k] == b["lane"][k]).all() for k in a["lane"])
assert (a["tracks_info"]["trajs"] == b["tracks_info"]["trajs"]).all()
"""


def test_the_ports_protos_load_the_ports_modules():
    out = subprocess.run([sys.executable, "-c", PROTOS_PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = ast.literal_eval(out.stdout.strip().splitlines()[-1])
    names = {m for m, _ in loaded}
    assert {"drivescenegen_torch.data.protos", "drivescenegen_torch.data.protos.dsg_map_pb2",
            "drivescenegen_torch.data.protos.dsg_scenario_pb2"} <= names
    for name, path in loaded:
        assert path is not None and Path(path).resolve().is_relative_to(PKG), (name, path)

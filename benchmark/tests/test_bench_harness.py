"""The harness finds every piece by name, BENCHMARK.json keeps to its
format, the yardstick's counts equal the port's, and nothing imports JAX."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import counts, harness

HERE = Path(harness.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return harness.bench_spec()


def test_every_piece_is_found_by_name(spec):
    configs = {c["name"]: c for c in spec["configs"]}
    for w in spec["workloads"]:
        cell, config = harness.cell_files(w["name"])
        assert cell["config"] == w["config"]
        assert configs[w["config"]]["file"] == f"benchmark/configs/{w['config']}.json"
        assert json.loads((harness.ROOT / configs[w["config"]]["file"]).read_text()) == config
        assert hasattr(harness.traffic_module(cell["kind"]), "Cell")
        assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    for m in spec["per_layer"]:
        module = harness.metric_module(m["name"])
        assert (module.LAYER, module.MOVES) == (m["layer"], m["moves"])
        assert callable(module.read)


def test_benchmark_json_format(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    names = []
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and not c["reduced"]
        names.append(c["name"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        names += [w["name"], w["traffic"]]
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"} and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and "\n" not in m["layer"]
        # every listed cell reports the end-to-end metric it moves
        assert set(m["workloads"]) <= set(e2e[m["moves"]].get("workloads", cells))
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for cell in cells:
        reported = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert harness.metrics_of(spec, "per_layer", cell)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax():
    for path in HERE.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops & set(harness.FORBIDDEN))


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        allowed = {"__future__", "contextlib", "math", "typing", "numpy", "torch"}
        assert tops <= allowed, (path, tops)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "drivescenegen_torchx", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert harness.forbidden_modules() == ["jaxlib.xla_client"]


@pytest.mark.parametrize("config", ["dsg_ref_unet256", "dsg_cond128"])
def test_counts_equal_the_ports(config):
    from drivescenegen_torch.config import ModelConfig
    from drivescenegen_torch.models.unet2d import conv3x3_shapes, mid_attention_shape
    from drivescenegen_torch.utils.flops import unet2d_forward_flops

    mcfg = harness.load_json(HERE / "configs" / f"{config}.json")["model"]
    port = ModelConfig(**mcfg)
    for batch in (1, 8, 16):
        assert counts.unet2d_forward_flops(mcfg, batch) == unet2d_forward_flops(port, batch)
    assert counts.conv3x3_calls(mcfg) == conv3x3_shapes(port)
    assert counts.mid_attention_shape(mcfg) == mid_attention_shape(port)


def test_counts_match_the_kernel_table():
    """The bounds chip_smoke.py's kernel table gives (PERF.md rows 1, 3b, 4b)."""
    ref = harness.load_json(HERE / "configs" / "dsg_ref_unet256.json")["model"]
    assert counts.unet2d_forward_flops(ref, 1) == pytest.approx(351.44e9, rel=1e-4)
    assert counts.conv3x3_forward_bound_s(ref, 8)[1] == 44
    assert counts.conv3x3_forward_bound_s(ref, 8)[0] * 1e3 == pytest.approx(2.1958, rel=1e-3)
    assert counts.attention_fwd_bound_s(14, 64, 1024, 8, True) * 1e3 == pytest.approx(
        0.0304, rel=2e-3)
    assert counts.attention_bwd_bound_s(14, 64, 1024, 8) * 1e3 == pytest.approx(0.0760, rel=2e-3)


def test_run_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "dsg_ref_unet256.ddim50_b8", "--seed", "3000000000", "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr

"""Tests of the benchmark harness. They run on the CPU at tiny sizes,
except those marked `card`, which need a CUDA card and skip without one:

  python -m pytest benchmark/tests -q

from the repository's root (the repository's own suite, `pytest tests/`,
does not collect them)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A width-cut copy of each configuration: the same modules at 32x32, two
# levels of widths 32 and 64, one layer a block, 8 groups.
TINY = {"sample_size": 32, "layers_per_block": 1, "block_out_channels": [32, 64],
        "norm_num_groups": 8}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


def tiny_cell(name: str):
    """(spec, workload, config) of cell `name`, cut to a CPU test's size:
    the workload's limits are the cell's own."""
    from benchmark import harness

    cell, config = harness.cell_files(name)
    cell, config = copy.deepcopy(cell), copy.deepcopy(config)
    config["model"].update(TINY)
    config["model"]["attention_head_dim"] = min(config["model"]["attention_head_dim"], 32)
    if cell["kind"] == "sample":
        cell["params"].update(batch=4, steps=10, check_scenes=4, profiled_batches=1)
    else:
        cell["params"].update(batch=4, corpus=16, ref_block=2, warmup_steps=1,
                              profiled_steps=2)
    return harness.bench_spec(), cell, config

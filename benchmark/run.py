"""Run one cell of the port's benchmark once and print its result line.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository's root, on a machine with an NVIDIA GPU. The last line
of standard output is one JSON object: correct, attempted, failed, metrics
(the cell's end-to-end metrics with --trace 0, its per-layer ones with
--trace 1), device, with --trace 1 breakdown, and last checks, each number
that decided `correct` beside its limit; standard error ends with the same
checks. It exits non-zero, printing no result, without a CUDA card, with
fewer cards than the cell asks for, where the port is not beside it, or
when a JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# Triton's kernel cache at a fixed path inside the checkout, so that only a
# checkout's first run compiles (the port's nvcc builds go to its own
# drivescenegen_torch/build/).
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "benchmark" / ".cache" / "triton")
sys.path.insert(0, str(ROOT))


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", required=True, type=int)
    p.add_argument("--seconds", required=True, type=float)
    p.add_argument("--trace", default=0, type=int, choices=(0, 1))
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.bench_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        return fail(f"no workload {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the port on a GPU and has no CPU "
                    "fallback")
    if torch.cuda.device_count() < cells[args.workload]["chips"]:
        return fail(f"{args.workload} needs {cells[args.workload]['chips']} GPUs, "
                    f"{torch.cuda.device_count()} visible")
    try:
        import drivescenegen_torch
    except ImportError as e:
        return fail(f"the port drivescenegen_torch is not beside the benchmark: {e}")
    if ROOT not in Path(drivescenegen_torch.__file__).resolve().parents:
        return fail(f"drivescenegen_torch was imported from {drivescenegen_torch.__file__}, "
                    f"outside this checkout")
    cell, config = harness.cell_files(args.workload)
    print(f"card: {harness.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          file=sys.stderr, flush=True)
    result = harness.run_cell(spec, args.workload, cell, config, args.seed, args.seconds,
                              bool(args.trace), "cuda", T_START)
    loaded = harness.forbidden_modules()
    if loaded:
        return fail(f"JAX modules were loaded in this process: {', '.join(loaded)}")
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings each correctness limit is set from, for one cell, in one
process on the card:

  python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \
      --control-seeds 7,8,9 [--faults half_batch,altered_answer] [--seconds 2]

- each of --seeds: one run of the cell at its own size (a short window, the
  traced part left out), the numbers its check compares: the lower
  readings, from sound runs;
- each of --control-seeds: the control, the reference with its products in
  fp8 in the program's place, against the float32 reference: the upper
  readings;
- with --faults, each named fault of benchmark/faults.py planted in the
  program, on each control seed: what each fault reads.

Prints one JSON line a reading, and writes them all to
chiprun_out/calibrate_<cell>.jsonl. The benchmark's own runs do not run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", default=2.0, type=float)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import os

    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / ".cache" / "triton"))
    from benchmark import faults, harness

    spec = harness.bench_spec()
    cell, config = harness.cell_files(args.workload)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    log = open(out_dir / f"calibrate_{args.workload}.jsonl", "a")

    def emit(record: dict) -> None:
        line = json.dumps(record)
        print(line, flush=True)
        log.write(line + "\n")
        log.flush()

    def seeds(text):
        return [int(s) for s in text.split(",") if s]

    if args.device == "cuda":
        emit({"card": harness.card_line()})
    for seed in seeds(args.seeds):
        t0 = time.perf_counter()
        res = harness.run_cell(spec, args.workload, cell, config, seed, args.seconds, False,
                               args.device)
        emit({"reading": "program", "seed": seed, "checks": res["checks"],
              "correct": res["correct"], "metrics": res["metrics"],
              "seconds": time.perf_counter() - t0})
    kind = harness.traffic_module(cell["kind"])
    for seed in seeds(args.control_seeds):
        t0 = time.perf_counter()
        checks = kind.Cell(cell, config, seed, args.device).control_check()
        emit({"reading": "control", "seed": seed, "checks": checks,
              "seconds": time.perf_counter() - t0})
    for name in [f for f in args.faults.split(",") if f]:
        for seed in seeds(args.control_seeds):
            t0 = time.perf_counter()
            with faults.FAULTS[name](cell["kind"]):
                res = harness.run_cell(spec, args.workload, cell, config, seed, args.seconds,
                                       False, args.device)
            emit({"reading": f"fault:{name}", "seed": seed, "checks": res["checks"],
                  "correct": res["correct"], "seconds": time.perf_counter() - t0})
    log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

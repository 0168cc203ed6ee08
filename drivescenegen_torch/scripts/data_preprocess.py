"""Stage 0a: Waymo TFRecords -> per-scenario pickles (the port's copy of
drivescenegen_tpu/scripts/data_preprocess.py; host only, no tensor).

CLI parity with the reference (scripts/data_preprocess.py:205-228):
  python -m drivescenegen_torch.scripts.data_preprocess \
      --load_path ./data/raw --save_path ./data/preprocessed

Extras over the reference:
  --synthetic N  generate N synthetic scenarios instead of reading TFRecords
                 (no Waymo data needed; useful for smoke runs/benchmarks)
  --backend      tfrecord reader backend (auto|native|tf|python)
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle
import time


def main(argv=None):
    parser = argparse.ArgumentParser(description="Data Processing 1")
    parser.add_argument("--load_path", default="./data/raw", type=str)
    parser.add_argument("--save_path", default="./data/preprocessed", type=str)
    parser.add_argument("--n_workers", default=8, type=int)
    parser.add_argument("--backend", default="auto", type=str,
                        choices=["auto", "native", "tf", "python"])
    parser.add_argument("--synthetic", default=0, type=int,
                        help="generate N synthetic scenarios instead of reading TFRecords")
    parser.add_argument("--synthetic_rich", action="store_true",
                        help="use the widened synthetic layout family "
                             "(T-junctions, curved two-ways, Y-splits, ...)")
    parser.add_argument("--synthetic_offset", default=0, type=int,
                        help="first synthetic seed (widen an existing corpus "
                             "without regenerating: new scenarios get seeds "
                             "[offset, offset+N) and the index file is merged)")
    args = parser.parse_args(argv)

    os.makedirs(args.save_path, exist_ok=True)
    t0 = time.perf_counter()

    if args.synthetic > 0:
        from drivescenegen_torch.data.preprocess import decode_scenario
        from drivescenegen_torch.data.synthetic import make_synthetic_scenario

        ids = []
        for i in range(args.synthetic_offset, args.synthetic_offset + args.synthetic):
            info = decode_scenario(
                make_synthetic_scenario(seed=i, rich=args.synthetic_rich)
            )
            sid = info["scenario_id"]
            with open(os.path.join(args.save_path, f"sample_{sid}.pkl"), "wb") as f:
                pickle.dump(info, f)
            ids.append(sid)
    else:
        from drivescenegen_torch.data.preprocess import process_files

        data_files = sorted(
            f for f in glob.glob(os.path.join(args.load_path, "*"))
            if os.path.isfile(f)
        )
        if not data_files:
            raise SystemExit(f"no TFRecord shards under {args.load_path}")
        ids = process_files(
            data_files, args.save_path, n_workers=args.n_workers, backend=args.backend
        )

    index_file = os.path.join(args.save_path, "processed_scenarios_20s.pkl")
    if args.synthetic_offset > 0 and os.path.exists(index_file):
        with open(index_file, "rb") as f:
            prior = pickle.load(f)
        ids = list(prior) + [s for s in ids if s not in set(prior)]
    with open(index_file, "wb") as f:
        pickle.dump(ids, f)
    dt = time.perf_counter() - t0
    print(f"Processed {len(ids)} scenarios in {dt:.1f}s -> {args.save_path}")
    return ids


if __name__ == "__main__":
    main()

"""The port's copy of drivescenegen_tpu/scripts/compute_map_metrics.py (host
only: numpy, scipy, networkx; no tensor).

Map-metrics CLI (reference: scripts/compute_map_metrics.py): compute
per-side map statistics (cached as .npy) and the Frechet/MMD comparison.

  python -m drivescenegen_torch.scripts.compute_map_metrics \
      --gt_dir <dir-with-graph/> --gen_dir <dir-with-graph/> \
      --map_range 80 --map_res 256

The gen side goes through the pixel->world transform (generated graphs are
in pixel coords); the GT side is already metric (graphs from
data/graph_export.py).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import random
import time

import numpy as np

from drivescenegen_torch.eval import map_metrics


def _side_stats(data_dir: str, num_samples: int, map_range, map_res, refresh: bool):
    # The cache key must encode the frame mode: a world-frame read against a
    # dir previously cached with the pixel->world transform (or vice versa)
    # must not return stale stats, so caches are mode-explicit. Legacy bare
    # "metrics/" caches (ambiguous mode) are deliberately not consulted.
    mode = (
        "world" if map_range is None else f"px{int(map_res)}_r{int(map_range)}"
    )
    metrics_dir = os.path.join(data_dir, f"metrics_{mode}")
    have_cache = all(
        os.path.exists(os.path.join(metrics_dir, f"{n}.npy"))
        for n in ("stats", "degrees", "spectrum")
    )
    if have_cache and not refresh:
        stats = np.load(os.path.join(metrics_dir, "stats.npy"))
        # Stat-schema upgrade: caches written before a new column was added
        # (e.g. OrientationR) have fewer rows than STATS_NAMES — recompute
        # rather than silently comparing truncated stat vectors.
        if stats.shape[0] >= len(map_metrics.STATS_NAMES):
            return (
                stats,
                np.load(os.path.join(metrics_dir, "degrees.npy")),
                np.load(os.path.join(metrics_dir, "spectrum.npy")),
            )
    files = sorted(glob.glob(os.path.join(data_dir, "graph", "*")))
    if not files:
        raise SystemExit(f"no graph pickles under {data_dir}/graph")
    if len(files) > num_samples:
        files = random.sample(files, num_samples)
    t0 = time.perf_counter()
    out = map_metrics.compute_map_stats(
        files, metrics_dir, map_range=map_range, map_res=map_res, verbose=False
    )
    print(f"{data_dir}: {len(files)} graphs in {time.perf_counter() - t0:.1f}s")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="Map metrics")
    parser.add_argument("--gt_dir", required=True, type=str)
    parser.add_argument("--gen_dir", required=True, type=str)
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--map_range", default=None, type=float)
    parser.add_argument("--map_res", default=None, type=int)
    parser.add_argument("--num_samples", default=None, type=int)
    parser.add_argument("--refresh", action="store_true")
    parser.add_argument("--json_out", default=None, type=str)
    parser.add_argument("--gen_world_frame", action="store_true",
                        help="gen graphs are already in world metres (e.g. a "
                             "held-out GT split used as a noise-floor "
                             "baseline); skip the pixel->world transform")
    args = parser.parse_args(argv)

    from drivescenegen_torch.config import load_config

    mcfg = load_config(args.cfg_file).metrics
    if args.map_range is None:
        args.map_range = mcfg.map_range
    if args.map_res is None:
        args.map_res = mcfg.map_res
    if args.num_samples is None:
        args.num_samples = mcfg.num_samples

    # GT graphs are in world metres already -> no transform (None, None).
    gt_stats, gt_degrees, gt_spectrum = _side_stats(
        args.gt_dir, args.num_samples, None, None, args.refresh
    )
    gen_stats, gen_degrees, gen_spectrum = _side_stats(
        args.gen_dir, args.num_samples,
        None if args.gen_world_frame else args.map_range,
        None if args.gen_world_frame else args.map_res,
        args.refresh,
    )

    fds, mmd_deg, mmd_spec = map_metrics.compute_map_metrics(
        gt_stats, gt_degrees, gt_spectrum, gen_stats, gen_degrees, gen_spectrum
    )

    result = {
        "frechet": {n: float(f) for n, f in zip(map_metrics.STATS_NAMES, fds)},
        "mmd_degrees": float(mmd_deg),
        "mmd_spectrum": float(mmd_spec),
        # Survivorship accounting: graphs entering the
        # pool vs samples rejected/failed upstream in vectorization, so
        # parity numbers can't silently hide selection bias.
        "n_gt_graphs": len(glob.glob(os.path.join(args.gt_dir, "graph", "*"))),
        "n_gen_graphs": len(glob.glob(os.path.join(args.gen_dir, "graph", "*"))),
    }
    vstats_path = os.path.join(args.gen_dir, "vectorization_stats.json")
    if os.path.exists(vstats_path):
        with open(vstats_path) as f:
            vstats = json.load(f)
        result["n_gen_images"] = vstats.get("n_images")
        result["n_rejected"] = vstats.get("n_rejected")
        result["n_failed"] = vstats.get("n_failed")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()

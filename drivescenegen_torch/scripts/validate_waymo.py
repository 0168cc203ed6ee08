"""Real-data readiness check (port of
drivescenegen_tpu/scripts/validate_waymo.py): validate that a Waymo Open
Motion TFRecord shard decodes sanely through our schema subset
(data/protos/*.proto declares the public field numbers; this check is
what exercises them against a real shard).

  python -m drivescenegen_torch.scripts.validate_waymo --shard <file> [--n 5] \
      [--rasterize [--device cuda|cpu]]

Checks per scenario: scenario_id present; tracks [A, 91, 11] with plausible
coordinate magnitudes and valid flags; map features of each category parse
with finite coordinates; lane types in range; with --rasterize, also that
rasterization (ops/raster.py, on --device, the card by default) produces
lane pixels. Prints a summary and exits nonzero on hard failures or when
nothing was checked; the output and exit codes are the JAX package's.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def validate_scenario(info: dict) -> list:
    problems = []
    if not info["scenario_id"]:
        problems.append("empty scenario_id")

    trajs = info["tracks_info"]["trajs"]
    if trajs.shape[0] == 0:
        problems.append("no tracks")
    else:
        if trajs.shape[1] != 91:
            problems.append(f"unexpected track length {trajs.shape[1]} (expected 91)")
        valid = trajs[..., 9]
        if valid.max() <= 0:
            problems.append("no valid track states (bool field 11 may be misdeclared)")
        xy = trajs[..., 0:2][valid > 0]
        if xy.size and (np.abs(xy).max() > 1e7 or not np.isfinite(xy).all()):
            problems.append("implausible track coordinates (field numbers off?)")
        types = np.unique(trajs[..., 10])
        if not set(types.astype(int)) <= {0, 1, 2, 3, 4}:
            problems.append(f"object types out of range: {types}")

    n_lanes = len(info["lane"])
    if n_lanes == 0:
        problems.append("no lane features decoded (MapFeature.lane tag?)")
    else:
        for lane in list(info["lane"].values())[:3]:
            if not np.isfinite(lane[:, :3]).all():
                problems.append("non-finite lane coordinates")
            if lane.shape[1] != 8:
                problems.append(f"lane feature width {lane.shape[1]} != 8")
        if not any(np.any(lane[:, 6] == 2.0) for lane in info["lane"].values()):
            problems.append("no TYPE_SURFACE_STREET lanes (type enum mapping?)")

    sdc = info["sdc_track_index"]
    if not (0 <= sdc < max(trajs.shape[0], 1)):
        problems.append(f"sdc_track_index {sdc} out of range")
    return problems


def main(argv=None):
    parser = argparse.ArgumentParser(description="Waymo shard validation")
    parser.add_argument("--shard", required=True, type=str)
    parser.add_argument("--n", default=5, type=int)
    parser.add_argument("--backend", default="auto", type=str)
    parser.add_argument("--rasterize", action="store_true",
                        help="also rasterize each scenario and check lane pixels")
    parser.add_argument("--device", default="cuda", type=str,
                        help="where --rasterize runs the splat")
    args = parser.parse_args(argv)

    from drivescenegen_torch.data import tfrecord
    from drivescenegen_torch.data.preprocess import decode_scenario

    n_checked = 0
    n_bad = 0
    category_counts = {"lane": 0, "road_polylines": 0, "crosswalk": 0,
                       "stop_sign": 0, "speed_bump": 0, "drive_way": 0}
    for i, data in enumerate(tfrecord.read_tfrecord(args.shard, backend=args.backend)):
        if i >= args.n:
            break
        info = decode_scenario(data)
        problems = validate_scenario(info)
        for key in category_counts:
            category_counts[key] += len(info.get(key, {}))
        if args.rasterize:
            from drivescenegen_torch.ops.raster import rasterize_scenario

            img = rasterize_scenario(info, img_res=256, map_range=80.0, device=args.device)
            lane_px = int((np.abs(img[..., 0] - 0.5) > 0.05).sum())
            if lane_px < 50:
                problems.append(f"rasterization produced only {lane_px} lane px")
        n_checked += 1
        status = "OK" if not problems else "BAD: " + "; ".join(problems)
        print(f"scenario {i} ({info['scenario_id']}): {status}")
        n_bad += bool(problems)

    print(f"\nchecked {n_checked} scenarios, {n_bad} with problems")
    print(f"feature counts: {category_counts}")
    if category_counts["drive_way"] == 0:
        print("note: zero driveway features — fine if the shard has none, but "
              "verify MapFeature.driveway tag (20) against one shard known to "
              "contain driveways")
    if n_checked == 0:
        print("ERROR: no scenarios checked — empty shard or --n 0; nothing "
              "was validated")
        sys.exit(1)
    sys.exit(1 if n_bad else 0)


if __name__ == "__main__":
    main()

"""The port's copy of drivescenegen_tpu/data/augment.py.

Scenario-level data augmentation.

Generated scenes can drop one direction of two-way lane pairs (the
OrientationR column of the map metrics shows it). The principled data-side attack is direction balancing: a 180°
rotation maps every lane direction onto its opposite, so a corpus with
both orientations of each scene presents the model with exactly
direction-symmetric statistics.

The rotation must happen at the SCENARIO level, before rasterization. A
raster-space rot180 + color remap is NOT exact: the per-scene MinMax
dx/dy normalization (ops/map_processing.py dxdy_normalization) makes lane
colors map to `color_max - c` under rotation, but the gray background
(0.5) and anti-aliased splat boundaries do not follow that transform, and
the downstream integer-exact lane mask (ops/lane_mask.py) keys off exact
background bytes. Rotating the polylines/tracks and re-rasterizing is
exact by construction.

Reference parity note: the reference has no augmentation (its training
corpus is 70k real Waymo scenes); this is an extra of the JAX package, opt-in
via `data_rasterization --augment rot180` (doubles the corpus).
"""

from __future__ import annotations

import numpy as np


def rotate_scenario_180(info: dict) -> dict:
    """Rotate a decoded scenario (data/preprocess.py decode_scenario format)
    by 180° about the world origin.

    Everything downstream is ego-relative (rasterize_scenario translates
    lanes by ego@10 and agents by ego@t), and the ego rotates with the
    scene, so the choice of rotation center is immaterial: the resulting
    raster is the original scene seen upside down, with every lane's
    travel direction reversed in the ego frame.

    Transforms:
      lanes [N, >=7] (x, y, z, dx, dy, dz, type[, theta]):
        x, y, dx, dy -> negated; theta (col 7, unused by the raster)
        wrapped by +pi when present.
      tracks_info.trajs [A, T, 11]
        (cx, cy, cz, l, w, h, heading, vx, vy, valid, type):
        cx, cy, vx, vy -> negated; heading -> wrap_to_pi(heading + pi).

    Returns a new dict; the input and its arrays are not mutated. Keys the
    raster does not consume (scenario_id etc.) are carried through.
    """
    out = dict(info)

    lanes = {}
    for k, v in info.get("lane", {}).items():
        arr = np.array(v, dtype=np.float32, copy=True)
        arr[:, 0:2] = -arr[:, 0:2]
        arr[:, 3:5] = -arr[:, 3:5]
        if arr.shape[1] > 7:
            th = arr[:, 7] + np.pi
            arr[:, 7] = np.arctan2(np.sin(th), np.cos(th))
        lanes[k] = arr
    out["lane"] = lanes

    ti = dict(info["tracks_info"])
    trajs = np.array(ti["trajs"], dtype=np.float32, copy=True)
    if trajs.size:
        trajs[:, :, 0:2] = -trajs[:, :, 0:2]
        trajs[:, :, 7:9] = -trajs[:, :, 7:9]
        h = trajs[:, :, 6] + np.pi
        trajs[:, :, 6] = np.arctan2(np.sin(h), np.cos(h))
    ti["trajs"] = trajs
    out["tracks_info"] = ti
    return out

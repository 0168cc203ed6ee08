"""The port's copy of drivescenegen_tpu/ops/map_processing.py.

Polyline/map processing: point-soup -> padded fixed-shape polyline tensors.

Host-side numpy (variable shapes), feeding fixed-shape arrays into the jitted
rasterizer. Semantics track the reference exactly:

- get_polyline_dir / wrap_to_pi  (reference: utils/datasets/waymo/data_utils.py:6-20)
- segment_points_to_polylines    (reference: utils/datasets/map_processing.py:32-59)
- generate_batch_polylines_from_map (map_processing.py:61-116): chunk to
  num_points_each_polyline with validity masks; features get a 9th "valid" col
- dxdy_normalization             (map_processing.py:206-229): per-column
  MinMaxScaler to [0, 0.99] fit over ALL rows including padding zeros (a
  reference quirk we reproduce: padding participates in the fit)
- transform_scenario             (map_processing.py:232-279): ego-translate
  only; the rotation is commented out in the reference
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def wrap_to_pi(theta):
    return (theta + np.pi) % (2 * np.pi) - np.pi


def get_polyline_dir(polyline_xyz: np.ndarray) -> np.ndarray:
    """Unit direction per point from backward differences (first point = 0)."""
    prev = np.roll(polyline_xyz, shift=1, axis=0)
    prev[0] = polyline_xyz[0]
    diff = polyline_xyz - prev
    norm = np.clip(np.linalg.norm(diff, axis=-1)[:, None], 1e-6, 1e9)
    return diff / norm


def point_headings(polyline_xy: np.ndarray) -> np.ndarray:
    """Per-point heading theta from forward differences, last repeated
    (reference: data_preprocess.py:46-47 insert-at--1 pattern)."""
    n = polyline_xy.shape[0]
    if n <= 1:
        return np.zeros((n, 1))
    d = polyline_xy[1:] - polyline_xy[:-1]
    theta = wrap_to_pi(np.arctan2(d[:, 1], d[:, 0]))
    theta = np.insert(theta, -1, theta[-1])[:, None]
    return theta


def segment_points_to_polylines(
    points: np.ndarray, dist_thresh: float = 1.0
) -> List[np.ndarray]:
    """Split a flat [N, 8] point soup into polylines at >dist_thresh gaps.

    Also copies the 2nd point's (dir_x, dir_y) onto each polyline's first
    point, as the reference does (map_processing.py:54-58).
    """
    if len(points) == 0:
        return []
    prev = np.roll(points, shift=1, axis=0)
    delta = points[:, 0:2] - prev[:, 0:2]
    delta[0] = 0.0
    break_idxs = (np.linalg.norm(delta, axis=-1) > dist_thresh).nonzero()[0]
    polylines = np.array_split(points, break_idxs, axis=0)
    for polyline in polylines:
        if polyline.shape[0] > 1:
            polyline[0, 3:5] = polyline[1, 3:5]
    return [p for p in polylines if p.shape[0] > 0]


def generate_batch_polylines_from_map(
    polylines: np.ndarray,
    point_sampled_interval: int = 1,
    vector_break_dist_thresh: float = 1.0,
    num_points_each_polyline: int = 100,
) -> Tuple[np.ndarray, np.ndarray]:
    """[N, D] point soup -> ([P, L, D+1] features with valid col, [P, L] mask)."""
    point_dim = polylines.shape[-1]
    sampled = polylines[::point_sampled_interval]
    pieces = segment_points_to_polylines(sampled, vector_break_dist_thresh)

    L = num_points_each_polyline
    feats, masks = [], []
    for piece in pieces:
        for idx in range(0, len(piece), L):
            chunk = piece[idx : idx + L]
            buf = np.zeros((L, point_dim), dtype=np.float32)
            valid = np.zeros((L,), dtype=np.float32)
            mask = np.zeros((L,), dtype=bool)
            buf[: len(chunk)] = chunk
            valid[: len(chunk)] = 1.0
            mask[: len(chunk)] = True
            feats.append(np.concatenate([buf, valid[:, None]], axis=-1))
            masks.append(mask)

    if not feats:
        return np.zeros((0, L, point_dim + 1), np.float32), np.zeros((0, L), bool)
    return np.stack(feats), np.stack(masks)


def dxdy_normalization(
    polylines: np.ndarray, feature_max: float = 0.99
) -> np.ndarray:
    """MinMax-scale columns 3:5 (dx, dy) to [0, feature_max], fit over all
    rows INCLUDING padding (reference quirk, map_processing.py:218-223)."""
    out = polylines.copy()
    flat = polylines[..., 3:5].reshape(-1, 2)
    mins = flat.min(axis=0)
    maxs = flat.max(axis=0)
    span = np.where(maxs > mins, maxs - mins, 1.0)
    scale = np.where(maxs > mins, feature_max / span, 0.0)
    out[..., 3:5] = (polylines[..., 3:5] - mins) * scale
    return out


def transform_scenario(polylines: np.ndarray, ego_position: np.ndarray) -> np.ndarray:
    """Ego-translate xy (rotation intentionally absent, matching the
    reference where it is commented out, map_processing.py:255-277)."""
    out = polylines.copy()
    out[..., 0:2] = out[..., 0:2] - np.asarray(ego_position)[None, :]
    return out


def pad_polylines(
    feats: np.ndarray, masks: np.ndarray, max_polylines: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate the polyline axis to a fixed budget for jit."""
    P, L, D = feats.shape if feats.size else (0, masks.shape[1] if masks.size else 100, 9)
    out_f = np.zeros((max_polylines, L, D), np.float32)
    out_m = np.zeros((max_polylines, L), bool)
    k = min(P, max_polylines)
    if k:
        out_f[:k] = feats[:k]
        out_m[:k] = masks[:k]
    return out_f, out_m


def filter_points_by_distance(
    points: np.ndarray, center: np.ndarray, thresh_dist: float = 100.0
) -> np.ndarray:
    """Drop points farther than thresh_dist from center
    (reference: map_processing.py:6-29, applied per point)."""
    d = np.linalg.norm(points[:, 0:2] - np.asarray(center)[None, :], axis=-1)
    return points[d <= thresh_dist]

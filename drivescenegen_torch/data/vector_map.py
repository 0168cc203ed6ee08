"""The port's copy of drivescenegen_tpu/data/vector_map.py.

Vector-map tensor representation — the reference's alternative
"vector tensor" path (reference: utils/datasets/vector_normalization.py).

Capabilities:
- select FoV-filtered centerline polylines of desired types
  (generate_desired_type_polylines_list :27-92)
- cut polylines at free interior endpoints so junctions split cleanly
  (cut_polyline_for_end_point :94-197)
- stitch root->leaf traffic paths via DFS over endpoint adjacency
  (create_path_from_polylines + depth_first_search :242-313)
- deduplicate points into a vertex/edge graph (polylines_list_to_graph :315-400)
- interpolate each path to a fixed column count and pad to a fixed
  (rows, cols, 8) tensor + mask (polyline_list_interpolation :404-496,
  vector_to_same_size_tensor :499-586)

Internals are vectorized numpy (endpoint adjacency via cdist-style
broadcasting instead of the reference's O(N^2) Python loops).
"""

from __future__ import annotations

from collections import defaultdict
from typing import List, Tuple

import numpy as np

from drivescenegen_torch.ops.map_processing import segment_points_to_polylines


def select_type_polylines(
    all_points: np.ndarray,
    desired_types=(2,),
    filtering: bool = False,
    filter_distance: float = 40.0,
    break_dist_thresh: float = 1.0,
) -> Tuple[List[np.ndarray], bool]:
    """Split the point soup and keep polylines of the desired global types,
    optionally dropping points outside the square FoV."""
    pieces = segment_points_to_polylines(all_points, break_dist_thresh)
    selected = []
    for piece in pieces:
        if len(piece) == 0 or piece[0, 6] not in desired_types:
            continue
        if filtering:
            keep = (np.abs(piece[:, 0]) <= filter_distance) & (
                np.abs(piece[:, 1]) <= filter_distance
            )
            piece = piece[keep]
            if piece.shape[0] == 0:
                continue
        selected.append(piece)
    too_less = len(selected) == 0
    return selected, too_less


def cut_polylines_at_free_endpoints(
    polylines: List[np.ndarray], filter_distance: float = 40.0,
    edge_tol: float = 1.0, attach_dist: float = 1.5, connect_dist: float = 2.0,
) -> List[np.ndarray]:
    """For every polyline endpoint that is neither at the map edge nor
    continued by another polyline, split whichever other polyline passes
    within attach_dist of it — so merging lanes become separate segments
    ending at the junction (reference cut_polyline_for_end_point)."""
    if not polylines:
        return polylines
    split_at: dict = defaultdict(list)

    starts = np.array([p[0, :2] for p in polylines])
    ends = np.array([p[-1, :2] for p in polylines])

    def at_edge(pt) -> bool:
        return (
            abs(abs(pt[0]) - filter_distance) <= edge_tol
            or abs(abs(pt[1]) - filter_distance) <= edge_tol
        )

    for k, poly in enumerate(polylines):
        for endpoint_idx, counterparts in ((0, ends), (-1, starts)):
            pt = poly[endpoint_idx, :2]
            if at_edge(pt):
                continue
            # Continued by another polyline's opposite endpoint?
            d = np.linalg.norm(counterparts - pt[None, :], axis=1)
            d[k] = np.inf
            if (d < connect_dist).any():
                continue
            # Free interior endpoint: split the closest passing polyline.
            for j, other in enumerate(polylines):
                if j == k or len(other) < 4:
                    continue
                dd = np.linalg.norm(other[:, :2] - pt[None, :], axis=1)
                order = np.argsort(dd)
                if dd[order[0]] > attach_dist:
                    continue
                idx = int(order[0])
                if 3 < idx < len(other) - 3:
                    split_at[j].append(idx)
                break

    if not split_at:
        return polylines
    out = []
    for j, poly in enumerate(polylines):
        if j in split_at:
            pieces = np.split(poly, sorted(set(split_at[j])), axis=0)
            out.extend(p for p in pieces if len(p) >= 3)
        else:
            out.append(poly)
    return out


def build_paths_root_to_leaf(
    polylines: List[np.ndarray], filter_distance: float = 40.0,
    edge_tol: float = 0.5, join_dist: float = 0.5,
) -> List[np.ndarray]:
    """DFS from edge-starting (root) polylines to edge-ending (leaf)
    polylines, concatenating each root->leaf chain
    (reference create_path_from_polylines :242-313)."""
    if not polylines:
        return []

    def at_edge(pt) -> bool:
        return (
            abs(abs(pt[0]) - filter_distance) < edge_tol
            or abs(abs(pt[1]) - filter_distance) < edge_tol
        )

    roots = [k for k, p in enumerate(polylines) if at_edge(p[0, :2])]
    leaves = {k for k, p in enumerate(polylines) if at_edge(p[-1, :2])}

    starts = np.array([p[0, :2] for p in polylines])
    # successors[k]: polylines whose start coincides with k's end.
    successors = {}
    for k, poly in enumerate(polylines):
        d = np.linalg.norm(starts - poly[-1, :2][None, :], axis=1)
        successors[k] = [j for j in np.nonzero(d <= join_dist)[0] if j != k]

    final_paths_keys: List[list] = []
    visited = [False] * len(polylines)

    def dfs(k: int, path: list):
        visited[k] = True
        path.append(k)
        if k in leaves:
            final_paths_keys.append(path.copy())
        else:
            for j in successors[k]:
                if not visited[j]:
                    dfs(j, path)
        visited[k] = False
        path.pop()

    for root in roots:
        dfs(root, [])

    return [np.concatenate([polylines[i] for i in keys], axis=0)
            for keys in final_paths_keys]


def polylines_to_point_graph(polylines: List[np.ndarray]):
    """Deduplicated vertex dict + per-polyline key arrays
    (reference polylines_list_to_graph :315-400). Returns
    [vertices: {key: point}, edges: [np.ndarray of keys]]."""
    points: dict = {}
    polys_keys = []
    pos_to_key: dict = {}
    for poly_i, poly in enumerate(polylines):
        keys = []
        for ptr_i, row in enumerate(poly):
            pos = (float(row[0]), float(row[1]))
            if pos in pos_to_key:
                keys.append(pos_to_key[pos])
            else:
                key = f"{poly_i}_{ptr_i}"
                pos_to_key[pos] = key
                points[key] = row
                keys.append(key)
        polys_keys.append(np.array(keys))
    return [points, polys_keys]


def interpolate_polylines(
    polylines: List[np.ndarray], n_points: int = 128
) -> List[np.ndarray]:
    """Resample each path to n_points via normalized-arc-length linear
    interpolation of xyz and dxdydz separately (reference
    polyline_list_interpolation :404-496); drops paths shorter than 3."""
    out = []
    for poly in polylines:
        if len(poly) < 3:
            continue
        s_xyz = np.concatenate(
            [[0.0], np.cumsum(np.linalg.norm(np.diff(poly[:, 0:3], axis=0), axis=1))]
        )
        s_dir = np.concatenate(
            [[0.0], np.cumsum(np.linalg.norm(np.diff(poly[:, 3:6], axis=0), axis=1))]
        )
        if s_xyz[-1] == 0:
            continue
        s_xyz = s_xyz / s_xyz[-1]
        s_dir = s_dir / s_dir[-1] if s_dir[-1] > 0 else np.linspace(0, 1, len(poly))

        t = np.linspace(0.0, 1.0, n_points)
        xyz = np.stack(
            [np.interp(t, s_xyz, poly[:, c]) for c in range(3)], axis=1
        )
        dxyz = np.stack(
            [np.interp(t, s_dir, poly[:, 3 + c]) for c in range(3)], axis=1
        )
        ptype = np.full((n_points, 1), poly[0, 6])
        out.append(np.concatenate([xyz, dxyz, ptype], axis=1))
    return out


def vector_to_same_size_tensor(
    scenario_info: dict,
    des_column_size: int = 256,
    des_row_size: int = 256,
    map_range: float = 100.0,
    pad_value: float = 0.2,
) -> Tuple[np.ndarray, bool]:
    """Scenario dict -> fixed (rows, cols, 8) float array
    [x, y, z, dx, dy, dz, type, mask] + too_less_polylines flag
    (reference vector_to_same_size_tensor :499-586)."""
    lanes = scenario_info["lane"]
    if not lanes:
        return np.zeros((des_row_size, des_column_size, 8), np.float32), True
    all_points = np.vstack([np.asarray(v)[:, :7] for v in lanes.values()])
    if all_points.shape[1] == 7:
        all_points = np.concatenate(
            [all_points, np.zeros((len(all_points), 1))], axis=1
        )
    sdc = scenario_info["sdc_track_index"]
    ego = np.asarray(scenario_info["tracks_info"]["trajs"])[sdc, 10, :2]
    all_points = all_points.copy()
    all_points[:, :2] -= ego

    selected, too_less = select_type_polylines(
        all_points, (2,), filtering=True, filter_distance=map_range
    )
    if too_less:
        return np.zeros((des_row_size, des_column_size, 8), np.float32), True

    selected = cut_polylines_at_free_endpoints(selected, map_range)
    paths = build_paths_root_to_leaf(selected, map_range)
    if not paths:
        paths = selected
    interpolated = interpolate_polylines(paths, des_column_size)
    if not interpolated:
        return np.zeros((des_row_size, des_column_size, 8), np.float32), True

    interpolated = interpolated[:des_row_size]
    n = len(interpolated)
    feats = np.full((des_row_size, des_column_size, 7), pad_value, np.float32)
    feats[:n] = np.stack(interpolated)
    mask = np.zeros((des_row_size, des_column_size, 1), np.float32)
    mask[:n] = 1.0
    return np.concatenate([feats, mask], axis=-1), False


def tensor_back_to_list(tensor: np.ndarray) -> Tuple[List[np.ndarray], np.ndarray]:
    """Inverse of vector_to_same_size_tensor (reference :588-596)."""
    masks = tensor[:, :, -1].astype(bool)
    polylines = [np.asarray(tensor[i, :, :7]) for i in range(tensor.shape[0])]
    return polylines, masks

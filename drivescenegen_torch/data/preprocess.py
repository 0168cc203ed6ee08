"""The port's copy of drivescenegen_tpu/data/preprocess.py.

Stage-0 ingestion: Waymo Motion TFRecords -> per-scenario dict artifacts.

Mirrors the reference's DataProcess (scripts/data_preprocess.py:18-197):
per map feature builds an [N, 8] polyline array
[x, y, z, dir_x, dir_y, dir_z, global_type, theta]; per track an [T, 11]
trajectory [cx, cy, cz, l, w, h, heading, vx, vy, valid, type]; dumps one
dict per scenario keyed exactly like the reference pickles so downstream
stages (and the reference's own stage-1) are interchangeable.

Vectorized decode: repeated proto fields are pulled in bulk per feature
rather than per point, and dir/theta are computed with numpy ops
(the reference's per-point Python loop is the ingestion hot spot,
SURVEY.md §3.1).
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterable, Iterator, Optional

import numpy as np

from drivescenegen_torch.data import tfrecord
from drivescenegen_torch.data.waymo_types import (
    lane_type,
    object_type,
    polyline_type,
    road_edge_type,
    road_line_type,
)
from drivescenegen_torch.ops.map_processing import get_polyline_dir, point_headings, wrap_to_pi


def _points_to_array(points, global_type: float) -> np.ndarray:
    """repeated MapPoint -> [N, 8] feature rows."""
    n = len(points)
    if n == 0:
        return np.zeros((0, 8), np.float32)
    xyz = np.empty((n, 3), np.float64)
    for i, p in enumerate(points):
        xyz[i, 0] = p.x
        xyz[i, 1] = p.y
        xyz[i, 2] = p.z
    dirs = get_polyline_dir(xyz)
    theta = point_headings(xyz[:, 0:2])
    types = np.full((n, 1), global_type)
    return np.concatenate([xyz, dirs, types, theta], axis=1).astype(np.float32)


def decode_map_features(map_features) -> Dict:
    """Proto map features -> the reference's per-category polyline dicts."""
    out = {
        "lane": {},
        "road_polylines": {},
        "crosswalk": {},
        "speed_bump": {},
        "drive_way": {},
        "stop_sign": {},
        "lanes_info": {},
        "all_polylines": [],
    }
    for feat in map_features:
        which = feat.WhichOneof("feature_data")
        fid = feat.id
        if which == "lane":
            gtype = polyline_type[lane_type[feat.lane.type]]
            arr = _points_to_array(feat.lane.polyline, gtype)
            out["lane"][fid] = arr
            out["lanes_info"][fid] = {
                "speed_limit_mph": feat.lane.speed_limit_mph,
                "type": int(feat.lane.type),
                "entry_lanes": list(feat.lane.entry_lanes),
                "exit_lanes": list(feat.lane.exit_lanes),
                "interpolating": bool(feat.lane.interpolating),
            }
        elif which == "road_line":
            gtype = polyline_type[road_line_type[feat.road_line.type]]
            arr = _points_to_array(feat.road_line.polyline, gtype)
            out["road_polylines"][fid] = arr
        elif which == "road_edge":
            gtype = polyline_type[road_edge_type[feat.road_edge.type]]
            arr = _points_to_array(feat.road_edge.polyline, gtype)
            out["road_polylines"][fid] = arr
        elif which == "stop_sign":
            p = feat.stop_sign.position
            arr = np.array(
                [[p.x, p.y, p.z, 0, 0, 0, polyline_type["TYPE_STOP_SIGN"], 0]],
                np.float32,
            )
            out["stop_sign"][fid] = arr
        elif which == "crosswalk":
            arr = _points_to_array(feat.crosswalk.polygon, polyline_type["TYPE_CROSSWALK"])
            out["crosswalk"][fid] = arr
        elif which == "speed_bump":
            arr = _points_to_array(feat.speed_bump.polygon, polyline_type["TYPE_SPEED_BUMP"])
            out["speed_bump"][fid] = arr
        elif which == "driveway":
            arr = _points_to_array(feat.driveway.polygon, polyline_type["TYPE_DRIVEWAY"])
            out["drive_way"][fid] = arr
        else:
            continue
        out["all_polylines"].append(arr)

    if out["all_polylines"]:
        out["all_polylines"] = np.concatenate(out["all_polylines"], axis=0)
    else:
        out["all_polylines"] = np.zeros((0, 8), np.float32)
    return out


def decode_tracks(tracks) -> Dict:
    """Proto tracks -> track_infos dict with trajs [A, T, 11]
    (reference: data_preprocess.py:140-155)."""
    infos = {"object_id": [], "object_type": [], "trajs": [], "track_index": []}
    for track_index, track in enumerate(tracks):
        T = len(track.states)
        traj = np.empty((T, 11), np.float32)
        for i, s in enumerate(track.states):
            traj[i] = (
                s.center_x, s.center_y, s.center_z, s.length, s.width, s.height,
                wrap_to_pi(s.heading), s.velocity_x, s.velocity_y,
                float(s.valid), float(track.object_type),
            )
        infos["object_id"].append(track.id)
        infos["object_type"].append(object_type.get(track.object_type, "TYPE_OTHER"))
        infos["trajs"].append(traj)
        infos["track_index"].append(track_index)
    infos["trajs"] = (
        np.stack(infos["trajs"], axis=0)
        if infos["trajs"]
        else np.zeros((0, 91, 11), np.float32)
    )
    return infos


def decode_scenario(data: bytes) -> Dict:
    """Serialized Scenario proto -> reference-format scenario dict."""
    from drivescenegen_torch.data.protos import dsg_scenario_pb2

    scenario = dsg_scenario_pb2.Scenario()
    scenario.ParseFromString(data)

    map_info = decode_map_features(scenario.map_features)
    track_infos = decode_tracks(scenario.tracks)

    return {
        "scenario_id": scenario.scenario_id,
        "tracks_info": track_infos,
        "lanes_info": map_info["lanes_info"],
        "lane": map_info["lane"],
        "crosswalk": map_info["crosswalk"],
        "speed_bump": map_info["speed_bump"],
        "drive_way": map_info["drive_way"],
        "stop_sign": map_info["stop_sign"],
        "road_polylines": map_info["road_polylines"],
        "all_polylines": map_info["all_polylines"],
        "sdc_track_index": scenario.sdc_track_index,
        "predict_list": [p.track_index for p in scenario.tracks_to_predict],
        "current_time_index": scenario.current_time_index,
    }


def process_tfrecord_file(
    path: str, save_path: str, backend: str = "auto"
) -> list:
    """Decode every scenario in one TFRecord shard to sample_<id>.pkl files."""
    ids = []
    for data in tfrecord.read_tfrecord(path, backend=backend):
        info = decode_scenario(data)
        sid = info["scenario_id"]
        ids.append(sid)
        with open(os.path.join(save_path, f"sample_{sid}.pkl"), "wb") as f:
            pickle.dump(info, f)
    return ids


def process_files(
    data_files: list, save_path: str, n_workers: int = 8, backend: str = "auto"
) -> list:
    """Parallel shard processing (reference: data_preprocess.py:218-224)."""
    os.makedirs(save_path, exist_ok=True)
    if n_workers <= 1 or len(data_files) <= 1:
        ids = []
        for f in data_files:
            ids.extend(process_tfrecord_file(f, save_path, backend))
        return ids

    import multiprocessing as mp

    # spawn (not fork): callers (tests, fused scripts) may already hold CUDA
    # or TF threads whose locks a forked child would inherit mid-acquire.
    with mp.get_context("spawn").Pool(min(n_workers, len(data_files))) as pool:
        results = pool.starmap(
            process_tfrecord_file, [(f, save_path, backend) for f in data_files]
        )
    return [sid for sub in results for sid in sub]

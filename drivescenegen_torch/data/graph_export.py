"""The port's copy of drivescenegen_tpu/data/graph_export.py.

GT graph/track exporter (reference: utils/datasets/waymo/
data_to_graph.py): one nx.Graph edge per GT lane centerline (endpoints as
nodes with yaw attributes, 'dist' = arc length), plus track pickles — the
ground-truth side consumed by the map metrics
(scripts/compute_map_metrics.py:31-39)."""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional

import networkx as nx
import numpy as np

from drivescenegen_torch.data import tfrecord
from drivescenegen_torch.data.preprocess import decode_scenario


def build_graph(centerlines: Dict[int, np.ndarray]) -> nx.Graph:
    """Lane centerline dict -> graph with one edge per lane
    (data_to_graph.py:162-198)."""
    graph = nx.Graph()
    edges, nodes = [], []
    for centerline in centerlines.values():
        if centerline.shape[0] <= 1:
            continue
        dx = np.diff(centerline[:, 0])
        dy = np.diff(centerline[:, 1])
        s = np.cumsum(np.hypot(dx, dy))
        path = list(zip(centerline.T[0], centerline.T[1]))
        n1, n2 = path[0], path[-1]
        n1_yaw = np.arctan2(dy[0], dx[0])
        n2_yaw = np.arctan2(dy[-1], dx[-1])
        edges.append((n1, n2, {"path": path, "dist": s[-1]}))
        nodes.append((n1, {"yaw": n1_yaw, "type": "exit"}))
        nodes.append((n2, {"yaw": n2_yaw, "type": "exit"}))
    graph.add_edges_from(edges)
    graph.add_nodes_from(nodes)
    return graph


def export_scenario(info: dict, save_path: str, scenario_id,
                    save_graph: bool = True, save_track: bool = True,
                    save_scenario: bool = True) -> None:
    """Write graph/<id>_graph.pickle, track/<id>_track.pickle and
    scenario/<id>.pkl for one decoded scenario."""
    if save_graph:
        graph = build_graph(info["lane"])
        os.makedirs(os.path.join(save_path, "graph"), exist_ok=True)
        with open(os.path.join(save_path, "graph", f"{scenario_id}_graph.pickle"), "wb") as f:
            pickle.dump(graph, f)
    if save_track:
        os.makedirs(os.path.join(save_path, "track"), exist_ok=True)
        with open(os.path.join(save_path, "track", f"{scenario_id}_track.pickle"), "wb") as f:
            pickle.dump(info["tracks_info"], f)
    if save_scenario:
        out = {
            "scenario_id": scenario_id,
            "sdc_track_index": info["sdc_track_index"],
            "tracks_info": info["tracks_info"],
            "predict_list": info["predict_list"],
            "lane": list(info["lane"].values()),
            "all_agent": np.asarray(info["tracks_info"]["trajs"])[:, :, :10],
        }
        os.makedirs(os.path.join(save_path, "scenario"), exist_ok=True)
        with open(os.path.join(save_path, "scenario", f"{scenario_id}.pkl"), "wb") as f:
            pickle.dump(out, f)


def process_tfrecords(data_files: list, save_path: str, max_scenarios: int = 5000,
                      backend: str = "auto") -> int:
    """Export GT artifacts from TFRecord shards, capped at max_scenarios
    (the reference caps at 5000, data_to_graph.py:206-207)."""
    count = 0
    for path in data_files:
        for data in tfrecord.read_tfrecord(path, backend=backend):
            if count >= max_scenarios:
                return count
            info = decode_scenario(data)
            export_scenario(info, save_path, count)
            count += 1
    return count

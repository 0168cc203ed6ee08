"""The port's copy of drivescenegen_tpu/vectorize/graph_utils.py.

Graph/geometry helpers for the vectorization stage
(reference: vectorization/utils/graph_utils.py). Pixel-graph convention:
nodes are (x, y) = (col, row) tuples; paths are lists of point tuples —
(x, y) for raw pixel paths, (x, y, yaw, k, s) for fitted curves."""

from __future__ import annotations

import math
import random
from typing import List, Sequence, Tuple

import networkx as nx
import numpy as np


def distance(p1, p2) -> float:
    return math.hypot(p1[0] - p2[0], p1[1] - p2[1])


def normalize_angle_rad(angle: float) -> float:
    """Normalize to (-pi, pi]."""
    while angle > np.pi:
        angle -= 2 * np.pi
    while angle <= -np.pi:
        angle += 2 * np.pi
    return angle


def normalize_dx_dy(dx: float, dy: float) -> Tuple[float, float]:
    norm = math.hypot(dx, dy)
    if norm == 0:
        return 0.0, 0.0
    return dx / norm, dy / norm


def calc_path_yaw_diff(yaw1: float, yaw2: float) -> float:
    """Angular distance between yaw1 and the OPPOSITE of yaw2 — small when
    two edges leaving a node point away from each other (i.e. they form a
    through-path), graph_utils.py:39-40."""
    return abs(normalize_angle_rad(yaw1 - yaw2 - np.pi))


def correct_path_direction(path: Sequence, n1, n2) -> list:
    """Return path oriented from n1 to n2. Reversing a fitted 5-col curve
    flips yaw by pi and reverses (x, y, yaw, k) but keeps the s column in
    its original ascending order (reference quirk, graph_utils.py:47-54)."""
    path = list(path)
    if not path:
        return path
    if distance(n1, path[0]) <= distance(n2, path[0]):
        return path
    arr = np.array(path, dtype=float).T
    if arr.shape[0] > 2:
        xs = arr[0, ::-1]
        ys = arr[1, ::-1]
        yaws = arr[2, ::-1] + np.pi
        ks = arr[-2, ::-1]
        s = arr[-1, :]
        return list(zip(xs, ys, yaws, ks, s))
    return path[::-1]


def join_paths(path1: list, path2: list) -> list:
    if len(path2) > 0:
        path2 = path2[1:]
        return path1 + [(*(pt[:-1]), path1[-1][-1] + pt[-1]) for pt in path2]
    return path1


def estimate_path_yaws(path: Sequence, local_length: int = 10):
    """(front_yaw, front_unit_delta, rear_yaw, rear_unit_delta) from the
    first/last `local_length` points (graph_utils.py:92-107)."""
    arr = np.array(path, dtype=float)
    if arr.shape[0] > local_length:
        front_delta = arr[local_length - 1] - arr[0]
        rear_delta = arr[-1] - arr[-local_length]
    else:
        front_delta = arr[-1] - arr[0]
        rear_delta = front_delta
    front = normalize_dx_dy(front_delta[0], front_delta[1])
    rear = normalize_dx_dy(rear_delta[0], rear_delta[1])
    return (
        math.atan2(front[1], front[0]),
        front,
        math.atan2(rear[1], rear[0]),
        rear,
    )


def connect_small_gaps(graph: nx.Graph, nodes: list, thresh: int = 4) -> nx.Graph:
    """Bridge pairs of terminal nodes closer than thresh by joining their
    dangling edges (graph_utils.py:67-89). Mutates and returns graph."""
    for i, n1 in enumerate(nodes):
        for n2 in nodes[i + 1 :]:
            dist = np.hypot(n1[0] - n2[0], n1[1] - n2[1])
            if dist <= thresh:
                n1_edges = list(graph.edges(n1, keys=True))
                n2_edges = list(graph.edges(n2, keys=True))
                if n1_edges and n2_edges:
                    n1_, n1_neighbour, k1 = n1_edges[0]
                    n2_, n2_neighbour, k2 = n2_edges[0]
                    e1_path = correct_path_direction(
                        graph[n1_][n1_neighbour][k1]["path"], n1_neighbour, n1_
                    )
                    e2_path = correct_path_direction(
                        graph[n2_][n2_neighbour][k2]["path"], n2_, n2_neighbour
                    )
                    new_path = e1_path + e2_path
                    graph.add_edge(
                        n1_neighbour, n2_neighbour, path=new_path, d=len(new_path) - 1
                    )
                    graph.remove_node(n1_)
                    graph.remove_node(n2_)
                    break
    return graph


def estimate_path_front_yaw(path: Sequence, local_length: int = 10):
    """Front yaw/unit-delta only, with the legacy variant's reversed rear
    convention (image_to_vectors_graph.py:96-112)."""
    arr = np.array(path, dtype=float)
    if arr.shape[0] > local_length:
        front_delta = arr[local_length - 1] - arr[0]
    else:
        front_delta = arr[-1] - arr[0]
    front = normalize_dx_dy(front_delta[0], front_delta[1])
    return math.atan2(front[1], front[0]), front


def find_node_directions(graph: nx.Graph, nodes_terminal: list, img01) -> tuple:
    """Classify terminals into inlets/outlets from the SINGLE pixel color at
    the node vs the edge direction (graph_utils.py:110-133; note the raw,
    un-normalized degree difference — a reference quirk kept as-is).
    img01: float (H, W, 3) array in [0, 1]."""
    H, W = np.asarray(img01).shape[:2]
    inlets, outlets = [], []
    for n1 in nodes_terminal:
        edges = list(graph.edges(n1, keys=True))
        if not edges:
            continue
        n1, n2, k = edges[0]
        dx, dy = normalize_dx_dy(n2[0] - n1[0], n2[1] - n1[1])
        node_angle = np.rad2deg(math.atan2(dy, dx))

        x = min(max(int(n1[0]), 0), W - 1)
        y = min(max(int(n1[1]), 0), H - 1)
        r = float(img01[y, x, 0]) * 255.0
        g = float(img01[y, x, 1]) * 255.0
        color_dx, color_dy = normalize_dx_dy(r - 128.0, 128.0 - g)
        color_angle = np.rad2deg(math.atan2(color_dy, color_dx))

        angle_diff = np.fabs(color_angle - node_angle)
        if angle_diff < 90.0:
            inlets.append((n1[0], n1[1], dx, dy, color_dx, color_dy, 1))
        else:
            outlets.append((n1[0], n1[1], -dx, -dy, color_dx, color_dy, 0))

    return np.array(inlets), np.array(outlets)


def get_edges_between_nodes(graph: nx.Graph, n1, n2) -> list:
    return [e for e in graph.edges(n1, keys=True) if e[1] == n2]


def trace_route(graph: nx.Graph, route: list) -> list:
    """Concatenate edge paths along a node route, oriented forward."""
    waypoints: list = []
    for i in range(len(route) - 1):
        edges = get_edges_between_nodes(graph, route[i], route[i + 1])
        n1, n2, k = edges[0]
        points = graph[n1][n2][k]["path"]
        waypoints = waypoints + correct_path_direction(points, n1, n2)
    return waypoints


def downsample_path(path: np.ndarray, ratio: int = 2) -> np.ndarray:
    """Every ratio-th point, last point always kept (graph_utils.py:155-167)."""
    if path.shape[0] > ratio:
        new_path = path[::ratio]
        if path.shape[0] % ratio > ratio / 2:
            new_path = np.append(new_path, [path[-1]], axis=0)
        else:
            new_path = new_path.copy()
            new_path[-1] = path[-1]
        return new_path
    elif path.shape[0] == 0:
        return np.array([])
    else:
        return np.take(path, [1, -1], axis=0)


def random_color() -> str:
    return "#{:02X}{:02X}{:02X}".format(
        random.randint(30, 220), random.randint(30, 220), random.randint(30, 220)
    )


def graph_to_polylines(g: nx.Graph) -> List[np.ndarray]:
    polylines = []
    if isinstance(g, (nx.MultiGraph, nx.MultiDiGraph)):
        for n1, n2, k in g.edges(keys=True):
            polylines.append(np.array(g[n1][n2][k]["path"]))
    else:
        for n1, n2 in g.edges():
            polylines.append(np.array(g[n1][n2]["path"]))
    return polylines


def transform_to_world_frame(
    polyline: np.ndarray, center: Tuple[float, float], scale: float
) -> np.ndarray:
    """Pixel-frame curve [x, y, yaw, k, s] -> world metres: x right, y up
    (y-flip), yaw negated, curvature/arc-length rescaled
    (graph_utils.py:197-204)."""
    polyline = polyline.astype(float).copy()
    polyline[:, 0] = polyline[:, 0] * scale - center[0]
    polyline[:, 1] = center[1] - polyline[:, 1] * scale
    polyline[:, 2] = -polyline[:, 2]
    polyline[:, 3] = polyline[:, 3] / scale
    polyline[:, 4] = polyline[:, 4] * scale
    return polyline


def polylines_to_world_frame(
    polylines: List[np.ndarray], img_shape: Tuple[int, int], map_range: float = 80.0
) -> List[np.ndarray]:
    scale = map_range / img_shape[0]  # m/pixel
    center = (img_shape[0] / 2 * scale, img_shape[1] / 2 * scale)
    return [transform_to_world_frame(p, center, scale) for p in polylines]


def polylines_to_output(polylines: List[np.ndarray]) -> List[np.ndarray]:
    """[x, y, yaw, k, s] curves -> [N, 6] lanes [x, y, z, dx, dy, dz]
    (graph_utils.py:213-233)."""
    lanes = []
    for polyline in polylines:
        dx = np.cos(polyline[:, 2])
        dy = np.sin(polyline[:, 2])
        zeros = np.zeros_like(dx)
        lanes.append(
            np.stack((polyline[:, 0], polyline[:, 1], zeros, dx, dy, zeros), axis=-1)
        )
    return lanes

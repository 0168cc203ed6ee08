"""The port's copy of drivescenegen_tpu/vectorize/graph_legacy.py.

Legacy "GRAPH" vectorizer (reference: vectorization/graph/
image_to_vectors_graph.py, selected via method: "GRAPH" at
scripts/vectorization.py:39-40).

Pipeline: mask -> skeleton graph -> bridge small terminal gaps ->
single-pixel-color inlet/outlet classification -> iterative junction
reduction by yaw voting -> per-edge smoothing (straight line <= 20 px,
cubic polynomial otherwise) -> junction breakdown -> keep only
inlet->outlet edges as an nx.MultiDiGraph.
"""

from __future__ import annotations

import logging
from typing import Optional

import networkx as nx
import numpy as np

from drivescenegen_torch.utils.logging import get_logger
from drivescenegen_torch.vectorize import curves, graph_utils, image_utils, network
from drivescenegen_torch.vectorize.graph_fit import voting_by_yaw_angle

logger = get_logger("graph_legacy", logging.WARNING)


def find_terminal_nodes(graph: nx.Graph) -> list:
    return [(n[0], n[1]) for (n, deg) in graph.degree if deg == 1]


def find_branching_nodes(graph: nx.Graph, nodes_terminal: list) -> list:
    out = []
    for n1 in nodes_terminal:
        _, neighbour, k = list(graph.edges(n1, keys=True))[0]
        out.append(neighbour)
    return out


def reduce_graph(graph: nx.Graph) -> nx.Graph:
    """Iteratively rewire degree>=2 nodes by yaw voting
    (image_to_vectors_graph.py:141-238)."""
    graph_changed = True
    while graph_changed:
        graph_changed = False
        for n0, degree in graph.degree:
            node_type = graph.nodes[n0].get("type", "")
            if degree < 2 or node_type == "branch":
                continue

            yaws, paths, nodes = [], [], []
            for _, n1, k in list(graph.edges(n0, keys=True)):
                e1_path = graph_utils.correct_path_direction(
                    graph[n0][n1][k]["path"], n0, n1
                )
                if e1_path:
                    n0_yaw, _ = graph_utils.estimate_path_front_yaw(e1_path, 10)
                    yaws.append(n0_yaw)
                    paths.append(e1_path)
                    nodes.append(n1)

            votes, connect = voting_by_yaw_angle(yaws)
            branch_ids = [i for i, v in enumerate(votes) if v > 1]
            passer_ids = [i for i in range(len(nodes)) if i not in branch_ids]

            for i in branch_ids:
                n1 = nodes[i]
                path = graph_utils.correct_path_direction(paths[i], n0, n1)
                n0_new = paths[i][1]
                new_path = path[1:]
                graph.add_node(n0_new, type="branch")
                graph.add_edge(n0_new, n1, path=new_path, d=len(new_path) - 1)

                js = [j for j, val in enumerate(connect[i]) if val]
                for j in js:
                    if j in passer_ids:
                        passer_ids.remove(j)
                    n2 = nodes[j]
                    new_path = [n0_new] + graph_utils.correct_path_direction(
                        paths[j], n0, n2
                    )
                    graph.add_edge(n0_new, n2, path=new_path, d=len(new_path) - 1)

            for i in passer_ids:
                n1 = nodes[i]
                js = [(i + j) for j, val in enumerate(connect[i, i:]) if val]
                for j in js:
                    n2 = nodes[j]
                    path1 = graph_utils.correct_path_direction(paths[i], n1, n0)
                    path2 = graph_utils.correct_path_direction(paths[j], n0, n2)
                    graph.add_edge(
                        n1, n2, path=path1 + path2[1:], d=len(path1 + path2[1:]) - 1
                    )

            graph.remove_node(n0)
            graph_changed = True
            break
    return graph


def smoothen_graph_edges(graph: nx.Graph, length_thresh: int = 20, step: int = 1) -> nx.MultiGraph:
    """Fit each edge: straight line if short, cubic polynomial otherwise
    (image_to_vectors_graph.py:241-266)."""
    edges = []
    for n1, n2, k in list(graph.edges(keys=True)):
        path = np.array(
            graph_utils.correct_path_direction(graph[n1][n2][k]["path"], n1, n2)
        )
        if path.shape[0] <= length_thresh:
            curve = curves.fit_straight_line(path[:, 0], path[:, 1], step=step)
        else:
            curve = curves.fit_cubic_polynomial(path[:, 0], path[:, 1], step=step)
        edges.append((n1, n2, {"path": curve, "d": curve[-1][-1]}))

    new_graph = nx.MultiGraph()
    new_graph.add_edges_from(edges)
    nodes = []
    for n, degree in graph.degree:
        nodes.append((n, {"type": "terminal" if degree < 2 else "branch"}))
    new_graph.add_nodes_from(nodes)
    return new_graph


def break_down_graph(graph: nx.Graph) -> nx.Graph:
    """Remove interior nodes joining vote-paired edges; yaw from the fitted
    curve's first row (image_to_vectors_graph.py:269-341)."""
    graph_changed = True
    while graph_changed:
        graph_changed = False
        for n0, degree in graph.degree:
            node_type = graph.nodes[n0].get("type", "")
            if degree < 2 or node_type == "terminal":
                continue

            yaws, paths, nodes = [], [], []
            for _, n1, k in list(graph.edges(n0, keys=True)):
                e1_path = graph_utils.correct_path_direction(
                    graph[n0][n1][k]["path"], n0, n1
                )
                yaws.append(e1_path[0][2])
                paths.append(e1_path)
                nodes.append(n1)

            votes, connect = voting_by_yaw_angle(yaws)
            for i in range(connect.shape[0]):
                n1 = nodes[i]
                js = [(i + j) for j, val in enumerate(connect[i, i:]) if val]
                for j in js:
                    n2 = nodes[j]
                    path1 = graph_utils.correct_path_direction(paths[i], n1, n0)
                    path2 = graph_utils.correct_path_direction(paths[j], n0, n2)
                    new_path = graph_utils.join_paths(path1, path2)
                    graph.add_edge(n1, n2, path=new_path, d=new_path[-1][-1])

            graph.remove_node(n0)
            graph_changed = True
            break
    return graph


def verify_final_graph(graph: nx.Graph, inlets: np.ndarray, outlets: np.ndarray) -> nx.MultiDiGraph:
    """Keep only inlet->outlet edges, oriented with the flow
    (image_to_vectors_graph.py:364-401)."""
    inlets_t = inlets.T.astype(int)
    outlets_t = outlets.T.astype(int)
    inlets_list = list(zip(inlets_t[0], inlets_t[1])) if inlets.size else []
    outlets_list = list(zip(outlets_t[0], outlets_t[1])) if outlets.size else []

    new_graph = nx.MultiDiGraph()
    for n1, n2, k in list(graph.edges(keys=True)):
        e = graph[n1][n2][k]
        if n1 in inlets_list:
            if n2 in outlets_list:
                new_path = graph_utils.correct_path_direction(e["path"], n1, n2)
                new_graph.add_edge(n1, n2, path=new_path, d=new_path[-1][-1])
            else:
                logger.info(f"Invalid path from {n1} to {n2}, both inlets")
        elif n1 in outlets_list:
            if n2 in inlets_list:
                new_path = graph_utils.correct_path_direction(e["path"], n2, n1)
                new_graph.add_edge(n2, n1, path=new_path, d=new_path[-1][-1])
            else:
                logger.info(f"Invalid path from {n1} to {n2}, both outlets")
    return new_graph


def extract_polylines_from_img(
    img01,
    img_gray: Optional[np.ndarray] = None,
    map_range: float = 80.0,
    plot: bool = False,
    save_path: Optional[str] = None,
    skel: Optional[np.ndarray] = None,
):
    """Full legacy pipeline (image_to_vectors_graph.py:404-567). Returns
    (lanes, MultiDiGraph) or [] on failure (reference behavior)."""
    img01 = image_utils.to_float01(img01)
    mask = image_utils.get_lane_mask(img01).T
    if mask.mean() > 0.25:
        logger.warning("lane mask too dense — rejecting as noise")
        return []
    skel_arr, graph = network.extract_network(
        mask.astype(np.uint8), min_distance=4, skel=skel
    )

    if graph.number_of_nodes() < 2 or graph.number_of_edges() < 1:
        logger.warning("Failed to extract graph from image")
        return []
    if graph.number_of_nodes() > 1500:
        logger.warning("degenerate skeleton graph — rejecting")
        return []

    nodes_1_degree = find_terminal_nodes(graph)
    graph = graph_utils.connect_small_gaps(graph, nodes_1_degree, thresh=8)

    nodes_terminal = find_terminal_nodes(graph)
    inlets, outlets = graph_utils.find_node_directions(graph, nodes_terminal, img01)
    if inlets.size == 0 or outlets.size == 0:
        logger.warning("No inlets/outlets found")
        return []

    graph = reduce_graph(graph)
    graph = smoothen_graph_edges(graph, length_thresh=20, step=1)
    graph = break_down_graph(graph)
    graph = verify_final_graph(graph, inlets, outlets)

    polylines = graph_utils.graph_to_polylines(graph)
    polylines_world = graph_utils.polylines_to_world_frame(
        polylines, skel_arr.shape, map_range=map_range
    )
    output = graph_utils.polylines_to_output(polylines_world)
    return output, graph

"""The port's copy of drivescenegen_tpu/vectorize/graph_fit.py.

GRAPH_FIT lane vectorizer — the published method (reference:
vectorization/graph/image_to_polylines.py, selected by
config/vectorization.yaml:7).

Raster -> binary mask -> skeleton graph -> inlet/outlet classification by
decoding the direction colors (R=dx, G=dy) along edges -> cut entry/exit
stubs and long lanes into a directed graph with cubic-spline-fit
centerlines -> rewire remaining junctions (yaw voting) -> connect
intersection entries to exits with Bezier curves validated by Dijkstra
routes and angle gates -> world-frame [N, 6] lane polylines.

The pixel-level work (mask, skeletonization) runs as PyTorch ops
(ops/morphology.py), on the card in the CLIs' batched pass; the irregular
graph rewiring runs on the host, matching SURVEY.md §7's split.
"""

from __future__ import annotations

import copy
import logging
from typing import List, Optional, Tuple

import networkx as nx
import numpy as np

from drivescenegen_torch.utils.logging import get_logger
from drivescenegen_torch.vectorize import curves, graph_utils, image_utils, network

logger = get_logger("graph_fit", logging.WARNING)


def image_to_graph(img01: np.ndarray, min_distance: int = 4,
                   skel: Optional[np.ndarray] = None,
                   mask: Optional[np.ndarray] = None,
                   despeckle_px: int = 15):
    """Color raster (float01 HxWx3) -> (skeleton, MultiGraph). The mask is
    transposed so nodes are (x, y) = (col, row), matching the reference
    (image_to_polylines.py:18-21; white-pixel mask there, histogram mask
    here via get_lane_mask — identical once get_gray_image is applied).
    `mask` short-circuits the histogram pass when the caller already has it
    (HxW, un-transposed)."""
    if mask is None:
        mask = image_utils.get_lane_mask(img01)
    return network.extract_network(
        mask.T.astype(np.uint8), min_distance, skel=skel,
        despeckle_px=despeckle_px,
    )


def determine_node_direction(graph: nx.Graph, img01: np.ndarray, n1, n2):
    """Classify the edge (n1, n2) as inlet (color flow agrees with the
    n1->n2 geometric yaw) or outlet, returning posed node tuples
    (x, y, yaw, dx, dy, direction) (image_to_polylines.py:24-57)."""
    # First parallel edge; after rewiring passes the surviving key need not
    # be 0, so take the lowest present key rather than index [0] blindly.
    e = graph[n1][n2][min(graph[n1][n2])]
    path = graph_utils.correct_path_direction(e["path"], n1, n2)
    n1_yaw, n1_delta, n2_yaw, n2_delta = graph_utils.estimate_path_yaws(
        path, local_length=20
    )

    # Sum of unit color-flow vectors along the path (vectorized equivalent
    # of per-pixel _pixel_color + normalize_dx_dy).
    H, W = img01.shape[:2]
    pts = np.asarray(e["path"], np.int64)
    xs = np.clip(pts[:, 0], 0, W - 1)
    ys = np.clip(pts[:, 1], 0, H - 1)
    dxs = img01[ys, xs, 0] * 255.0 - 128.0
    dys = 128.0 - img01[ys, xs, 1] * 255.0
    norms = np.hypot(dxs, dys)
    nz = norms > 0
    dx_sum = float((dxs[nz] / norms[nz]).sum())
    dy_sum = float((dys[nz] / norms[nz]).sum())
    color_angle = np.arctan2(dy_sum, dx_sum)

    angle_diff = np.fabs(
        np.rad2deg(graph_utils.normalize_angle_rad(color_angle - n1_yaw))
    )

    if angle_diff < 90.0:
        direction = 1  # inlet
        n1_dx, n1_dy = graph_utils.normalize_dx_dy(*n1_delta)
        n2_dx, n2_dy = graph_utils.normalize_dx_dy(*n2_delta)
    else:
        direction = 0  # outlet
        n1_dx, n1_dy = graph_utils.normalize_dx_dy(-n1_delta[0], -n1_delta[1])
        n2_dx, n2_dy = graph_utils.normalize_dx_dy(-n2_delta[0], -n2_delta[1])
        n1_yaw = graph_utils.normalize_angle_rad(n1_yaw + np.pi)
        n2_yaw = graph_utils.normalize_angle_rad(n2_yaw + np.pi)

    start = (n1[0], n1[1], n1_yaw, n1_dx, n1_dy, direction)
    end = (n2[0], n2[1], n2_yaw, n2_dx, n2_dy, direction)
    return start, end


def find_key_nodes(graph: nx.Graph, img01: np.ndarray):
    """Terminal (degree-1) nodes with flow direction, plus the branching
    nodes they attach to (image_to_polylines.py:60-73)."""
    nodes_1_degree = [(n[0], n[1]) for (n, deg) in graph.degree if deg == 1]

    terminal_nodes = []
    branching_nodes = []
    for n1 in nodes_1_degree:
        _, n2, k = list(graph.edges(n1, keys=True))[0]
        terminal, branch = determine_node_direction(graph, img01, n1, n2)
        terminal_nodes.append(terminal)
        if graph.degree(n2) > 1:
            branching_nodes.append(branch)

    return np.array(terminal_nodes), np.array(branching_nodes)


def voting_by_yaw_angle(yaws) -> Tuple[np.ndarray, np.ndarray]:
    """Pair each edge at a node with its best opposing-yaw match
    (image_to_polylines.py:138-161)."""
    votes = np.zeros(len(yaws), dtype=int)
    connect = np.zeros((len(yaws), len(yaws)), dtype=bool)
    for i, yaw1 in enumerate(yaws):
        diffs = [
            2 * np.pi if i == j else graph_utils.calc_path_yaw_diff(yaw1, yaw2)
            for j, yaw2 in enumerate(yaws)
        ]
        min_id = int(np.argmin(diffs))
        votes[min_id] += 1
        connect[i, min_id] = True
        connect[min_id, i] = True
    return votes, connect


def curve_is_valid(curve: np.ndarray, route: list, dist_tol: float = 1.0,
                   min_rate: float = 0.5) -> bool:
    """Curve accepted if >= min_rate of route waypoints lie within dist_tol
    (image_to_polylines.py:76-87)."""
    if len(route) == 0:
        return False
    inliers = 0
    for node in route:
        d = np.hypot(curve[:, 0] - node[0], curve[:, 1] - node[1])
        if np.min(d) <= dist_tol:
            inliers += 1
    return inliers / len(route) >= min_rate


def route_is_valid(route: list, graph: nx.Graph) -> bool:
    """Every interior node of the route must pair its incoming/outgoing
    edges in the yaw vote (image_to_polylines.py:90-115)."""
    for i in range(len(route) - 2):
        nl, n, nr = route[i], route[i + 1], route[i + 2]
        yaws = []
        nodes = []
        for n0, n1, k in graph.edges(n, keys=True):
            e = graph[n0][n1][k]
            e_path = graph_utils.correct_path_direction(e["path"], n0, n1)
            if e_path:
                n0_yaw, _, _, _ = graph_utils.estimate_path_yaws(e_path, 10)
                yaws.append(n0_yaw)
                nodes.append(n1)
        if nl not in nodes or nr not in nodes:
            # A neighbor's edge path was empty (skipped above) — the pairing
            # vote can't certify this route.
            return False
        nl_id = nodes.index(nl)
        nr_id = nodes.index(nr)
        votes, connect = voting_by_yaw_angle(yaws)
        if not connect[nl_id, nr_id]:
            return False
        if graph_utils.calc_path_yaw_diff(yaws[nl_id], yaws[nr_id]) >= np.pi / 4:
            return False
    return True


def find_paths_among_terminals(graph: nx.Graph, inlets: np.ndarray,
                               outlets: np.ndarray, thresh: int = 4):
    """All valid inlet->outlet Dijkstra routes (image_to_polylines.py:118-135;
    kept for API parity — the orchestrator uses connect_intersections)."""
    inlets_t = inlets.T.astype(int)
    outlets_t = outlets.T.astype(int)
    inlets = list(zip(inlets_t[0], inlets_t[1]))
    outlets = list(zip(outlets_t[0], outlets_t[1]))

    routes, waypoints_all = [], []
    for n1 in inlets:
        for n2 in outlets:
            if nx.has_path(graph, source=n1, target=n2):
                route = nx.shortest_path(graph, n1, n2, weight="d", method="dijkstra")
                if route_is_valid(route, graph):
                    waypoints_all.append(graph_utils.trace_route(graph, route))
                    routes.append(route)
    return routes, waypoints_all


def simplify_graph(graph: nx.Graph) -> nx.Graph:
    """Iteratively rewire every degree>=2 node: branch edges (vote > 1) are
    re-rooted one pixel in; passer edges are joined through
    (image_to_polylines.py:164-264). Mutates and returns graph."""
    graph_changed = True
    while graph_changed:
        graph_changed = False
        for n0, degree in graph.degree:
            node_type = graph.nodes[n0].get("type", "")
            if degree < 2 or node_type == "branch":
                continue

            yaws, paths, nodes = [], [], []
            for _, n1, k in list(graph.edges(n0, keys=True)):
                e1 = graph[n0][n1][k]
                e1_path = graph_utils.correct_path_direction(e1["path"], n0, n1)
                if len(e1_path) > 0:
                    n0_yaw, _, _, _ = graph_utils.estimate_path_yaws(e1_path, 100)
                    yaws.append(n0_yaw)
                    paths.append(e1_path)
                    nodes.append(n1)

            votes, connect = voting_by_yaw_angle(yaws)
            branch_ids = [i for i, v in enumerate(votes) if v > 1]
            passer_ids = [i for i in range(len(nodes)) if i not in branch_ids]

            for i in branch_ids:
                n1 = nodes[i]
                path = graph_utils.correct_path_direction(paths[i], n0, n1)
                n0_new_np = path[1]
                n0_new = (n0_new_np[0], n0_new_np[1])
                new_path = path[1:]
                graph.add_node(n0_new, type="branch")
                graph.add_edge(n0_new, n1, path=new_path, d=len(new_path) - 1)

                js = [j for j, val in enumerate(connect[i]) if val]
                for j in js:
                    if j in passer_ids:
                        passer_ids.remove(j)
                    n2 = nodes[j]
                    new_path = [n0_new_np] + graph_utils.correct_path_direction(
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
                    new_path = path1 + path2[1:]
                    graph.add_edge(n1, n2, path=new_path, d=len(new_path) - 1)

            graph.remove_node(n0)
            graph_changed = True
            break
    return graph


def break_down_graph(graph: nx.Graph) -> nx.Graph:
    """Remove remaining interior nodes, joining their vote-paired edges
    (image_to_polylines.py:267-339)."""
    graph_changed = True
    while graph_changed:
        graph_changed = False
        for n0, degree in graph.degree:
            node_type = graph.nodes[n0].get("type", "")
            if degree < 2 or node_type in ("entry", "exit"):
                continue

            yaws, paths, nodes = [], [], []
            for _, n1, k in list(graph.edges(n0, keys=True)):
                e1 = graph[n0][n1][k]
                e1_path = graph_utils.correct_path_direction(e1["path"], n0, n1)
                n0_yaw, _, _, _ = graph_utils.estimate_path_yaws(e1_path, 10)
                yaws.append(n0_yaw)
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
                    new_path = path1 + path2[1:]
                    # d from the last point's last column (reference quirk at
                    # image_to_polylines.py:325: works for (x,y,yaw,k,s) rows,
                    # yields y for raw 2-tuples).
                    graph.add_edge(n1, n2, path=new_path, d=new_path[-1][-1])

            graph.remove_node(n0)
            graph_changed = True
            break
    return graph


def find_intersections(graph: nx.Graph, img01: np.ndarray,
                       terminal_nodes: np.ndarray, length_thresh: int = 25,
                       offset: int = 10):
    """Cut entry/exit stubs off terminals and split long edges, moving the
    directed lane segments into a DiGraph (image_to_polylines.py:342-485)."""
    directed_graph = nx.DiGraph()

    # Step 1: terminal (map-edge) lanes.
    removed_nodes, edges, nodes = [], [], []
    directed_edges, directed_nodes = [], []
    for node in terminal_nodes:
        direction = node[-1]
        original_node = (node[0], node[1])
        if direction == 1:
            n1, n2, k = list(graph.edges(original_node, keys=True))[0]
            target_degree = graph.degree(n2)
        else:
            n2, n1, k = list(graph.edges(original_node, keys=True))[0]
            target_degree = graph.degree(n1)
        e = graph[n1][n2][k]
        path = graph_utils.correct_path_direction(e["path"], n1, n2)
        path_np = graph_utils.downsample_path(np.array(path), ratio=16)
        curve = curves.fit_cubic_spline(path_np[:, 0], path_np[:, 1])
        length_curve = curve[-1][-1]

        if target_degree <= 1:
            removed_nodes += [n1, n2]
            directed_edges.append((n1, n2, {"path": curve, "d": length_curve}))
            directed_nodes.append((n1, {"yaw": curve[0][2], "type": "map_entry"}))
            directed_nodes.append((n2, {"yaw": curve[-1][2], "type": "map_exit"}))
        else:
            # A degenerate stub (spline of <3 rows, from a few-px edge on a
            # fragmented skeleton) cannot be cut: the entry/exit split below
            # would produce an empty curve_move slice and crash (the 6%
            # "list index out of range" failures of the r2 5k run). Keep the
            # lane whole as a map-edge lane instead.
            if len(curve) < 3:
                # Remove only the terminal itself: its neighbor keeps its
                # other edges (unlike the isolated-lane branch above).
                removed_nodes.append(original_node)
                directed_edges.append((n1, n2, {"path": curve, "d": length_curve}))
                directed_nodes.append((n1, {"yaw": curve[0][2], "type": "map_entry"}))
                directed_nodes.append((n2, {"yaw": curve[-1][2], "type": "map_exit"}))
                continue
            removed_nodes.append(original_node)
            # NOTE: the reference mutates `offset` here and the shrunken value
            # persists for subsequent terminals (image_to_polylines.py:376-377)
            # — reproduced deliberately for parity.
            if len(curve) <= offset + 1:
                offset = len(curve) - 2

            if direction == 1:
                intersect_id = -(offset + 1)
                new_terminal = (
                    round(curve[intersect_id][0], 1),
                    round(curve[intersect_id][1], 1),
                )
                curve_keep = curve[intersect_id:]
                curve_move = curve[: intersect_id + 1]
                length_keep = curve_keep[-1][-1] - curve_keep[0][-1]
                length_move = curve_move[-1][-1] - curve_move[0][-1]

                keep_t = np.array(curve_keep).T
                path_keep = list(zip(keep_t[0], keep_t[1]))
                edges.append((new_terminal, n2, {"path": path_keep, "d": length_keep}))
                directed_edges.append(
                    (n1, new_terminal, {"path": curve_move, "d": length_move})
                )
                nodes.append((new_terminal, {"yaw": curve_move[-1][2], "type": "entry"}))
                directed_nodes.append(
                    (new_terminal, {"yaw": curve_move[-1][2], "type": "entry"})
                )
                directed_nodes.append((n1, {"yaw": curve_move[0][2], "type": "map_entry"}))
            else:
                intersect_id = offset
                new_terminal = (
                    round(curve[intersect_id][0], 1),
                    round(curve[intersect_id][1], 1),
                )
                curve_keep = curve[: intersect_id + 1]
                curve_move = curve[intersect_id:]
                length_keep = curve_keep[-1][-1] - curve_keep[0][-1]
                length_move = curve_move[-1][-1] - curve_move[0][-1]

                keep_t = np.array(curve_keep).T
                path_keep = list(zip(keep_t[0], keep_t[1]))
                edges.append((n1, new_terminal, {"path": path_keep, "d": length_keep}))
                directed_edges.append(
                    (new_terminal, n2, {"path": curve_move, "d": length_move})
                )
                nodes.append((new_terminal, {"yaw": curve_move[0][2], "type": "exit"}))
                directed_nodes.append(
                    (new_terminal, {"yaw": curve_move[0][2], "type": "exit"})
                )
                directed_nodes.append((n2, {"yaw": curve_move[-1][2], "type": "map_exit"}))

    graph.remove_nodes_from(removed_nodes)
    graph.add_edges_from(edges)
    graph.add_nodes_from(nodes)
    directed_graph.add_edges_from(directed_edges)
    directed_graph.add_nodes_from(directed_nodes)

    # Step 2: long interior lanes.
    removed_edges, edges, nodes = [], [], []
    directed_edges, directed_nodes = [], []
    for n1, n2, k in list(graph.edges(keys=True)):
        e = graph[n1][n2][k]
        if e["d"] < length_thresh:
            continue

        start, end = determine_node_direction(graph, img01, n1, n2)
        direction = start[-1]
        if direction == 1:
            path = graph_utils.correct_path_direction(e["path"], n1, n2)
            n1o, n2o = (start[0], start[1]), (end[0], end[1])
        else:
            path = graph_utils.correct_path_direction(e["path"], n2, n1)
            n1o, n2o = (end[0], end[1]), (start[0], start[1])

        path_np = graph_utils.downsample_path(np.array(path), ratio=20)
        curve = curves.fit_cubic_spline(path_np[:, 0], path_np[:, 1])

        if len(curve) <= max(2 * offset + 1, 3):
            logger.debug("Found a long edge but didn't cut")
            continue

        removed_edges.append((n1o, n2o, 0))

        new_n1_id = offset
        new_n2_id = -(offset + 1)
        new_n1 = (round(curve[new_n1_id][0], 1), round(curve[new_n1_id][1], 1))
        new_n2 = (round(curve[new_n2_id][0], 1), round(curve[new_n2_id][1], 1))

        curve1_keep = curve[: new_n1_id + 1]
        curve2_keep = curve[new_n2_id:]
        length1 = curve1_keep[-1][-1] - curve1_keep[0][-1]
        length2 = curve2_keep[-1][-1] - curve2_keep[0][-1]
        curve_move = curve[new_n1_id : new_n2_id + 1]
        length_move = curve_move[-1][-1] - curve_move[0][-1]

        c1t = np.array(curve1_keep).T
        c2t = np.array(curve2_keep).T
        edges.append((n1o, new_n1, {"path": list(zip(c1t[0], c1t[1])), "d": length1}))
        edges.append((new_n2, n2o, {"path": list(zip(c2t[0], c2t[1])), "d": length2}))
        directed_edges.append((new_n1, new_n2, {"path": curve_move, "d": length_move}))
        nodes.append((new_n1, {"yaw": curve1_keep[-1][2], "type": "exit"}))
        nodes.append((new_n2, {"yaw": curve2_keep[0][2], "type": "entry"}))
        directed_nodes.append((new_n1, {"yaw": curve1_keep[-1][2], "type": "exit"}))
        directed_nodes.append((new_n2, {"yaw": curve2_keep[0][2], "type": "entry"}))

    graph.remove_edges_from(removed_edges)
    graph.add_edges_from(edges)
    graph.add_nodes_from(nodes)
    directed_graph.add_edges_from(directed_edges)
    directed_graph.add_nodes_from(directed_nodes)

    return graph, directed_graph


def connect_intersections(graph: nx.Graph, directed_graph: nx.DiGraph,
                          simplified_graph: Optional[nx.Graph] = None) -> nx.DiGraph:
    """Bezier-connect intersection entries to exits, validated by Dijkstra
    route existence and angle/inlier gates (image_to_polylines.py:488-582)."""
    entries = [n for n in directed_graph.nodes()
               if directed_graph.nodes[n].get("type") == "entry"]
    exits = [n for n in directed_graph.nodes()
             if directed_graph.nodes[n].get("type") == "exit"]

    # Known connections from the simplified graph.
    if simplified_graph is not None:
        simple_edges = []
        for n1, n2, k in list(simplified_graph.edges(keys=True)):
            try:
                n1_yaw = simplified_graph.nodes[n1]["yaw"]
                n2_yaw = simplified_graph.nodes[n2]["yaw"]
                n1_type = simplified_graph.nodes[n1]["type"]
                n2_type = simplified_graph.nodes[n2]["type"]
            except KeyError:
                try:
                    if directed_graph.has_node(n1) and directed_graph.has_node(n2):
                        n1_yaw = directed_graph.nodes[n1]["yaw"]
                        n2_yaw = directed_graph.nodes[n2]["yaw"]
                        n1_type = directed_graph.nodes[n1]["type"]
                        n2_type = directed_graph.nodes[n2]["type"]
                    else:
                        continue
                except KeyError:
                    continue

            if n1_type == "entry" and n2_type == "exit":
                curve = curves.fit_bezier_curve((n1[0], n1[1], n1_yaw), (n2[0], n2[1], n2_yaw))
                simple_edges.append((n1, n2, {"path": curve, "d": curve[-1][-1]}))
            elif n2_type == "entry" and n1_type == "exit":
                curve = curves.fit_bezier_curve((n2[0], n2[1], n2_yaw), (n1[0], n1[1], n1_yaw))
                simple_edges.append((n2, n1, {"path": curve, "d": curve[-1][-1]}))
        directed_graph.add_edges_from(simple_edges)

    # Unknown connections, gated geometrically.
    edges = []
    for n1 in entries:
        n1_yaw = directed_graph.nodes[n1]["yaw"]
        for n2 in exits:
            n2_yaw = directed_graph.nodes[n2]["yaw"]
            try:
                route = nx.shortest_path(graph, n1, n2, weight="d", method="dijkstra")
            except (nx.NetworkXNoPath, nx.NodeNotFound):
                continue
            if directed_graph.has_edge(n1, n2):
                continue
            route_valid = all(n not in exits and n not in entries for n in route[1:-1])
            if not route_valid:
                continue

            waypoints = graph_utils.trace_route(graph, route)
            curve = curves.fit_bezier_curve((n1[0], n1[1], n1_yaw), (n2[0], n2[1], n2_yaw))
            pos_angle = graph_utils.normalize_angle_rad(
                np.arctan2(n2[1] - n1[1], n2[0] - n1[0]) - n1_yaw
            )
            yaw_diff = graph_utils.normalize_angle_rad(n2_yaw - n1_yaw)
            if pos_angle < 0:
                angle = -graph_utils.normalize_angle_rad(yaw_diff - pos_angle)
            else:
                angle = graph_utils.normalize_angle_rad(yaw_diff - pos_angle)

            if len(route) - 2 <= 1:  # direct connection
                edges.append((n1, n2, {"path": curve, "d": curve[-1][-1]}))
            elif np.fabs(pos_angle) <= np.deg2rad(10) and np.fabs(angle) <= np.deg2rad(10):
                edges.append((n1, n2, {"path": curve, "d": curve[-1][-1]}))
            elif np.fabs(yaw_diff) > np.deg2rad(135):
                continue  # turn angle too large
            elif np.deg2rad(-5) <= angle <= np.deg2rad(95):  # long turn
                ratio = np.fabs(pos_angle / angle) if angle != 0 else np.inf
                # ratio == 0 (pos_angle exactly 0) fails the 1/ratio < 2
                # test; short-circuit it to avoid the divide-by-zero
                # RuntimeWarning numpy emits on model outputs.
                if ratio != np.inf and ratio != 0 and 1 / ratio < 2 and ratio < 2:
                    if curve_is_valid(curve, waypoints, dist_tol=3.0, min_rate=0.5):
                        edges.append((n1, n2, {"path": curve, "d": curve[-1][-1]}))

    directed_graph.add_edges_from(edges)
    return directed_graph


def path_is_smooth(path: np.ndarray, yaw_d_thresh: float = 500.0,
                   yaw_dd_thresh: float = 500.0) -> bool:
    """Reject curves whose yaw rate exceeds the threshold
    (image_to_polylines.py:585-602)."""
    _, idx = np.unique(path[:, 2], return_index=True, axis=0)
    path = path[np.sort(idx)]
    dx = np.diff(path[:, 0])
    dy = np.diff(path[:, 1])
    ds = np.hypot(dx, dy)
    yaw = np.rad2deg(np.arctan2(dy, dx))
    yaw_d = np.diff(yaw) / ds[:-1]
    return np.max(np.fabs(yaw_d)) <= yaw_d_thresh


def extract_polylines_from_img(
    img01: np.ndarray,
    img_gray: Optional[np.ndarray] = None,
    map_range: float = 80.0,
    plot: bool = False,
    save_path: Optional[str] = None,
    min_distance: int = 4,
    intersection_offset: int = 5,
    length_thresh: int = 25,
    skel: Optional[np.ndarray] = None,
    noise_mask_frac: float = 0.25,
    max_graph_nodes: int = 1500,
    despeckle_px: int = 15,
    max_scene_nodes: int = 32,
):
    """Full GRAPH_FIT pipeline (image_to_polylines.py:605-769).

    Returns (lanes, directed_graph) where lanes is a list of [N, 6]
    world-frame arrays [x, y, z, dx, dy, dz], or (None, None) on failure.
    """
    img01 = image_utils.to_float01(img01)

    # Garbage-raster guard: an undertrained/noise sample produces a mask
    # covering a large image fraction whose skeleton is a dense maze; the
    # graph passes are quadratic in junction count on such inputs. Real
    # rasters have ~3-6% lane pixels.
    mask = image_utils.get_lane_mask(img01)
    if mask.mean() > noise_mask_frac:
        logger.warning(
            f"lane mask covers {mask.mean():.0%} of the image — rejecting as noise"
        )
        return None, None

    skel_arr, graph = image_to_graph(
        img01, min_distance=min_distance, skel=skel, mask=mask,
        despeckle_px=despeckle_px,
    )

    if graph.number_of_nodes() < 2 or graph.number_of_edges() < 1:
        logger.warning("Failed to extract graph from image")
        return None, None
    if graph.number_of_nodes() > max_graph_nodes:
        logger.warning(
            f"degenerate skeleton graph ({graph.number_of_nodes()} nodes) — rejecting"
        )
        return None, None

    terminal_nodes, branching_nodes = find_key_nodes(graph, img01)
    if terminal_nodes.shape[0] < 2 or len(terminal_nodes.shape) < 2:
        logger.warning("Failed to extract terminal nodes from image")
        return None, None

    graph, directed_graph = find_intersections(
        graph, img01, terminal_nodes, length_thresh=length_thresh,
        offset=intersection_offset,
    )

    simplified_graph = copy.deepcopy(graph)
    simplified_graph = simplify_graph(simplified_graph)
    simplified_graph = break_down_graph(simplified_graph)

    directed_graph = connect_intersections(
        graph, directed_graph, simplified_graph=simplified_graph
    )

    # Final-graph plausibility gate, calibrated from GT-side data only
    # (VectorizeConfig.max_scene_nodes): the roundtrip vectorization of
    # 2000 GT rasters tops out at 16 scene nodes, so a graph far beyond
    # that is fragmented sampler junk that passed the mask-density gate
    # (its per-node pieces are thin, so mask fraction stays low). Without
    # this, a ~5% junk tail dominates the fitted node-count Gaussian and
    # the Density/Reach Frechet stats (measured: tools/gate_tradeoff.py).
    if directed_graph.number_of_nodes() > max_scene_nodes:
        logger.warning(
            f"implausible scene graph ({directed_graph.number_of_nodes()} "
            f"nodes > {max_scene_nodes}) — rejecting as fragmented noise"
        )
        return None, None

    polylines = graph_utils.graph_to_polylines(directed_graph)
    polylines_world = graph_utils.polylines_to_world_frame(
        polylines, skel_arr.shape, map_range=map_range
    )
    output = graph_utils.polylines_to_output(polylines_world)

    if plot or save_path:
        _plot_debug(img01, skel_arr, directed_graph, save_path)

    return output, directed_graph


def _plot_debug(img01, skel, directed_graph, save_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(15, 5), sharex=True, sharey=True)
    axes[0].imshow(img01)
    axes[0].set_title("raster")
    axes[1].imshow(skel.T, cmap="gray")
    axes[1].set_title("skeleton")
    axes[2].imshow(np.zeros_like(skel.T), cmap="gray")
    for polyline in graph_utils.graph_to_polylines(directed_graph):
        axes[2].plot(polyline[:, 0], polyline[:, 1], c=graph_utils.random_color())
    axes[2].set_title("directed lanes")
    for ax in axes:
        ax.set_aspect("equal")
        ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=120)
    plt.close(fig)

"""The port's copy of drivescenegen_tpu/vectorize/agents.py.

Agent decoder: generated raster B channel -> vehicle list
(reference: vectorization/direct/extract_vehicles.py).

Blue channel -> threshold -> connected components -> min-area rectangles
(own convex hull + rotating calipers, replacing the reference's OpenCV
findContours/minAreaRect at extract_vehicles.py:145-151 — no cv2 import);
physical size gates (reject < 4.0 x 1.75 m, clamp to 5.0 x 2.2 m); speed
decoded from the blue intensity deviation x 60; heading snapped to the
nearest lane within dist_thresh with speed clamped to
[min_speed, max_speed], else v = 0.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np

from drivescenegen_torch.vectorize.graph_utils import normalize_angle_rad


# ---------------------------------------------------------------------------
# Box fitting: connected components + convex hull + rotating calipers
# ---------------------------------------------------------------------------

def connected_components(
    mask: np.ndarray, min_area: int = 0, min_extent: int = 0
) -> List[np.ndarray]:
    """8-connected foreground components as (N, 2) pixel-center (x, y)
    arrays (the role of cv2.findContours RETR_LIST).

    min_area / min_extent prefilter components by pixel count and by
    max(bbox height, width) BEFORE materializing their pixel lists. On
    speckled model outputs the blue channel holds thousands of few-pixel
    blobs, and the per-component Python work (hull + calipers + gates) was
    8.2 s/image (outputs/stage2_profile.py); a component that can pass the
    vehicle size gates (length >= 4 m, width >= 1.75 m at 0.3125 m/px,
    extract_vehicles.py:160-164) needs >= ~18 connected px and a bbox
    extent >= L/sqrt(2) ~ 9 px, so min_area=16 / min_extent=9 are strict
    supersets of the downstream gates."""
    from scipy import ndimage as ndi

    lab, n = ndi.label(mask, structure=np.ones((3, 3), np.int32))
    if n == 0:
        return []
    areas = np.bincount(lab.ravel(), minlength=n + 1)
    out = []
    for i, sl in enumerate(ndi.find_objects(lab), start=1):
        if areas[i] < min_area:
            continue
        if sl is not None and min_extent > 0:
            h = sl[0].stop - sl[0].start
            w = sl[1].stop - sl[1].start
            if max(h, w) < min_extent:
                continue
        ys, xs = np.nonzero(lab[sl] == i)
        out.append(
            np.stack([xs + sl[1].start, ys + sl[0].start], axis=1).astype(np.float64)
        )
    return out


def _reduce_to_row_extremes(pts: np.ndarray) -> np.ndarray:
    """Keep only each x-column's min/max-y points: the convex hull of a
    dense pixel blob equals the hull of its per-column extremes, so a 65k-px
    blob (a noisy sample's saturated blue channel) shrinks to <= 2*W
    candidates before the O(N) chain loop (measured 16 s -> ms)."""
    xs = pts[:, 0].astype(np.int64)
    xs_u, inv = np.unique(xs, return_inverse=True)
    ymin = np.full(len(xs_u), np.inf)
    ymax = np.full(len(xs_u), -np.inf)
    np.minimum.at(ymin, inv, pts[:, 1])
    np.maximum.at(ymax, inv, pts[:, 1])
    lo = np.stack([xs_u.astype(np.float64), ymin], axis=1)
    hi = np.stack([xs_u.astype(np.float64), ymax], axis=1)
    return np.concatenate([lo, hi])


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; pts (N, 2) -> CCW hull vertices."""
    if len(pts) > 1024:
        pts = _reduce_to_row_extremes(pts)
    pts = np.unique(pts, axis=0)  # lexicographically sorted unique rows
    if len(pts) <= 2:
        return pts

    def chain(points):
        # Scalar 2D cross product inline: the generic np.cross carries
        # ~100 us of moveaxis/axis-normalization overhead per call, which
        # dominated stage-2 agent extraction (35k calls/image profiled).
        h: list = []
        for p in points:
            px, py = float(p[0]), float(p[1])
            while len(h) >= 2:
                ax, ay = h[-2]
                bx, by = h[-1]
                if (bx - ax) * (py - ay) - (by - ay) * (px - ax) <= 0.0:
                    h.pop()
                else:
                    break
            h.append((px, py))
        return h

    lower = chain(pts)
    upper = chain(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def min_area_rect(pts: np.ndarray):
    """Minimum-area enclosing rectangle of a point set (the role of
    cv2.minAreaRect). Returns (cx, cy, long_side, short_side, yaw) with
    yaw = orientation of the LONG axis in pixel coords (x right, y down)."""
    hull = _convex_hull(np.asarray(pts, np.float64))
    if len(hull) == 1:
        return float(hull[0, 0]), float(hull[0, 1]), 0.0, 0.0, 0.0
    if len(hull) == 2:
        d = hull[1] - hull[0]
        c = (hull[0] + hull[1]) / 2.0
        return (
            float(c[0]), float(c[1]), float(np.hypot(d[0], d[1])), 0.0,
            float(np.arctan2(d[1], d[0])),
        )
    edges = np.diff(np.vstack([hull, hull[:1]]), axis=0)
    lens = np.hypot(edges[:, 0], edges[:, 1])
    u = edges[lens > 0] / lens[lens > 0, None]  # (E, 2) edge directions
    v = np.stack([-u[:, 1], u[:, 0]], axis=1)  # perpendiculars
    pu = hull @ u.T  # (N, E) projections
    pv = hull @ v.T
    du = pu.max(axis=0) - pu.min(axis=0)
    dv = pv.max(axis=0) - pv.min(axis=0)
    i = int(np.argmin(du * dv))
    cu = (pu[:, i].max() + pu[:, i].min()) / 2.0
    cv_ = (pv[:, i].max() + pv[:, i].min()) / 2.0
    center = cu * u[i] + cv_ * v[i]
    if du[i] >= dv[i]:
        return (
            float(center[0]), float(center[1]), float(du[i]), float(dv[i]),
            float(np.arctan2(u[i, 1], u[i, 0])),
        )
    return (
        float(center[0]), float(center[1]), float(dv[i]), float(du[i]),
        float(np.arctan2(v[i, 1], v[i, 0])),
    )


from drivescenegen_torch.vectorize.image_utils import channel_background_modes


def get_image_histogram(img01: np.ndarray):
    """Modal values of the R and G channels (extract_vehicles.py:14-44) —
    same computation as image_utils.channel_background_modes."""
    return channel_background_modes(img01)


def verify_vehicle(img01: np.ndarray, x: int, y: int, r: int = 2, modes=None):
    """Speed gradient at (x, y): mean blue deviation from 0.5 in a (2r+1)^2
    window, gated on the window deviating from the R/G background modes
    (extract_vehicles.py:47-81, including its 1-mean(R) quirk). Pass
    precomputed `modes` to avoid re-histogramming per contour."""
    H, W = img01.shape[:2]
    dx_mode, dy_mode = modes if modes is not None else get_image_histogram(img01)
    win = img01[max(0, y - r) : min(H, y + r + 1), max(0, x - r) : min(W, x + r + 1)]
    dx_grey = 1.0 - win[..., 0].mean()
    dy_grey = win[..., 1].mean()
    vel = win[..., 2].mean()
    gradient = [0.0, 0.0, 0.0]
    if abs(dx_grey - dx_mode) > 0.05 or abs(dy_grey - dy_mode) > 0.05:
        gradient = [vel - 0.5, dx_grey - dx_mode, dy_grey - dy_mode]
    return gradient


def estimate_agent_yaw(center, lanes: List[np.ndarray]):
    """Yaw of (and distance to) the nearest lane waypoint
    (extract_vehicles.py:84-103)."""
    best = None
    for lane in lanes:
        lane = np.asarray(lane)
        d = np.hypot(lane[:, 0] - center[0], lane[:, 1] - center[1])
        i = int(np.argmin(d))
        yaw = math.atan2(lane[i, 4], lane[i, 3])
        if best is None or d[i] < best[1]:
            best = (yaw, float(d[i]))
    if best is None:
        return 0.0, float("inf")
    return best


def _to_world(agent: list, map_center, map_scale: float) -> list:
    """Pixel box -> world metres (extract_vehicles.py:106-118)."""
    agent[0] = agent[0] * map_scale - map_center[0]
    agent[1] = map_center[1] - agent[1] * map_scale
    agent[2] = agent[2] * map_scale
    agent[3] = agent[3] * map_scale
    agent[4] = agent[4] * map_scale
    agent[5] = agent[5] * map_scale
    agent[6] = agent[6] * (-1)
    agent[8] = agent[8] * (-1)
    return agent


def extract_agents(
    img01: np.ndarray,
    lanes: Optional[List[np.ndarray]],
    map_range: float = 80.0,
    dist_thresh: float = 3.0,
    min_speed: float = 2.0,
    max_speed: float = 10.0,
) -> List[list]:
    """float01 (H, W, 3) raster -> list of
    [x, y, z, length, width, height, yaw, vx, vy] vehicles."""
    H, W = img01.shape[:2]
    map_scale = map_range / H  # m/pixel
    map_center = (H / 2 * map_scale, W / 2 * map_scale)
    lanes = lanes or []

    blue = (img01[..., 2] * 255).astype(np.uint8)
    thresh = blue > 100  # cv2.threshold(.., 100, 255, BINARY) equivalent

    modes = get_image_histogram(img01)  # constant per image; hoisted
    vehicles = []
    # Conservative speckle prefilter: any component passing the size gates
    # below has a min-rect long side L >= 4.0/map_scale px, hence a bbox
    # extent and a connected pixel count of at least L/sqrt(2).
    min_px = max(1, int(4.0 / map_scale / math.sqrt(2)))
    for pts in connected_components(thresh, min_area=min_px, min_extent=min_px):
        cx, cy, length, width, long_yaw = min_area_rect(pts)
        # min_area_rect already returns long >= short with the long-axis
        # yaw; the reference's aspect disambiguation (extract_vehicles.py:
        # 154-158) reduces to the same +pi offset.
        yaw = normalize_angle_rad(long_yaw + math.pi)

        if length < 4.0 / map_scale or width < 1.75 / map_scale:
            continue
        length = min(length, 5.0 / map_scale)
        width = min(width, 2.2 / map_scale)
        height = 1.0 / map_scale

        gradient = verify_vehicle(img01, int(cx), int(cy), modes=modes)
        velocity = abs(gradient[0]) * 60.0

        agent = _to_world(
            [
                cx, cy, 0.0, length, width, height, yaw,
                velocity * math.cos(yaw), velocity * math.sin(yaw),
            ],
            map_center,
            map_scale,
        )

        lane_yaw, dist = estimate_agent_yaw(agent[:2], lanes)
        if dist < dist_thresh:
            velocity = max(min_speed, min(velocity, max_speed))
        else:
            velocity = 0.0
        agent[-3] = lane_yaw
        agent[-2] = velocity * math.cos(lane_yaw)
        agent[-1] = velocity * math.sin(lane_yaw)
        vehicles.append(agent)

    return vehicles

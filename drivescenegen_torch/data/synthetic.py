"""The port's copy of drivescenegen_tpu/data/synthetic.py.

Synthetic Waymo-format scenario generator.

Builds serialized Scenario protos with plausible mini road networks (straight
roads, crossroads, arcs) and vehicles moving along lanes. Used by tests (the
reference ships zero fixtures) and as a stand-in dataset for full-pipeline
smoke runs when real Waymo TFRecords are unavailable.
"""

from __future__ import annotations

import numpy as np


def _lane_points(start, heading, length, spacing=0.5, curvature=0.0):
    """Generate centerline points; constant curvature arc if curvature != 0."""
    n = max(2, int(length / spacing))
    pts = np.zeros((n, 2))
    pos = np.asarray(start, float).copy()
    h = float(heading)
    for i in range(n):
        pts[i] = pos
        pos = pos + spacing * np.array([np.cos(h), np.sin(h)])
        h += curvature * spacing
    return pts


def _offset_reversed(pts: np.ndarray, gap: float) -> np.ndarray:
    """Parallel lane offset by `gap` along local normals, running the
    opposite direction (the standard two-way-road construction)."""
    d = np.gradient(pts, axis=0)
    n = np.stack([-d[:, 1], d[:, 0]], axis=1)
    n /= np.linalg.norm(n, axis=1, keepdims=True) + 1e-9
    return (pts + gap * n)[::-1]


def synthetic_layout(rng: np.random.Generator, extent: float = 60.0,
                     rich: bool = False):
    """Random mini road network: list of (points [N,2], speed m/s).
    Layouts are randomly rotated as a whole so the training distribution
    covers all headings (the reference's Waymo scenes are unaligned too).

    rich=True widens the layout family (T-junctions, curved two-ways,
    Y-splits, parallel roads, curved crossings) for large synthetic
    training sets; the default keeps the original three kinds so seeded
    test fixtures are stable."""
    kind = int(rng.integers(0, 8 if rich else 3))
    lanes = []
    if kind == 0:  # straight two-way road + optional extra lane
        y0 = rng.uniform(-10, 10)
        gap = rng.uniform(3.0, 4.5)
        lanes.append((_lane_points((-extent, y0), 0.0, 2 * extent), 10.0))
        lanes.append((_lane_points((extent, y0 + gap), np.pi, 2 * extent), 10.0))
        if rng.random() < 0.5:
            lanes.append((_lane_points((-extent, y0 - gap), 0.0, 2 * extent), 8.0))
    elif kind == 1:  # crossroads
        off = rng.uniform(-8, 8)
        lanes.append((_lane_points((-extent, off), 0.0, 2 * extent), 9.0))
        lanes.append((_lane_points((extent, off + 3.5), np.pi, 2 * extent), 9.0))
        lanes.append((_lane_points((off, -extent), np.pi / 2, 2 * extent), 9.0))
        lanes.append((_lane_points((off + 3.5, extent), -np.pi / 2, 2 * extent), 9.0))
    elif kind == 2:  # arc + straight
        r = rng.uniform(25, 60) * rng.choice([-1.0, 1.0])
        lanes.append(
            (_lane_points((-extent, -10.0), 0.2, 2.2 * extent, curvature=1.0 / r), 8.0)
        )
        lanes.append((_lane_points((-extent, 8.0), 0.0, 2 * extent), 11.0))
    elif kind == 3:  # T-junction: two-way main road + two-way stub
        y0 = rng.uniform(-12, 12)
        gap = rng.uniform(3.2, 4.2)
        x0 = rng.uniform(-15, 15)
        main = _lane_points((-extent, y0), 0.0, 2 * extent)
        lanes.append((main, 10.0))
        lanes.append((_offset_reversed(main, gap), 10.0))
        stub = _lane_points((x0, -extent), np.pi / 2, extent + y0 - gap / 2)
        lanes.append((stub, 8.0))
        lanes.append((_offset_reversed(stub, gap), 8.0))
    elif kind == 4:  # curved two-way road
        r = rng.uniform(35, 90) * rng.choice([-1.0, 1.0])
        gap = rng.uniform(3.2, 4.5)
        y0 = rng.uniform(-10, 10)
        a = _lane_points((-extent, y0), rng.uniform(-0.25, 0.25),
                         2.2 * extent, curvature=1.0 / r)
        lanes.append((a, 9.0))
        lanes.append((_offset_reversed(a, gap), 9.0))
    elif kind == 5:  # Y-split: one inlet diverging into two arcs
        y0 = rng.uniform(-8, 8)
        trunk = _lane_points((-extent, y0), 0.0, extent)
        end = trunk[-1]
        r = rng.uniform(30, 70)
        up = _lane_points(end, 0.0, extent, curvature=1.0 / r)
        down = _lane_points(end, 0.0, extent, curvature=-1.0 / r)
        lanes.append((np.concatenate([trunk, up[1:]]), 9.0))
        lanes.append((np.concatenate([trunk, down[1:]]), 9.0))
        if rng.random() < 0.5:
            lanes.append((_offset_reversed(np.concatenate([trunk, up[1:]]),
                                           rng.uniform(3.2, 4.2)), 9.0))
    elif kind == 6:  # two separate parallel two-way roads
        sep = rng.uniform(18, 35)
        gap = rng.uniform(3.2, 4.2)
        y0 = rng.uniform(-8, 8)
        for yy in (y0 - sep / 2, y0 + sep / 2):
            a = _lane_points((-extent, yy), 0.0, 2 * extent)
            lanes.append((a, 10.0))
            lanes.append((_offset_reversed(a, gap), 10.0))
    else:  # kind == 7: straight two-way crossed by an arc
        y0 = rng.uniform(-10, 10)
        gap = rng.uniform(3.2, 4.2)
        a = _lane_points((-extent, y0), 0.0, 2 * extent)
        lanes.append((a, 10.0))
        lanes.append((_offset_reversed(a, gap), 10.0))
        r = rng.uniform(40, 100) * rng.choice([-1.0, 1.0])
        arc = _lane_points((rng.uniform(-20, 0), -extent),
                           np.pi / 2 + rng.uniform(-0.3, 0.3),
                           2 * extent, curvature=1.0 / r)
        lanes.append((arc, 8.0))

    # Random global rotation about the origin.
    theta = rng.uniform(-np.pi, np.pi)
    R = np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]])
    return [(pts @ R.T, speed) for pts, speed in lanes]


def _fill_lane(feature, pts: np.ndarray, lane_type: int = 2):
    feature.lane.type = lane_type
    feature.lane.speed_limit_mph = 25.0
    for x, y in pts:
        p = feature.lane.polyline.add()
        p.x = float(x)
        p.y = float(y)
        p.z = 0.0


def _track_along_lane(track, pts: np.ndarray, speed: float, t_steps: int = 91,
                      dt: float = 0.1, start_frac: float = 0.3,
                      length: float = 4.8, width: float = 2.1):
    """March a vehicle along a lane polyline at constant speed."""
    seg = np.diff(pts, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = s[-1]
    s0 = start_frac * total
    track.object_type = 1  # TYPE_VEHICLE
    for t in range(t_steps):
        si = min(s0 + speed * dt * t, total - 1e-3)
        i = int(np.searchsorted(s, si) - 1)
        i = max(0, min(i, len(seg) - 1))
        frac = (si - s[i]) / max(seg_len[i], 1e-9)
        xy = pts[i] + frac * seg[i]
        heading = float(np.arctan2(seg[i][1], seg[i][0]))
        st = track.states.add()
        st.center_x = float(xy[0])
        st.center_y = float(xy[1])
        st.center_z = 0.0
        st.length = length
        st.width = width
        st.height = 1.8
        st.heading = heading
        st.velocity_x = speed * np.cos(heading)
        st.velocity_y = speed * np.sin(heading)
        st.valid = True


def make_synthetic_scenario(
    seed: int, scenario_id: str | None = None, n_extra_vehicles: int = 4,
    rich: bool = False,
) -> bytes:
    """One serialized Scenario proto with a random layout + moving vehicles."""
    from drivescenegen_torch.data.protos import dsg_scenario_pb2

    rng = np.random.default_rng(seed)
    sc = dsg_scenario_pb2.Scenario()
    sc.scenario_id = scenario_id or f"synthetic_{seed:08d}"
    sc.current_time_index = 10
    for t in range(91):
        sc.timestamps_seconds.append(t * 0.1)

    lanes = synthetic_layout(rng, rich=rich)
    if rich:
        n_extra_vehicles = int(rng.integers(2, 9))
    # World offset so ego-centering is actually exercised.
    offset = rng.uniform(-2000, 2000, size=2)
    for i, (pts, _) in enumerate(lanes):
        feat = sc.map_features.add()
        feat.id = i + 1
        _fill_lane(feat, pts + offset)

    # Ego on lane 0.
    sc.sdc_track_index = 0
    ego_lane, ego_speed = lanes[0]
    track = sc.tracks.add()
    track.id = 1000
    _track_along_lane(track, ego_lane + offset, ego_speed * rng.uniform(0.3, 1.0))

    for v in range(n_extra_vehicles):
        li = int(rng.integers(0, len(lanes)))
        pts, speed = lanes[li]
        track = sc.tracks.add()
        track.id = 2000 + v
        _track_along_lane(
            track, pts + offset, speed * rng.uniform(0.0, 1.2),
            start_frac=float(rng.uniform(0.1, 0.8)),
        )

    return sc.SerializeToString()


def make_synthetic_tfrecord(path: str, n_scenarios: int, seed: int = 0) -> int:
    from drivescenegen_torch.data import tfrecord

    records = (make_synthetic_scenario(seed * 100003 + i) for i in range(n_scenarios))
    return tfrecord.write_tfrecord(path, records)

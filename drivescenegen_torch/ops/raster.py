"""The port's drivescenegen_tpu/ops/raster.py: the analytic BEV rasterizer
in PyTorch, on the device of its input tensors (rasterize_scenario puts
them on the card unless the caller passes device="cpu").

(padded polylines, agent tracks) -> (H, W, 3) float32 in [0, 1]:
- R, G channels: lane centerlines (Waymo lane type 2, surface streets only —
  the `1 < type < 3` filter), colored by the MinMax-normalized per-point
  direction (dx, dy) -> [0, 0.99], bilinearly splatted; gray 0.5
  background.
- B channel: one rotated rectangle per valid vehicle at the agent frame,
  filled with speed encoding |pos[t+1]-pos[t]|/60 + 0.5, drawn only when
  the box holds a lane point (the reference's shapely intersects gate);
  black background.

Geometry: pixel (row, col) <-> world (x, y) with x right, y up:
  col = (x + half) / (2*half) * W,  row = (half - y) / (2*half) * H

Frames (reference quirks preserved): lanes are ego-translated at t=10,
agents at `agent_time_index` (1 by default, for parity).

The same arithmetic on the card and on the CPU. Every device operation
here is an IEEE-exact elementwise one (add, multiply, divide, floor,
compare, max) except the splat's sum and the boxes' cos/sin:
- the splat adds each pixel's samples one at a time in a fixed order, the
  JAX package's (_segment_sum), not with float atomics, so a run is
  deterministic and the card's raster equals the CPU's bit for bit;
- rasterize_scenario takes cos/sin of the headings on the host, where the
  boxes are made, and hands them to the agent channel: the card's and the
  CPU's can differ by an ulp and flip pixels that lie on a box's edge, so
  with host trig no pixel flips between devices, by construction.
Constants are rounded to float32 as jnp rounds them (half_range is a
float32 there).
"""

from __future__ import annotations

import numpy as np
import torch

from drivescenegen_torch.ops import map_processing as mp
from drivescenegen_torch.utils.device import resolve_device

def _f32(x) -> float:
    """A Python float that holds exactly the float32 value of x."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Lane channels
# ---------------------------------------------------------------------------

def _segment_sum(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """out[i] = the sum of the rows of vals [N, C] whose idx is i, out [n, C].

    Each pixel's rows are added one at a time in the order they come, as
    the JAX package's scatter-add does on the CPU, and in the same order
    on every device: a stable sort by index lays the rows of each index out
    as a run, a scatter to unique slots lays the runs out as columns of a
    [longest run, pixels, C] array, and its columns are added in turn. No
    float atomics, so a run is deterministic. Rows whose last column (the
    weight) is 0 add exactly 0 and are left out."""
    keep = vals[:, -1] != 0
    idx, vals = idx[keep], vals[keep]
    out = vals.new_zeros((n, vals.shape[1]))
    m = idx.numel()
    if m == 0:
        return out
    idx, order = torch.sort(idx, stable=True)
    vals = vals[order]
    uniq, counts = torch.unique_consecutive(idx, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    seg = torch.repeat_interleave(torch.arange(uniq.numel(), device=idx.device), counts)
    rank = torch.arange(m, device=idx.device) - starts[seg]
    runs = vals.new_zeros((int(counts.max()), uniq.numel(), vals.shape[1]))
    runs[rank, seg] = vals
    acc = runs[0]
    for column in runs[1:]:
        acc = acc + column
    out[uniq] = acc
    return out


def _splat_bilinear(xy_px, colors, weights, H: int, W: int):
    """Bilinear splats of (colors, weights) at subpixel coords ->
    (acc_color [H*W, C], acc_w [H*W]). A corner off the image goes to pixel
    0 with weight 0, as the JAX package's scatter with mode="drop" does."""
    x = xy_px[:, 0] - 0.5
    y = xy_px[:, 1] - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)

    idxs, rows = [], []
    for dx, dy, w in (
        (0, 0, (1 - fx) * (1 - fy)),
        (1, 0, fx * (1 - fy)),
        (0, 1, (1 - fx) * fy),
        (1, 1, fx * fy),
    ):
        xi = x0 + dx
        yi = y0 + dy
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idxs.append(torch.where(inb, yi * W + xi, 0))
        wt = w * weights * inb
        rows.append(torch.cat([wt[:, None] * colors, wt[:, None]], dim=1))
    acc = _segment_sum(torch.cat(idxs), torch.cat(rows), H * W)
    return acc[:, :-1], acc[:, -1]


def rasterize_lane_channels(
    lane_feats: torch.Tensor,  # [P, L, 9] [x,y,z,dx,dy,dz,type,theta,valid]
    lane_masks: torch.Tensor,  # [P, L] bool
    half_range: float,
    H: int = 256,
    W: int = 256,
    background: float = 0.5,
    interp_k: int = 8,
    lane_type_lo: float = 1.0,
    lane_type_hi: float = 3.0,
) -> torch.Tensor:
    """Lane R/G channels, (H, W, 2). Inputs pre-translated & dxdy-normalized."""
    lane_feats = lane_feats.to(torch.float32)
    dev = lane_feats.device
    types = lane_feats[..., 6]
    draw = lane_masks & (types > lane_type_lo) & (types < lane_type_hi)

    hr = np.float32(half_range)
    px_per_m = _f32(np.float32(W) / (np.float32(2.0) * hr))
    py_per_m = _f32(np.float32(H) / (np.float32(2.0) * hr))

    def to_px(xy):
        u = (xy[..., 0] + float(hr)) * px_per_m
        v = (float(hr) - xy[..., 1]) * py_per_m
        return torch.stack([u, v], dim=-1)

    # Segment samples: interpolate between consecutive valid points.
    p0 = lane_feats[:, :-1]
    p1 = lane_feats[:, 1:]
    seg_valid = (draw[:, :-1] & draw[:, 1:]).to(torch.float32)

    ts = (torch.arange(interp_k, dtype=torch.float32, device=dev) + 0.5) / interp_k  # (K,)
    # pos/color interp: [P, L-1, K, 2]
    xy0 = p0[..., 0:2][:, :, None, :]
    xy1 = p1[..., 0:2][:, :, None, :]
    seg_xy = xy0 + (xy1 - xy0) * ts[None, None, :, None]
    c0 = p0[..., 3:5][:, :, None, :]
    c1 = p1[..., 3:5][:, :, None, :]
    seg_c = c0 + (c1 - c0) * ts[None, None, :, None]
    seg_w = seg_valid[:, :, None].expand(seg_xy.shape[:-1])

    # Raw point samples cover chunk endpoints and isolated points.
    pt_xy = lane_feats[..., 0:2]
    pt_c = lane_feats[..., 3:5]
    pt_w = draw.to(torch.float32)

    all_xy = torch.cat([seg_xy.reshape(-1, 2), pt_xy.reshape(-1, 2)])
    all_c = torch.cat([seg_c.reshape(-1, 2), pt_c.reshape(-1, 2)])
    all_w = torch.cat([seg_w.reshape(-1), pt_w.reshape(-1)])

    acc_color, acc_w = _splat_bilinear(to_px(all_xy), all_c, all_w, H, W)

    alpha = torch.clamp(acc_w, 0.0, 1.0)[:, None]
    mean_c = acc_color / torch.clamp_min(acc_w, 1e-8)[:, None]
    out = background * (1.0 - alpha) + mean_c * alpha
    return out.reshape(H, W, 2)


# ---------------------------------------------------------------------------
# Agent channel
# ---------------------------------------------------------------------------

def rasterize_agent_channel(
    boxes: torch.Tensor,  # [A, 7] [cx, cy, length, width, heading, blue, valid]
    gate_points: torch.Tensor,  # [G, 2] lane-line points for the intersects gate
    gate_valid: torch.Tensor,  # [G]
    half_range: float,
    H: int = 256,
    W: int = 256,
    cos_sin: torch.Tensor | None = None,  # [A, 2]; None: taken on boxes' device
) -> torch.Tensor:
    """Agent B channel, (H, W). Rectangles shaded by speed, gated on lanes."""
    boxes = boxes.to(torch.float32)
    dev = boxes.device
    cx, cy = boxes[:, 0], boxes[:, 1]
    hl, hw = boxes[:, 2] / 2.0, boxes[:, 3] / 2.0
    if cos_sin is None:
        cos_h, sin_h = torch.cos(boxes[:, 4]), torch.sin(boxes[:, 4])
    else:
        cos_h, sin_h = cos_sin.to(dev, torch.float32).unbind(dim=1)
    blue = boxes[:, 5]
    valid = boxes[:, 6] > 0

    # Gate: any valid lane point inside the rotated rectangle (vectorized
    # stand-in for shapely MultiLineString.intersects).
    gx = gate_points[None, :, 0] - cx[:, None]
    gy = gate_points[None, :, 1] - cy[:, None]
    u = gx * cos_h[:, None] + gy * sin_h[:, None]
    v = -gx * sin_h[:, None] + gy * cos_h[:, None]
    inside = (
        (torch.abs(u) <= hl[:, None])
        & (torch.abs(v) <= hw[:, None])
        & (gate_valid[None, :] > 0)
    )
    gated = inside.any(dim=1)
    draw = valid & gated

    # Pixel-center world coordinates.
    hr = np.float32(half_range)
    jj = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) * _f32(
        np.float32(2.0) * hr / np.float32(W)) - float(hr)
    ii = float(hr) - (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) * _f32(
        np.float32(2.0) * hr / np.float32(H))

    def col(t):
        return t[:, None, None]

    # Per-agent layers [A, H, W], 33.5 MB of f32 at 128 agents and 256².
    dx = jj[None, None, :] - col(cx)
    dy = ii[None, :, None] - col(cy)
    uu = dx * col(cos_h) + dy * col(sin_h)
    vv = -dx * col(sin_h) + dy * col(cos_h)
    cover = (torch.abs(uu) <= col(hl)) & (torch.abs(vv) <= col(hw)) & col(draw)
    layers = torch.where(cover, col(blue), 0.0)
    return layers.amax(dim=0)


# ---------------------------------------------------------------------------
# Host-side preparation + full scenario rasterization
# ---------------------------------------------------------------------------

def agent_boxes_from_tracks(
    trajs: np.ndarray,  # [A, T, 11] [cx,cy,cz,l,w,h,heading,vx,vy,valid,type]
    max_agents: int,
    agent_time_index: int = 1,
) -> np.ndarray:
    """[A, T, 11] tracks -> fixed [max_agents, 7] box array, ego@t frame.

    Matches plot_dynamic_objects_v2: vehicles only (type==1), valid at t,
    blue = |pos[t+1] - pos[t]| / 60 + 0.5 (visualization.py:214-248).
    """
    t = agent_time_index
    A, T, _ = trajs.shape
    out = np.zeros((max_agents, 7), np.float32)
    if A == 0 or T <= t + 1:
        return out
    is_vehicle = trajs[:, t, 10] == 1
    valid_t = trajs[:, t, 9] > 0
    speed_px = np.linalg.norm(trajs[:, t + 1, 0:2] - trajs[:, t, 0:2], axis=-1)
    blue = speed_px / 60.0 + 0.5
    keep = np.nonzero(is_vehicle & valid_t)[0][:max_agents]
    out[: len(keep), 0] = trajs[keep, t, 0]
    out[: len(keep), 1] = trajs[keep, t, 1]
    out[: len(keep), 2] = trajs[keep, t, 3]
    out[: len(keep), 3] = trajs[keep, t, 4]
    out[: len(keep), 4] = trajs[keep, t, 6]
    out[: len(keep), 5] = blue[keep]
    out[: len(keep), 6] = 1.0
    return out


def _bucket(n: int, cap: int, floor: int = 32) -> int:
    """Smallest power-of-two budget >= n (clamped to [floor, cap]): the JAX
    package's jit-shape buckets, kept so the splat sees the same padded
    samples."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


def rasterize_scenario(
    scenario_info: dict,
    img_res: int = 256,
    map_range: float = 80.0,
    max_polylines: int = 512,
    max_agents: int = 128,
    with_agent: bool = True,
    background: float = 0.5,
    color_max: float = 0.99,
    agent_time_index: int = 1,
    interp_k: int = 8,
    num_points_each_polyline: int = 100,
    mode: str = "dxdy_agents",
    device="cuda",
) -> np.ndarray:
    """Scenario dict (reference pickle format) -> (H, W, 3) raster in [0,1]
    ((H, W, 1) in occupancy mode), as numpy.

    Lane chunking, ego translation and dxdy normalization, the boxes and
    the gate points are host numpy, as in the JAX package; the splat and
    the agent channel run on `device` (the card unless "cpu" is asked for).
    `map_range` is the TOTAL extent; half-range = map_range / 2.
    """
    device = resolve_device(device)
    half_range = map_range / 2.0
    H = W = img_res

    lanes = scenario_info["lane"]
    all_points = (
        np.vstack([np.asarray(v)[:, :7] for v in lanes.values()])
        if len(lanes)
        else np.zeros((0, 7), np.float32)
    )
    # Column 7 (theta) is unused by the raster; chunking wants 8 cols.
    if all_points.shape[1] == 7:
        all_points = np.concatenate(
            [all_points, np.zeros((len(all_points), 1), np.float32)], axis=1
        )

    trajs = np.asarray(scenario_info["tracks_info"]["trajs"], np.float32)
    sdc = int(scenario_info["sdc_track_index"])
    ego10 = trajs[sdc, 10, 0:2]

    feats, masks = mp.generate_batch_polylines_from_map(
        all_points, num_points_each_polyline=num_points_each_polyline
    )
    if feats.shape[0]:
        feats = mp.transform_scenario(feats, ego10)
        feats = mp.dxdy_normalization(feats, feature_max=color_max)
    feats, masks = mp.pad_polylines(
        feats, masks, _bucket(feats.shape[0] if feats.size else 0, max_polylines)
    )

    rg = rasterize_lane_channels(
        torch.from_numpy(feats).to(device),
        torch.from_numpy(masks).to(device),
        half_range,
        H=H,
        W=W,
        background=background,
        interp_k=interp_k,
    )

    if mode == "occupancy":
        # 1-channel map-only raster (config-1): white lanes on black — any
        # pixel deviating from the gray background.
        dev = torch.maximum(
            torch.abs(rg[..., 0] - background), torch.abs(rg[..., 1] - background)
        )
        occ = torch.clamp(dev / 0.1, 0.0, 1.0)
        return occ[..., None].cpu().numpy()

    if not with_agent:
        b = torch.full((H, W, 1), background, dtype=torch.float32, device=device)
        return torch.cat([rg, b], dim=-1).cpu().numpy()

    # Agent channel: ego frame at agent_time_index (reference uses t=1).
    ego_t = trajs[sdc, agent_time_index, 0:2]
    trajs_shifted = trajs.copy()
    trajs_shifted[:, :, 0:2] -= ego_t[None, None, :]
    boxes = agent_boxes_from_tracks(trajs_shifted, max_agents, agent_time_index)
    # Valid boxes are packed at the front; bucket the agent budget too.
    boxes = boxes[: _bucket(int(boxes[:, 6].sum()), max_agents, floor=8)]

    # Gate lines: the reference uses only full-100-point lane chunks
    # (rasterization.py:102-110) in the LANE frame (ego@10).
    full_chunks = masks.sum(axis=1) == masks.shape[1]
    types_ok = (feats[:, 0, 6] > 1.0) & (feats[:, 0, 6] < 3.0)
    use = full_chunks & types_ok
    gate_xy = feats[..., 0:2].reshape(-1, 2)
    gate_valid = (use[:, None] & masks).reshape(-1).astype(np.float32)

    # cos/sin on the host for every device (module docstring).
    heading = torch.from_numpy(np.ascontiguousarray(boxes[:, 4]))
    cos_sin = torch.stack([torch.cos(heading), torch.sin(heading)], dim=1)

    b = rasterize_agent_channel(
        torch.from_numpy(boxes).to(device),
        torch.from_numpy(np.ascontiguousarray(gate_xy)).to(device),
        torch.from_numpy(gate_valid).to(device),
        half_range,
        H=H,
        W=W,
        cos_sin=cos_sin.to(device),
    )
    return torch.cat([rg, b[..., None]], dim=-1).cpu().numpy()

"""The port's copy of drivescenegen_tpu/vectorize/curves.py.

Curve-fitting primitives (reference: vectorization/curve/).

All fitters return a list of sampled tuples at ~`step` arc-length spacing:
  cubic spline / polynomial / straight line: (x, y, yaw, k, s)
  bezier: (x, y, yaw, dx, dy, s)   [6 cols, as the reference's bezier_curve]

The spline is a natural cubic with arc-length parameterization, solved as a
vectorized tridiagonal system (the reference builds dense matrices per call,
cubic_spline.py:70-88; same math). The Bezier is evaluated in closed form —
no Fortran `bezier` package needed (bezier_curve.py:16-25).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Natural cubic spline
# ---------------------------------------------------------------------------

def _natural_cubic_coeffs(x: np.ndarray, y: np.ndarray):
    """Coefficients a,b,c,d of the natural cubic spline through (x, y)."""
    n = len(x)
    h = np.diff(x)
    A = np.zeros((n, n))
    B = np.zeros(n)
    A[0, 0] = 1.0
    A[n - 1, n - 1] = 1.0
    for i in range(n - 2):
        A[i + 1, i] = h[i]
        A[i + 1, i + 1] = 2.0 * (h[i] + h[i + 1])
        A[i + 1, i + 2] = h[i + 1]
        B[i + 1] = 3.0 * (y[i + 2] - y[i + 1]) / h[i + 1] - 3.0 * (y[i + 1] - y[i]) / h[i]
    c = np.linalg.solve(A, B)
    b = (y[1:] - y[:-1]) / h - h / 3.0 * (2.0 * c[:-1] + c[1:])
    d = (c[1:] - c[:-1]) / (3.0 * h)
    return y.copy(), b, c, d


def _eval_spline(x_grid, a, b, c, d, xq):
    i = np.clip(np.searchsorted(x_grid, xq, side="right") - 1, 0, len(x_grid) - 2)
    dx = xq - x_grid[i]
    pos = a[i] + b[i] * dx + c[i] * dx**2 + d[i] * dx**3
    dpos = b[i] + 2.0 * c[i] * dx + 3.0 * d[i] * dx**2
    ddpos = 2.0 * c[i] + 6.0 * d[i] * dx
    return pos, dpos, ddpos


def fit_cubic_spline(xs: np.ndarray, ys: np.ndarray, step: float = 1.0) -> List[Tuple]:
    """2-D natural cubic spline sampled at `step` arc spacing, trimmed to the
    closest samples to the original endpoints (cubic_spline.py:126-146).
    Returns [(x, y, yaw, k, s), ...]."""
    xs = np.asarray(xs, float)
    ys = np.asarray(ys, float)
    ds = np.hypot(np.diff(xs), np.diff(ys))
    s_grid = np.concatenate([[0.0], np.cumsum(ds)])
    ax, bx, cx, dx_ = _natural_cubic_coeffs(s_grid, xs)
    ay, by, cy, dy_ = _natural_cubic_coeffs(s_grid, ys)

    s = np.arange(0.0, s_grid[-1], step)
    px, dpx, ddpx = _eval_spline(s_grid, ax, bx, cx, dx_, s)
    py, dpy, ddpy = _eval_spline(s_grid, ay, by, cy, dy_, s)
    yaw = np.arctan2(dpy, dpx)
    denom = (dpx**2 + dpy**2) ** 1.5
    k = np.where(denom > 1e-12, (ddpy * dpx - ddpx * dpy) / np.maximum(denom, 1e-12), 0.0)

    d_start = np.hypot(px - xs[0], py - ys[0])
    d_end = np.hypot(px - xs[-1], py - ys[-1])
    start_id = int(np.argmin(d_start))
    end_id = int(np.argmin(d_end))
    rows = list(zip(px, py, yaw, k, s))
    return rows[start_id : end_id + 1]


# ---------------------------------------------------------------------------
# Cubic polynomial (least squares over arc length)
# ---------------------------------------------------------------------------

def fit_cubic_polynomial(xs: np.ndarray, ys: np.ndarray, step: float = 1.0) -> List[Tuple]:
    """Least-squares cubic x(s), y(s) (curve_fit on a cubic is exactly
    polynomial least squares, cubic_polynomial.py:94-114)."""
    xs = np.asarray(xs, float)
    ys = np.asarray(ys, float)
    ds = np.hypot(np.diff(xs), np.diff(ys))
    s_grid = np.concatenate([[0.0], np.cumsum(ds)])
    px_coef = np.polyfit(s_grid, xs, 3)
    py_coef = np.polyfit(s_grid, ys, 3)

    s = np.arange(0.0, s_grid[-1], step)
    px = np.polyval(px_coef, s)
    py = np.polyval(py_coef, s)
    dpx = np.polyval(np.polyder(px_coef), s)
    dpy = np.polyval(np.polyder(py_coef), s)
    ddpx = np.polyval(np.polyder(px_coef, 2), s)
    ddpy = np.polyval(np.polyder(py_coef, 2), s)
    yaw = np.arctan2(dpy, dpx)
    denom = (dpx**2 + dpy**2) ** 1.5
    k = np.where(denom > 1e-12, (ddpy * dpx - ddpx * dpy) / np.maximum(denom, 1e-12), 0.0)

    d_start = np.hypot(px - xs[0], py - ys[0])
    d_end = np.hypot(px - xs[-1], py - ys[-1])
    rows = list(zip(px, py, yaw, k, s))
    return rows[int(np.argmin(d_start)) : int(np.argmin(d_end)) + 1]


# ---------------------------------------------------------------------------
# Straight line
# ---------------------------------------------------------------------------

def fit_straight_line(xs: np.ndarray, ys: np.ndarray, step: int = 1) -> List[Tuple]:
    """Reference straight_line.py:4-13, including its k sentinel and the
    ds = hypot/N normalization quirk."""
    N = len(xs) - 1
    dx = (xs[-1] - xs[0]) / N
    dy = (ys[-1] - ys[0]) / N
    ds = math.hypot(dx, dy) / N
    yaw = math.atan2(dy, dx)
    k = 999999.99
    return [
        (xs[0] + dx * i, ys[0] + dy * i, yaw, k, ds * i)
        for i in np.arange(0, N + 1, step)
    ]


# ---------------------------------------------------------------------------
# Cubic Bezier between two posed endpoints
# ---------------------------------------------------------------------------

def _bezier_eval(P: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Closed-form cubic Bezier; P: [4, 2], t: [T] -> [T, 2]."""
    t = t[:, None]
    mt = 1.0 - t
    return (
        mt**3 * P[0]
        + 3 * mt**2 * t * P[1]
        + 3 * mt * t**2 * P[2]
        + t**3 * P[3]
    )


def _bezier_length(P: np.ndarray, n: int = 256) -> float:
    t = np.linspace(0.0, 1.0, n)
    pts = _bezier_eval(P, t)
    return float(np.hypot(*np.diff(pts, axis=0).T).sum())


def fit_bezier_curve(n1, n2, spacing: float = 1.0) -> np.ndarray:
    """Cubic Bezier from posed endpoints (x, y, yaw); control points at
    dist/3 along each yaw (bezier_curve.py:5-33). Returns
    [T, 6] = (x, y, yaw, dx, dy, s)."""
    dist = math.hypot(n2[0] - n1[0], n2[1] - n1[1]) / 3.0
    p0 = (n1[0], n1[1])
    p1 = (n1[0] + math.cos(n1[2]) * dist, n1[1] + math.sin(n1[2]) * dist)
    p2 = (n2[0] - math.cos(n2[2]) * dist, n2[1] - math.sin(n2[2]) * dist)
    p3 = (n2[0], n2[1])
    P = np.array([p0, p1, p2, p3], float)

    length = _bezier_length(P)
    s = np.linspace(0.0, 1.0, max(2, int(length / spacing)))
    points = _bezier_eval(P, s)
    dx = np.diff(points[:, 0])
    dy = np.diff(points[:, 1])
    yaw = np.arctan2(dy, dx)

    # End tangent (hodograph at t=1 is 3*(P3 - P2)).
    end_tan = 3.0 * (P[3] - P[2])
    end_yaw = math.atan2(end_tan[1], end_tan[0])
    ds = s[-1] - s[-2] if len(s) > 1 else 1.0
    dx = np.append(dx, ds * math.cos(end_yaw))
    dy = np.append(dy, ds * math.sin(end_yaw))
    yaw = np.append(yaw, end_yaw)
    s = s * length

    return np.stack((points[:, 0], points[:, 1], yaw, dx, dy, s), axis=-1)

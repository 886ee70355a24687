"""Host-side visualization: preview and closed-loop telemetry plots (≙
``quadruped_locomotion_tpu/viz/plot.py``).

Rendering draws on host copies of recorded tensors: a preview
:class:`~..rollout.preview.StateBatch` or closed-loop telemetry
(``rollout.closed_loop.rollout`` at one scenario, with the scenario axis
dropped, or ``rollout.script_loop.run_schedule``), written to PNG files.
The JAX package draws with matplotlib; the machines the port runs on
with a card need not have it, so the figure is rasterized here with numpy
(:mod:`.raster`). Nothing here runs on the device path.

Figure anatomy (both entry points, 1100 x 800 pixels, as the reference's
11 x 8 inch figure): a top-down track (torso path, swing trajectories,
footholds at touchdowns, the final support polygon), the height profile
(base and feet), the support gantt (stance bars per leg) and a progress
strip (the schedule's step index, or the QP's KKT on a log scale). Per-leg
colors are the Okabe-Ito colorblind-safe set in fixed leg order; identity
is also carried by the legend and the marker shape.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .raster import GLYPH_H, GLYPH_W, Canvas

LEG_NAMES = ("LF", "RF", "RH", "LH")
# Okabe–Ito colorblind-safe categorical colors, fixed leg order.
LEG_COLORS = ("#0072B2", "#E69F00", "#009E73", "#CC79A7")
LEG_MARKERS = ("o", "s", "^", "D")
INK = "#333333"
GRID = "#DDDDDD"
FIG_W, FIG_H = 1100, 800


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ticks(lo: float, hi: float, n: int = 5) -> np.ndarray:
    """Round tick values covering [lo, hi]."""
    step = 10 ** math.floor(math.log10((hi - lo) / n))
    for m in (1, 2, 5, 10):
        if (hi - lo) / (m * step) <= n:
            step *= m
            break
    return np.arange(math.ceil(lo / step), math.floor(hi / step) + 1) * step


def _label(v: float, log: bool) -> str:
    if log:
        return (f"1e{int(round(v))}" if abs(v - round(v)) < 1e-9
                else f"{10 ** v:.1e}")
    return f"{v:.6g}" if abs(v) >= 1e-9 else "0"


class _Axes:
    """One panel: a pixel box, data limits, grid, ticks and labels."""

    def __init__(self, cv: Canvas, box, title: str, xlabel: str | None,
                 ylabel: str | None, x, y, equal: bool = False,
                 logy: bool = False, ytick_labels: bool = True):
        self.cv, self.logy = cv, logy
        x0, y0, x1, y1 = box
        self.box = (x0 + 70, y0 + 28, x1 - 12, y1 - 40)  # plot area
        px0, py0, px1, py1 = self.box
        y = np.log10(y) if logy else np.asarray(y, float)
        xlim = self._lim(np.asarray(x, float))
        ylim = self._lim(y)
        if equal:  # one data unit per pixel on both axes ('datalim')
            sx = (xlim[1] - xlim[0]) / (px1 - px0)
            sy = (ylim[1] - ylim[0]) / (py1 - py0)
            s = max(sx, sy)
            cx, cy = sum(xlim) / 2, sum(ylim) / 2
            xlim = (cx - s * (px1 - px0) / 2, cx + s * (px1 - px0) / 2)
            ylim = (cy - s * (py1 - py0) / 2, cy + s * (py1 - py0) / 2)
        self.xlim, self.ylim = xlim, ylim
        for v in _ticks(*xlim):
            c = self.px(v, ylim[0], raw=True)[0]
            cv.line([c, c], [py0, py1], GRID)
            cv.text(c, py1 + 4, _label(v, False), INK, "center")
        for v in _ticks(*ylim):
            r = self.px(xlim[0], v, raw=True)[1]
            cv.line([px0, px1], [r, r], GRID)
            if ytick_labels:
                cv.text(px0 - 4, r - GLYPH_H // 2, _label(v, logy), INK,
                        "right")
        cv.line([px0, px0, px1], [py0, py1, py1], INK)  # left and bottom
        cv.text((px0 + px1) / 2, y0 + 6, title, INK, "center")
        if xlabel:
            cv.text((px0 + px1) / 2, py1 + 4 + GLYPH_H + 2, xlabel, INK,
                    "center")
        if ylabel:
            cv.text(x0 + 4, y0 + 6, ylabel, INK)

    @staticmethod
    def _lim(v: np.ndarray):
        v = v[np.isfinite(v)]
        lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
        pad = 0.05 * (hi - lo) if hi > lo else max(abs(hi), 1.0) * 0.05
        return lo - pad, hi + pad

    def px(self, x, y, raw: bool = False):
        """Data -> pixel coordinates (y already log10 when ``raw``)."""
        px0, py0, px1, py1 = self.box
        x, y = np.asarray(x, float), np.asarray(y, float)
        if self.logy and not raw:
            y = np.log10(y)
        c = px0 + (x - self.xlim[0]) / (self.xlim[1] - self.xlim[0]) * (px1 - px0)
        r = py1 - (y - self.ylim[0]) / (self.ylim[1] - self.ylim[0]) * (py1 - py0)
        return c, r

    def plot(self, x, y, color, width=1, step=False):
        if step:  # 'post' steps
            x = np.repeat(np.asarray(x, float), 2)[1:]
            y = np.repeat(np.asarray(y, float), 2)[:-1]
        self.cv.line(*self.px(x, y), color, width)

    def legend(self, entries) -> None:
        """(label, color, marker or None) rows at the panel's top right."""
        px0, py0, px1, py1 = self.box
        w = max(len(s) for s, _, _ in entries) * GLYPH_W + 30
        x, y = px1 - w, py0 + 4
        self.cv.rect(x - 4, y - 2, px1 - 2, y + len(entries) * 16 + 2,
                     "#FFFFFF", 0.7)
        for i, (s, color, mk) in enumerate(entries):
            yy = y + i * 16
            if mk is None:
                self.cv.line([x, x + 18], [yy + 7, yy + 7], color, 2)
            else:
                self.cv.marker(x + 9, yy + 7, mk, color, 4)
            self.cv.text(x + 24, yy, s, INK)


def _support_polygon_xy(feet_xy, support):
    """Counter-clockwise hull of the supporting feet (≤ 4 points)."""
    pts = feet_xy[np.asarray(support, bool)]
    if len(pts) < 3:
        return pts
    c = pts.mean(axis=0)
    ang = np.arctan2(pts[:, 1] - c[1], pts[:, 0] - c[0])
    return pts[np.argsort(ang)]


def _plot_track(cv, box, base_xy, feet, support):
    """Top-down torso path + swing trajectories + footholds + polygon."""
    T = len(base_xy)
    sup = np.asarray(support, bool)
    xs = np.concatenate([base_xy[:, 0], feet[:, :, 0].ravel()])
    ys = np.concatenate([base_xy[:, 1], feet[:, :, 1].ravel()])
    ax = _Axes(cv, box, "top-down track", "x [m]", "y [m]", xs, ys,
               equal=True)
    poly = _support_polygon_xy(feet[-1, :, :2], sup[-1])
    if len(poly) >= 3:
        cv.polygon(*ax.px(poly[:, 0], poly[:, 1]), "#888888", 0.15)
    ax.plot(base_xy[:, 0], base_xy[:, 1], INK, 2)
    for leg in range(4):
        # swing trajectories: stance ticks masked out
        fx = np.where(sup[:, leg], np.nan, feet[:, leg, 0])
        fy = np.where(sup[:, leg], np.nan, feet[:, leg, 1])
        ax.plot(fx, fy, LEG_COLORS[leg])
    for leg in range(4):
        # foothold marks at touchdowns (swing → support transitions)
        td = np.flatnonzero(sup[1:, leg] & ~sup[:-1, leg]) + 1
        marks = np.concatenate([[0], td, [T - 1]])
        cv.marker(*ax.px(feet[marks, leg, 0], feet[marks, leg, 1]),
                  LEG_MARKERS[leg], LEG_COLORS[leg], 4)
    ax.legend([("torso", INK, None)]
              + [(f"{LEG_NAMES[i]} foothold", LEG_COLORS[i], LEG_MARKERS[i])
                 for i in range(4)] + [("final support", "#BBBBBB", "s")])


def _plot_heights(cv, box, times, base_z, feet_z):
    ax = _Axes(cv, box, "heights", "t [s]", "z [m]", times,
               np.concatenate([base_z, feet_z.ravel()]))
    ax.plot(times, base_z, INK, 2)
    for leg in range(4):
        ax.plot(times, feet_z[:, leg], LEG_COLORS[leg])
    ax.legend([("base", INK, None)] + [(LEG_NAMES[i], LEG_COLORS[i], None)
                                       for i in range(4)])


def _plot_support_gantt(cv, box, times, support):
    sup = np.asarray(support, bool)
    dt = times[1] - times[0] if len(times) > 1 else 0.01
    ax = _Axes(cv, box, "support (stance bars)", "t [s]", None,
               [times[0], times[-1] + dt], [-0.6, 3.6], ytick_labels=False)
    for leg in range(4):
        on = sup[:, leg]
        edges = np.flatnonzero(np.diff(on.astype(int)))
        starts = np.concatenate([[0], edges + 1])
        ends = np.concatenate([edges + 1, [len(on)]])
        row = 3 - leg
        for s, e in zip(starts, ends):
            if on[s]:
                x0, y0 = ax.px(times[s], row + 0.35)
                x1, y1 = ax.px(times[e - 1] + dt, row - 0.35)
                cv.rect(x0, y0, x1, y1, LEG_COLORS[leg])
        cv.text(ax.box[0] - 4, ax.px(0.0, row)[1] - GLYPH_H // 2,
                LEG_NAMES[leg], INK, "right")


def _figure(title, base, feet, support, times, progress) -> Canvas:
    cv = Canvas(FIG_W, FIG_H)
    cv.text(FIG_W / 2, 8, title, INK, "center")
    hw, hh, top = FIG_W // 2, (FIG_H - 30) // 2, 30
    _plot_track(cv, (0, top, hw, top + hh), base[:, :2], feet, support)
    _plot_heights(cv, (hw, top, FIG_W, top + hh), times, base[:, 2],
                  feet[:, :, 2])
    _plot_support_gantt(cv, (0, top + hh, hw, FIG_H), times, support)
    progress(cv, (hw, top + hh, FIG_W, FIG_H))
    return cv


def plot_preview(batch, path: str, title: str | None = None) -> str:
    """Render a preview :class:`~..rollout.preview.StateBatch` to a PNG —
    ≙ the RViz preview display + markers, as a static storyboard."""
    times = _host(batch.times)
    step_index = _host(batch.step_index)

    def progress(cv, box):
        ax = _Axes(cv, box, "schedule progress", "t [s]", "step index",
                   times, step_index)
        ax.plot(times, step_index, INK, 2, step=True)

    return _figure(title or "free-gait preview", _host(batch.base_position),
                   _host(batch.feet_world), _host(batch.support), times,
                   progress).save_png(path)


def plot_telemetry(tel: dict, path: str, title: str | None = None) -> str:
    """Render closed-loop rollout telemetry (the dict produced by
    ``rollout.closed_loop.rollout`` / ``rollout.script_loop.run_schedule``)
    to a PNG — ≙ the controller's ``/capture_log_data`` ring-buffer replay
    plots + the rqt monitor progress view."""
    tel = {k: _host(v) for k, v in tel.items() if not isinstance(v, dict)}
    base = tel["base_position"]
    feet = tel["feet_world"]
    T = len(base)
    times = np.arange(T) * 0.01  # planner ticks
    support = tel.get("support")
    if support is None:
        # script_loop telemetry: infer stance from foot height
        support = feet[:, :, 2] < 0.01

    def progress(cv, box):
        if "qp_kkt" in tel:
            kkt = np.maximum(tel["qp_kkt"].reshape(T, -1).max(axis=1), 1e-12)
            ax = _Axes(cv, box, "force-distribution QP health", "t [s]",
                       "max KKT", times, kkt, logy=True)
            ax.plot(times, kkt, INK, 2)
        elif "step_index" in tel:
            ax = _Axes(cv, box, "schedule progress", "t [s]", "step index",
                       times, tel["step_index"])
            ax.plot(times, tel["step_index"], INK, 2, step=True)

    return _figure(title or "closed-loop telemetry", base, feet, support,
                   times, progress).save_png(path)

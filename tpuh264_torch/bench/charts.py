# Copy of tpuh264/bench/charts.py, so that the port imports nothing of tpuh264.
"""Dependency-free SVG chart export for the benchmark harness.

The reference renders Chart.js line-chart groups from its automation
matrix -- FPS vs resolution and decode-time vs resolution, one dataset
per stream count, grouped per implementation/thread config
(reference/scripts/automation.js:119-153).  This module emits the
same two chart families as standalone SVG files, with no plotting
dependency (the image has none baked in).

Design rules follow the dataviz method: categorical hues assigned in
fixed slot order (validated default palette, light mode), one y-axis per
chart, 2px series lines with >=8px markers, a legend plus direct labels
at line ends, text in neutral ink (never the series color), and a
recessive grid.  The JSON results file is the chart's table view.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

# validated categorical palette (light mode), fixed slot order
_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100",
           "#e87ba4", "#008300", "#4a3aa7", "#e34948"]
_INK = "#1a1a1a"
_MUTED = "#6b6b6b"
_GRID = "#e3e3e3"

_W, _H = 640, 400
_ML, _MR, _MT, _MB = 64, 120, 48, 56


def _fmt(v: float) -> str:
    return f"{v:.3f}".rstrip("0").rstrip(".")


def line_chart(
    title: str,
    x_labels: Sequence[str],
    series: Dict[str, List[float]],
    y_label: str,
) -> str:
    """One SVG line chart: x = ordinal labels, one line per series."""
    vals = [v for ys in series.values() for v in ys if v == v]
    y_max = max(vals, default=1.0) * 1.12 or 1.0
    pw = _W - _ML - _MR
    ph = _H - _MT - _MB

    def xc(i: int) -> float:
        n = max(len(x_labels) - 1, 1)
        return _ML + pw * (i / n if len(x_labels) > 1 else 0.5)

    def yc(v: float) -> float:
        return _MT + ph * (1.0 - v / y_max)

    out = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{_W}" '
        f'height="{_H}" viewBox="0 0 {_W} {_H}" font-family="system-ui, '
        f'sans-serif">',
        f'<rect width="{_W}" height="{_H}" fill="#ffffff"/>',
        f'<text x="{_ML}" y="24" font-size="15" font-weight="600" '
        f'fill="{_INK}">{title}</text>',
    ]
    # recessive grid + y ticks (4 steps)
    for i in range(5):
        v = y_max * i / 4
        y = yc(v)
        out.append(
            f'<line x1="{_ML}" y1="{y:.1f}" x2="{_W - _MR}" y2="{y:.1f}" '
            f'stroke="{_GRID}" stroke-width="1"/>'
        )
        out.append(
            f'<text x="{_ML - 8}" y="{y + 4:.1f}" font-size="11" '
            f'text-anchor="end" fill="{_MUTED}">{_fmt(v)}</text>'
        )
    out.append(
        f'<text x="16" y="{_MT - 10}" font-size="11" '
        f'fill="{_MUTED}">{y_label}</text>'
    )
    for i, lbl in enumerate(x_labels):
        out.append(
            f'<text x="{xc(i):.1f}" y="{_H - _MB + 20}" font-size="11" '
            f'text-anchor="middle" fill="{_MUTED}">{lbl}</text>'
        )

    for si, (name, ys) in enumerate(series.items()):
        color = _SERIES[si % len(_SERIES)]
        pts = [
            (xc(i), yc(v)) for i, v in enumerate(ys) if v == v
        ]
        if not pts:
            continue
        path = " ".join(
            f"{'M' if i == 0 else 'L'}{x:.1f},{y:.1f}"
            for i, (x, y) in enumerate(pts)
        )
        out.append(
            f'<path d="{path}" fill="none" stroke="{color}" '
            f'stroke-width="2" stroke-linejoin="round"/>'
        )
        for x, y in pts:
            out.append(
                f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" fill="{color}" '
                f'stroke="#ffffff" stroke-width="2"/>'
            )
        # legend entry + direct label at line end (text in neutral ink)
        ly = _MT + 18 * si
        out.append(
            f'<rect x="{_W - _MR + 12}" y="{ly - 8}" width="10" '
            f'height="10" rx="2" fill="{color}"/>'
        )
        out.append(
            f'<text x="{_W - _MR + 28}" y="{ly + 1}" font-size="11" '
            f'fill="{_INK}">{name}</text>'
        )
        ex, ey = pts[-1]
        out.append(
            f'<text x="{ex + 8:.1f}" y="{ey + 4:.1f}" font-size="10" '
            f'fill="{_MUTED}">{_fmt(ys[-1])}</text>'
        )
    out.append("</svg>")
    return "\n".join(out)


def render_charts(results: List[Dict], path_prefix: str) -> List[str]:
    """Write the reference's two chart families per (impl, threads)
    group: aggregate FPS vs resolution and avg decode ms vs resolution,
    one series per stream count (automation.js:119-153)."""
    groups: Dict[tuple, List[Dict]] = {}
    for r in results:
        cfg = r["config"]
        groups.setdefault(
            (cfg.get("impl", "tpu"), cfg.get("threads", 0)), []
        ).append(r)
    written = []
    for (impl, threads), rows in groups.items():
        res_order = []
        stream_counts = []
        for r in rows:
            res = r["config"]["res"]
            s = r["config"]["streams"]
            if res not in res_order:
                res_order.append(res)
            if s not in stream_counts:
                stream_counts.append(s)
        stream_counts.sort()

        def series_for(metric):
            out: Dict[str, List[float]] = {}
            for s in stream_counts:
                ys = []
                for res in res_order:
                    v = float("nan")
                    for r in rows:
                        if (r["config"]["res"] == res
                                and r["config"]["streams"] == s):
                            v = float(r.get(metric, float("nan")))
                    ys.append(v)
                out[f"{s} stream{'s' if s != 1 else ''}"] = ys
            return out

        tag = f"{impl}-t{threads}"
        for metric, ylabel, fname in (
            ("frames_per_s_aggregate", "frames/s (aggregate)", "fps"),
            ("avg_decode_ms", "decode ms / frame", "decode"),
        ):
            svg = line_chart(
                f"{metric.replace('_', ' ')} - {impl}, threads={threads}",
                res_order, series_for(metric), ylabel,
            )
            path = f"{path_prefix}-{tag}-{fname}.svg"
            with open(path, "w") as f:
                f.write(svg)
            written.append(path)
    return written

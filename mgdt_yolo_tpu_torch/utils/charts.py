"""The charts of the JAX package's `utils/plotting.py` and
`ConfusionMatrix.plot`, without matplotlib: a small renderer over the
port's rasteriser (`utils/draw.py`) with axes, ticks, text, bars, 2-D
histograms, line plots and heatmaps, coloured by matplotlib's `Blues` and
`viridis` (committed 256-entry tables, `native/colormaps.npz`, probed by
`tests/torch_draw_probe.py`; a value v in [0, 1] takes entry
`min(int(v * 256), 255)`, as matplotlib's).

Each chart writes the file JAX writes, at JAX's pixel size (figsize x dpi),
from the same data; its pixels are the port's own, not matplotlib's.
`feature_visualization`'s size is matplotlib's to decide in JAX
(`bbox_inches="tight"`); here it is n x 160 px square for n x n tiles.
The binning is matplotlib's: `label_bins` holds it.
"""
from __future__ import annotations

import csv as csv_mod
import functools
import logging
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from . import draw

LOGGER = logging.getLogger(__name__)
COLORMAPS = Path(__file__).resolve().parents[1] / "native" / "colormaps.npz"
# matplotlib's default colour cycle (tab10), BGR
CYCLE = [(180, 119, 31), (14, 127, 255), (44, 160, 44), (40, 39, 214), (189, 103, 148),
         (75, 86, 140), (194, 119, 227), (127, 127, 127), (34, 189, 188), (207, 190, 23)]
BLACK, WHITE, GREY = (0, 0, 0), (255, 255, 255), (176, 176, 176)
SMALL, LARGE = 0.5, 2 / 3   # probed text scales: tick labels, titles and axis labels


@functools.cache
def colormap(name: str) -> np.ndarray:
    """(256, 3) uint8 BGR entries of matplotlib's colormap `name`."""
    with np.load(COLORMAPS) as f:
        return np.ascontiguousarray(f[name][:, ::-1])


def colorize(values: np.ndarray, name: str, vmin: float, vmax: float) -> np.ndarray:
    """BGR colours of `values` normalised to [vmin, vmax], as matplotlib
    maps them."""
    x = (np.asarray(values, np.float64) - vmin) / ((vmax - vmin) or 1.0)
    idx = np.clip((np.clip(x, 0, 1) * 256).astype(int), 0, 255)
    return colormap(name)[idx]


def _blend_alpha(img, alpha, x0, y0, col):
    """Blend a colour into `img` through an alpha bitmap at (x0, y0),
    clipped, with the text's arithmetic."""
    h, w = alpha.shape
    ya, yb = max(y0, 0), min(y0 + h, img.shape[0])
    xa, xb = max(x0, 0), min(x0 + w, img.shape[1])
    if ya >= yb or xa >= xb:
        return
    a = alpha[ya - y0:yb - y0, xa - x0:xb - x0].astype(np.int32)[..., None]
    region = img[ya:yb, xa:xb].astype(np.int32)
    img[ya:yb, xa:xb] = ((region * (255 - a) + np.asarray(col) * a + 127) // 255).astype(np.uint8)


def text(img, s: str, x: float, y: float, scale: float = SMALL, col=BLACK, ha: str = "left",
         va: str = "bottom", rotate: bool = False):
    """Text anchored at (x, y) by `ha` (left, center, right) and `va` (top,
    center, bottom) of its box; `rotate` turns it 90 degrees to read upward."""
    s = str(s)
    if not s:
        return
    (w, h), base = draw.get_text_size(s, scale, 1)
    alpha = np.zeros((h + base + 2, w + 2), np.uint8)
    draw.put_text(alpha, s, (1, h), scale, 255, 1)
    if rotate:
        alpha = np.ascontiguousarray(np.rot90(alpha))
    ah, aw = alpha.shape
    x0 = x - {"left": 0, "center": aw / 2, "right": aw}[ha]
    y0 = y - {"top": 0, "center": ah / 2, "bottom": ah}[va]
    _blend_alpha(img, alpha, int(round(x0)), int(round(y0)), col)


def nice_ticks(lo: float, hi: float, n: int = 5):
    """Round tick values in [lo, hi], about `n` of them."""
    if hi <= lo:
        return [lo]
    raw = (hi - lo) / max(n, 1)
    mag = 10 ** np.floor(np.log10(raw))
    step = next(m * mag for m in (1, 2, 2.5, 5, 10) if m * mag >= raw)
    first = np.ceil(lo / step - 1e-9) * step
    return [round(v, 10) for v in np.arange(first, hi + step * 1e-6, step)]


def _fmt(v: float) -> str:
    return f"{v:g}"


class Axes:
    """A plot box of a canvas, in pixels (x0, y0, x1, y1), with data
    limits; y grows upward."""

    def __init__(self, img, box, xlim=(0.0, 1.0), ylim=(0.0, 1.0)):
        self.img, self.box = img, box
        self.xlim, self.ylim = xlim, ylim

    def px(self, x, y):
        x0, y0, x1, y1 = self.box
        (a, b), (c, d) = self.xlim, self.ylim
        u = x0 + (np.asarray(x, np.float64) - a) / ((b - a) or 1.0) * (x1 - x0)
        v = y1 - (np.asarray(y, np.float64) - c) / ((d - c) or 1.0) * (y1 - y0)
        return u, v

    def frame(self, xticks=None, yticks=None, xlabels=None, rotate_x=False):
        """The box, ticks on its left and bottom sides with their labels."""
        x0, y0, x1, y1 = self.box
        xticks = nice_ticks(*self.xlim) if xticks is None else xticks
        yticks = nice_ticks(*self.ylim) if yticks is None else yticks
        labels = xlabels or [_fmt(t) for t in xticks]
        for t, lab in zip(xticks, labels):
            u = int(round(float(self.px(t, self.ylim[0])[0])))
            draw.line(self.img, (u, y1), (u, y1 + 5), BLACK)
            if rotate_x:
                text(self.img, lab, u, y1 + 8, SMALL, ha="center", va="top", rotate=True)
            else:
                text(self.img, lab, u, y1 + 8, SMALL, ha="center", va="top")
        for t in yticks:
            v = int(round(float(self.px(self.xlim[0], t)[1])))
            draw.line(self.img, (x0 - 5, v), (x0, v), BLACK)
            text(self.img, _fmt(t), x0 - 8, v, SMALL, ha="right", va="center")
        draw.rectangle(self.img, (x0, y0), (x1, y1), BLACK, 1)

    def labels(self, xlabel: str = "", ylabel: str = "", title: str = "", pad: int = 60):
        x0, y0, x1, y1 = self.box
        if xlabel:
            text(self.img, xlabel, (x0 + x1) / 2, y1 + pad, LARGE, ha="center", va="top")
        if ylabel:
            text(self.img, ylabel, x0 - pad, (y0 + y1) / 2, LARGE, ha="right", va="center",
                 rotate=True)
        if title:
            text(self.img, title, (x0 + x1) / 2, y0 - 8, LARGE, ha="center", va="bottom")

    def bars(self, lefts, heights, width, col=CYCLE[0]):
        for left, hgt in zip(lefts, heights):
            (u0, u1), (v0, v1) = self.px([left, left + width], [0, hgt])
            draw.rectangle(self.img, (int(round(u0)), int(round(v1))),
                           (int(round(u1)), int(round(v0))), col, -1)

    def heatmap(self, colors: np.ndarray, upward: bool = True):
        """Fill the box with a (rows, cols, 3) colour grid, nearest
        neighbour; row 0 at the bottom when `upward` (hist2d), else at the
        top (imshow)."""
        x0, y0, x1, y1 = self.box
        hh, ww = y1 - y0 + 1, x1 - x0 + 1
        rows = np.minimum((np.arange(hh) + 0.5) * colors.shape[0] / hh, colors.shape[0] - 1)
        cols = np.minimum((np.arange(ww) + 0.5) * colors.shape[1] / ww, colors.shape[1] - 1)
        grid = colors[rows.astype(int)][:, cols.astype(int)]
        self.img[y0:y1 + 1, x0:x1 + 1] = grid[::-1] if upward else grid

    def plot(self, xs, ys, col=CYCLE[0], marker: bool = True):
        u, v = self.px(xs, ys)
        pts = np.stack([u, v], 1) * 16
        if len(pts) > 1:
            draw.polylines(self.img, np.rint(pts), False, col, 2, draw.LINE_AA, 4)
        if marker:
            for p in np.rint(pts):
                draw.circle(self.img, p, 3 * 16, col, -1, draw.LINE_AA, 4)


def canvas(width: int, height: int) -> np.ndarray:
    return np.full((height, width, 3), 255, np.uint8)


def subplot_boxes(width: int, height: int, rows: int, cols: int, left=90, right=30, top=50,
                  bottom=90):
    """The plot box of each cell of a rows x cols grid, row-major."""
    cw, ch = width / cols, height / rows
    return [(int(c * cw + left), int(r * ch + top), int((c + 1) * cw - right),
             int((r + 1) * ch - bottom)) for r in range(rows) for c in range(cols)]


def label_bins(boxes: np.ndarray, cls: np.ndarray) -> Dict[str, tuple]:
    """What `plot_labels` bins, as matplotlib bins it: `classes` the
    instances per class (bins `arange(nc + 1) - 0.5`), `xy` and `wh` the
    50 x 50 2-D histograms of the centres and the sizes (np.histogram2d
    over the data's range), each (counts, edges...)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    cls = np.asarray(cls).astype(int).ravel()
    nc = int(cls.max()) + 1 if len(cls) else 1
    out = {"classes": np.histogram(cls, bins=np.arange(nc + 1) - 0.5)}
    if len(boxes):
        out["xy"] = np.histogram2d(boxes[:, 0], boxes[:, 1], bins=50)
        out["wh"] = np.histogram2d(boxes[:, 2], boxes[:, 3], bins=50)
    return out


def plot_labels(boxes: np.ndarray, cls: np.ndarray, names: Dict[int, str],
                save_dir: str = "."):
    """Dataset label statistics -> `<save_dir>/labels.jpg`, 1200 x 1200
    (JAX's figsize (10, 10) at dpi 120): instances per class, the first 500
    box outlines about a common centre, and the 2-D histograms of the
    centres and sizes.

    boxes: (n, 4) normalised xywh; cls: (n,) class ids.
    """
    bins = label_bins(boxes, cls)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    img = canvas(1200, 1200)
    b00, b01, b10, b11 = subplot_boxes(1200, 1200, 2, 2, bottom=130)
    counts, edges = bins["classes"]
    nc = len(counts)
    ax = Axes(img, b00, (float(edges[0]), float(edges[-1])), (0.0, max(counts.max(), 1) * 1.05))
    ax.bars(edges[:-1] + 0.1, counts, 0.8)
    ax.frame(xticks=list(range(nc)), xlabels=[str(names.get(i, i)) for i in range(nc)],
             rotate_x=True)
    ax.labels(ylabel="instances")
    ax = Axes(img, b01)
    for row in boxes[:500]:
        w, h = float(row[2]), float(row[3])
        (u0, u1), (v0, v1) = ax.px([0.5 - w / 2, 0.5 + w / 2], [0.5 - h / 2, 0.5 + h / 2])
        draw.rectangle(img, (int(round(u0)), int(round(v1))), (int(round(u1)), int(round(v0))),
                       CYCLE[0], 1)
    ax.frame()
    ax.labels(title="boxes")
    for box, key, (xl, yl) in ((b10, "xy", ("x", "y")), (b11, "wh", ("width", "height"))):
        if key in bins:
            h2, xe, ye = bins[key]
            ax = Axes(img, box, (float(xe[0]), float(xe[-1])), (float(ye[0]), float(ye[-1])))
            ax.heatmap(colorize(h2.T, "Blues", 0.0, float(h2.max())))
        else:
            ax = Axes(img, box)
        ax.frame()
        ax.labels(xlabel=xl, ylabel=yl)
    out = Path(save_dir) / "labels.jpg"
    out.parent.mkdir(parents=True, exist_ok=True)
    draw.imwrite(out, img)
    return str(out)


def plot_results(csv_file: str, out: Optional[str] = None):
    """Training curves of every column of results.csv against `epoch`,
    2 rows of ceil(n / 2) panels of 480 x 480 (JAX's figsize (4 per column,
    8) at dpi 120), to `results.png` beside the file."""
    with open(csv_file) as f:
        rows = list(csv_mod.DictReader(f))
    if not rows:
        LOGGER.warning(f"no rows in {csv_file}")
        return None
    keys = [k for k in rows[0] if k != "epoch"]
    ncol = (len(keys) + 1) // 2
    img = canvas(480 * ncol, 960)
    x = np.asarray([float(r["epoch"]) for r in rows])
    for box, k in zip(subplot_boxes(480 * ncol, 960, 2, ncol), keys):
        y = np.asarray([float(r[k]) for r in rows])
        lo, hi = float(y.min()), float(y.max())
        pad = (hi - lo) * 0.05 or 0.5
        xpad = (x.max() - x.min()) * 0.05 or 0.5
        ax = Axes(img, box, (x.min() - xpad, x.max() + xpad), (lo - pad, hi + pad))
        ax.plot(x, y)
        ax.frame()
        ax.labels(xlabel="epoch", title=k, pad=30)
    out = out or str(Path(csv_file).with_name("results.png"))
    draw.imwrite(out, img)
    return out


def plot_pr_curves(model_stats: Dict[str, Dict], out: str = "pr_curves.png"):
    """Precision against recall per model, each labelled with its mAP50,
    840 x 720 (JAX's figsize (7, 6) at dpi 120). model_stats: name ->
    `DetMetrics.per_class`-like dicts of `recall`, `precision`, `ap`."""
    img = canvas(840, 720)
    ax = Axes(img, subplot_boxes(840, 720, 1, 1)[0])
    legend = []
    for i, (name, r) in enumerate(model_stats.items()):
        ap = float(np.mean(np.asarray(r["ap"])[:, 0])) if len(r.get("ap", [])) else 0.0
        col = CYCLE[i % len(CYCLE)]
        ax.plot(np.atleast_1d(r.get("recall", [0])), np.atleast_1d(r.get("precision", [0])), col)
        legend.append((f"{name} (mAP50 {ap:.3f})", col))
    ax.frame()
    ax.labels(xlabel="Recall", ylabel="Precision")
    x1, y0 = ax.box[2], ax.box[1]
    for j, (lab, col) in enumerate(legend):
        y = y0 + 20 + 22 * j
        draw.line(img, (x1 - 260, y), (x1 - 230, y), col, 2, draw.LINE_AA)
        text(img, lab, x1 - 222, y, SMALL, va="center")
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    draw.imwrite(out, img)
    return out


def feature_visualization(feats, layer_idx: int, out_dir: str = "features",
                          max_channels: int = 32):
    """The first `max_channels` channels of a (1, H, W, C) activation as an
    n x n grid of viridis tiles (each scaled to its own range, as imshow
    does), 160 px a tile, to `<out_dir>/layer_<layer_idx>.png`."""
    x = np.asarray(feats)[0]
    c = min(max_channels, x.shape[-1])
    n = int(np.ceil(c ** 0.5))
    tile = 160
    img = canvas(n * tile, n * tile)
    for i in range(c):
        r, q = divmod(i, n)
        a = x[..., i].astype(np.float64)
        ax = Axes(img, (q * tile + 4, r * tile + 4, (q + 1) * tile - 5, (r + 1) * tile - 5))
        ax.heatmap(colorize(a, "viridis", float(a.min()), float(a.max())), upward=False)
    out = Path(out_dir) / f"layer_{layer_idx}.png"
    out.parent.mkdir(parents=True, exist_ok=True)
    draw.imwrite(out, img)
    return str(out)


def plot_confusion_matrix(m: np.ndarray, labels: Sequence[str], annotate: bool,
                          out: Path) -> str:
    """`ConfusionMatrix.plot`'s figure: the (normalised) matrix as a Blues
    heatmap from 0 to its maximum with a colour bar, the class names on
    both axes, values above 0.005 written in their cells with `annotate`;
    960 x 840 (JAX's figsize (8, 7) at dpi 120)."""
    img = canvas(960, 840)
    k = len(labels)
    ax = Axes(img, (150, 30, 150 + 640, 30 + 640), (-0.5, k - 0.5), (k - 0.5, -0.5))
    vmax = float(m.max()) or 1.0
    ax.heatmap(colorize(m, "Blues", 0.0, vmax), upward=False)
    if annotate:
        for i in range(k):
            for j in range(k):
                if m[i, j] > 0.005:
                    u, v = ax.px(j, i)
                    col = WHITE if m[i, j] / vmax > 0.5 else BLACK
                    text(img, f"{m[i, j]:.2f}", float(u), float(v), SMALL, col, ha="center",
                         va="center")
    ax.frame(xticks=list(range(k)), yticks=[], xlabels=list(labels), rotate_x=True)
    for i, lab in enumerate(labels):
        v = int(round(float(ax.px(0, i)[1])))
        draw.line(img, (ax.box[0] - 5, v), (ax.box[0], v), BLACK)
        text(img, lab, ax.box[0] - 8, v, SMALL, ha="right", va="center")
    text(img, "True", (ax.box[0] + ax.box[2]) / 2, 820, LARGE, ha="center", va="bottom")
    text(img, "Predicted", 20, (ax.box[1] + ax.box[3]) / 2, LARGE, ha="left", va="center",
         rotate=True)
    bar = Axes(img, (830, 30, 860, 670), (0, 1), (0.0, vmax))
    bar.heatmap(colorize(np.linspace(0, vmax, 256)[:, None], "Blues", 0.0, vmax))
    draw.rectangle(img, (830, 30), (860, 670), BLACK, 1)
    for t in nice_ticks(0.0, vmax):
        v = int(round(float(bar.px(0, t)[1])))
        draw.line(img, (860, v), (865, v), BLACK)
        text(img, _fmt(t), 869, v, SMALL, ha="left", va="center")
    out.parent.mkdir(parents=True, exist_ok=True)
    draw.imwrite(out, img)
    return str(out)

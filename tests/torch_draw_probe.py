"""The committed data of the port's drawing, probed on a machine with cv2
and matplotlib: the glyph atlas of its text rasteriser (from cv2) and the
256-entry colormaps of its charts (matplotlib's `Blues` and `viridis`).

cv2 5's `putText` with `FONT_HERSHEY_SIMPLEX` draws anti-aliased outline
glyphs, the same under `LINE_8` and `LINE_AA`, at a regular weight for
thickness 1 and a bold one for every thickness above. A string is drawn as
its glyphs one after another, each alpha-blended onto the image
(`(bg * (255 - a) + fg * a + 127) // 255`) at a pen position that moves by
the glyph's whole-pixel advance; `getTextSize` gives the width
sum(advance) + 1, a height fixed by the scale and a baseline, the deepest
descent of the string's glyphs. So each glyph is probed once, white on
black (its alpha), for each (scale, weight) the drawing code uses:
`lw / 3` at the Annotator's line widths 2-10 (weight `max(lw - 1, 1)`;
images up to about 7000 px of width plus height) and 0.5, the
`Results.plot` scale, at both weights.

The colormaps are `matplotlib.colormaps[name](np.arange(256), bytes=True)`,
the colours matplotlib draws a normalised value in [0, 1] with (index
`min(int(v * 256), 255)`).

    python tests/torch_draw_probe.py    # rewrites native/glyphs_simplex.npz
                                        # and native/colormaps.npz

`tests/test_torch_plotting.py` probes again and holds the committed files
to it.
"""
from __future__ import annotations

from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ATLAS = ROOT / "mgdt_yolo_tpu_torch" / "native" / "glyphs_simplex.npz"
COLORMAPS = ROOT / "mgdt_yolo_tpu_torch" / "native" / "colormaps.npz"
CMAPS = ("Blues", "viridis")
CHARS = [chr(c) for c in range(32, 127)]
# (scale, thickness) probed: weight "r" is thickness 1, "b" every thickness above
COMBOS = [(0.5, 1), (0.5, 2), *((lw / 3, max(lw - 1, 1)) for lw in range(2, 11))]


def combo_key(scale: float, thickness: int) -> str:
    return f"{scale:.6f}{'b' if thickness > 1 else 'r'}"


def probe(scale: float, thickness: int) -> dict:
    """One (scale, weight)'s glyphs: `alpha` (all bitmaps, flat), `glyphs`
    (95, 7) int32 rows [offset, w, h, dx, dy, advance, descent] by
    character code - 32 (dx, dy from the pen to the bitmap's top left) and
    `meta` [height, width extra]."""
    def width(t):
        return cv2.getTextSize(t, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)[0][0]
    size = int(80 * scale) + 40
    ox, oy = size, size
    alphas, rows, off = [], [], 0
    for c in CHARS:
        img = np.zeros((2 * size, 3 * size, 3), np.uint8)
        cv2.putText(img, c, (ox, oy), cv2.FONT_HERSHEY_SIMPLEX, scale, (255, 255, 255),
                    thickness, cv2.LINE_8)
        a = img[..., 0]
        (_, _), descent = cv2.getTextSize(c, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
        adv = width(c + c) - width(c)
        ys, xs = np.nonzero(a)
        if len(xs):
            y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
            bm = np.ascontiguousarray(a[y0:y1, x0:x1])
            rows.append([off, x1 - x0, y1 - y0, x0 - ox, y0 - oy, adv, descent])
            alphas.append(bm.ravel())
            off += bm.size
        else:
            rows.append([off, 0, 0, 0, 0, adv, descent])
    h = cv2.getTextSize("A", cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)[0][1]
    extra = width("A") - rows[ord("A") - 32][5]
    return {"alpha": np.concatenate(alphas).astype(np.uint8),
            "glyphs": np.asarray(rows, np.int32), "meta": np.asarray([h, extra], np.int32),
            "scale": np.float64(scale), "bold": np.int32(thickness > 1)}


def probe_all() -> dict:
    out = {}
    for scale, thickness in COMBOS:
        key = combo_key(scale, thickness)
        for name, v in probe(scale, thickness).items():
            out[f"{key}/{name}"] = v
    return out


def probe_colormaps() -> dict:
    """{name: (256, 3) uint8 RGB} of matplotlib's colormaps."""
    import matplotlib
    return {name: matplotlib.colormaps[name](np.arange(256), bytes=True)[:, :3]
            for name in CMAPS}


if __name__ == "__main__":
    np.savez_compressed(ATLAS, **probe_all())
    np.savez_compressed(COLORMAPS, **probe_colormaps())
    for path in (ATLAS, COLORMAPS):
        print(path, path.stat().st_size, "bytes")

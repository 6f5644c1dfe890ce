"""Outer contours of a binary mask without cv2: the border following of
Suzuki and Abe as OpenCV's `findContours(RETR_EXTERNAL,
CHAIN_APPROX_SIMPLE)` runs it, for `engine.results.Masks.xy`.

The mask (nonzero = 1) gets a frame of zeros. A raster scan looks for a 1
whose left neighbour is 0; it starts an outer border unless the last
labelled pixel met on its row (LNBD) carries a positive label, which marks
it as nested inside another border (OpenCV's external mode also skips every
hole border). The border is followed from there with OpenCV's direction
codes (0 east, counting counter-clockwise: 1 north-east, 2 north, ... 7
south-east): from the start the first nonzero neighbour clockwise from the
west, then at each pixel the first nonzero one counter-clockwise after the
direction it came back from, until the walk returns to its first step.
Each visited pixel is labelled -126 where its east neighbour was examined
and found 0, else 2 where it was still 1. A point is written where the
direction changes (CHAIN_APPROX_SIMPLE). The contours come out in the
reverse of the order they were found, as OpenCV links them, at the mask's
own coordinates.
"""
from __future__ import annotations

from typing import List

import numpy as np

# OpenCV's chain codes: (dx, dy) of direction 0..7
_CODES = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))
_RIGHT, _LEFT = -126, 2   # labels of a border pixel with / without a 0 east of it


def _follow(img: np.ndarray, y: int, x: int) -> List[tuple]:
    """Follow the outer border starting at (y, x) of the framed int8 image
    `img`, labelling it in place; its points (x, y) in framed coordinates."""
    s_end = s = 4
    while True:
        s = (s - 1) & 7
        dx, dy = _CODES[s]
        if img[y + dy, x + dx] != 0 or s == s_end:
            break
    if s == s_end:                      # a single pixel
        img[y, x] = _RIGHT
        return [(x, y)]
    y1, x1 = y + _CODES[s][1], x + _CODES[s][0]
    pts, prev_s = [], s ^ 4
    py, px = y, x                       # i3
    while True:
        s_end = s
        while s < 15:
            s += 1
            dx, dy = _CODES[s & 7]
            qy, qx = py + dy, px + dx       # i4
            if img[qy, qx] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:             # the east neighbour was examined: 0
            img[py, px] = _RIGHT
        elif img[py, px] == 1:
            img[py, px] = _LEFT
        if s != prev_s:
            pts.append((px, py))
            prev_s = s
        if (qy, qx) == (y, x) and (py, px) == (y1, x1):
            return pts
        py, px = qy, qx
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> List[np.ndarray]:
    """`cv2.findContours(mask.astype(np.uint8), cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_SIMPLE)[0]`, each contour (n, 1, 2) int32 (x, y)."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = np.asarray(mask) != 0
    found = []
    for y in range(1, h + 1):
        row = img[y]
        x, prev, lnbd = 1, 0, 0
        while x <= w:
            # the next pixel whose value differs from `prev` (rows change as
            # borders are followed, so this reads the row as it is now)
            rest = np.flatnonzero(row[x:w + 1] != prev)
            if not rest.size:
                break
            x += int(rest[0])
            p = int(row[x])
            if prev == 0 and p == 1:            # an outer border starts here
                if row[lnbd] <= 0:              # not nested in another border
                    found.append(np.array(_follow(img, y, x), np.int32) - 1)
                    p = int(row[x])             # the start is labelled now
            elif p == 0 and prev >= 1:          # a hole border: skipped
                if prev & -2:
                    lnbd = x - 1
            prev = p
            if prev & -2:
                lnbd = x
            x += 1
    return [c.reshape(-1, 1, 2) for c in reversed(found)]


def contour_area(contour: np.ndarray) -> float:
    """`cv2.contourArea(contour)`: the shoelace area, unsigned, in double."""
    c = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(c) < 3:
        return 0.0
    x, y = c[:, 0], c[:, 1]
    xp, yp = np.roll(x, 1), np.roll(y, 1)
    return float(abs((xp * y - yp * x).sum()) * 0.5)

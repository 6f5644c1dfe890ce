"""Write `mgdt_yolo_tpu_torch/native/src/orb_pattern.inc`: ORB's 256 point
pairs, found by probing cv2's ORB on this machine.

    python tests/torch_orb_pattern.py [--check]

ORB's descriptor bit i is `B(c + p0) < B(c + p1)` for the i-th pair (p0,
p1) of points in [-13, 12]^2 around the keypoint c, at angle 0, where B is
the level's image blurred by the 7 x 7, sigma 2 Gaussian (cv2 filters the
pyramid's region in place through `sepFilter2D`'s path with the float
kernel, not `GaussianBlur`'s 8-bit fixed-point one). Every candidate pair of
the 26^4 is kept while it agrees with every bit cv2 gives at keypoints on
seeded random images; each bit is then left with exactly one pair. The
table is cross-checked against the run of 1024 int32 that starts with its
first pair in the installed cv2 library file. `--check` compares the
written file with what the probe finds, and writes nothing.

The table is OpenCV's `bit_pattern_31_` (modules/features2d/src/orb.cpp),
which OpenCV distributes under the Apache License 2.0.
"""
import argparse
import glob
import os
import sys
from pathlib import Path

import cv2
import numpy as np

OUT = (Path(__file__).resolve().parents[1] / "mgdt_yolo_tpu_torch" / "native" / "src"
       / "orb_pattern.inc")
SIDE = 26  # coordinates -13 .. 12
HEADER = """\
// ORB's 256 point pairs (x0, y0, x1, y1), bit i of the descriptor being
// blurred(x0, y0) < blurred(x1, y1) rotated by the keypoint's angle.
// Written by tests/torch_orb_pattern.py, which recovers them by probing
// cv2's ORB and checks them against the installed OpenCV library.
//
// The table is OpenCV's bit_pattern_31_ (modules/features2d/src/orb.cpp).
// Copyright (C) 2011 Willow Garage, Inc.; the OpenCV project's code is
// licensed under the Apache License, Version 2.0
// (http://www.apache.org/licenses/LICENSE-2.0).
"""


def probe(images: int = 6, seed: int = 0) -> np.ndarray:
    """The (256, 4) int pairs that cv2's ORB.compute gives at angle 0."""
    rng = np.random.default_rng(seed)
    k = cv2.getGaussianKernel(7, 2, cv2.CV_32F)
    orb = cv2.ORB_create()
    cand = np.ones((256, SIDE * SIDE, SIDE * SIDE), bool)
    for _ in range(images):
        img = rng.integers(0, 256, (160, 160), dtype=np.uint8)
        kps = [cv2.KeyPoint(float(x), float(y), 31, 0, 0, 0)
               for y in range(40, 121, 20) for x in range(40, 121, 20)]
        out, desc = orb.compute(img, kps)
        if len(out) != len(kps):
            raise RuntimeError("cv2 dropped probe keypoints")
        blurred = cv2.sepFilter2D(img, -1, k, k, borderType=cv2.BORDER_REFLECT_101)
        for kp, d in zip(out, desc):
            cx, cy = int(kp.pt[0]), int(kp.pt[1])
            vals = blurred[cy - 13:cy + 13, cx - 13:cx + 13].astype(np.int16).ravel()
            less = vals[:, None] < vals[None, :]
            bits = np.unpackbits(d, bitorder="little").astype(bool)
            cand &= less[None] == bits[:, None, None]
    flat = cand.reshape(256, -1)
    left = flat.sum(1)
    if left.min() != 1 or left.max() != 1:
        raise RuntimeError(f"the probe leaves {left.min()}..{left.max()} pairs a bit")
    i0, i1 = np.divmod(flat.argmax(1), SIDE * SIDE)
    return np.stack([i0 % SIDE - 13, i0 // SIDE - 13, i1 % SIDE - 13, i1 // SIDE - 13],
                    1).astype(np.int32)


def library_table(first: np.ndarray) -> np.ndarray:
    """The 1024 int32 in cv2's library file that start with `first`."""
    key = np.asarray(first, "<i4").tobytes()
    found = []
    for path in glob.glob(os.path.join(os.path.dirname(cv2.__file__), "**", "*.so"),
                          recursive=True):
        data = Path(path).read_bytes()
        at = data.find(key)
        if at >= 0:
            found.append(np.frombuffer(data[at:at + 4096], "<i4").reshape(256, 4))
            if data.find(key, at + 1) >= 0:
                raise RuntimeError(f"the run occurs twice in {path}")
    if len(found) != 1:
        raise RuntimeError(f"the run occurs in {len(found)} library files")
    return found[0]


def render(pairs: np.ndarray) -> str:
    rows = [", ".join(f"{v:3d}" for v in p) for p in pairs]
    body = ",\n".join(f"    {r}" for r in rows)
    return f"{HEADER}static const int kOrbPattern[256 * 4] = {{\n{body}}};\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    pairs = probe()
    lib = library_table(pairs[0])
    if not np.array_equal(pairs, lib):
        raise RuntimeError("the probed pairs differ from the library's table")
    text = render(pairs)
    if args.check:
        same = OUT.is_file() and OUT.read_text() == text
        print("orb_pattern.inc", "matches" if same else "differs")
        return 0 if same else 1
    OUT.write_text(text)
    print(f"wrote {OUT} ({len(pairs)} pairs, equal to the library's table)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

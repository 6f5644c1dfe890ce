"""Write `mgdt_yolo_tpu_torch/native/fixtures/gmc/pan_h.json`: cv2's answer
for BoT-SORT's `orb` and `sift` camera-motion compensation over the pan that
`chip_smoke.py` phase 22 tracks, so the card's host can be held to it
without cv2.

    python tests/torch_gmc_fixtures.py [--check]

It runs the JAX package's `GMC("orb")` and `GMC("sift")` (cv2 on this
machine, its default build) over the first 16 frames of
`panning_sequence(64, (1080, 1920), seed=7)` and stores each frame's H, the
SHA-256 of each frame's bytes (so that a change of frames is told apart
from a change of GMC), and, for frames 0 and 1, the ORB keypoint count and
the SHA-256 of ORB's keypoints (float64 rows of x, y, size, angle,
response, octave, class_id, as `tracker.gmc.orb_features` gives them) and of
its descriptors, both of the GMC's half-size gray frame. `--check` compares
the written file with a fresh run and writes nothing.
"""
import argparse
import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from mgdt_yolo_tpu.tracker.gmc import GMC as JaxGMC  # noqa: E402
from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence  # noqa: E402

OUT = ROOT / "mgdt_yolo_tpu_torch" / "native" / "fixtures" / "gmc" / "pan_h.json"
SEQUENCE = {"n": 64, "shape": [1080, 1920], "seed": 7}
FRAMES = 16
METHODS = ("orb", "sift")


def keypoint_rows(kps) -> np.ndarray:
    return np.array([(k.pt[0], k.pt[1], k.size, k.angle, k.response, k.octave, k.class_id)
                     for k in kps], np.float64).reshape(-1, 7)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def answer() -> dict:
    frames = panning_sequence(SEQUENCE["n"], tuple(SEQUENCE["shape"]),
                              seed=SEQUENCE["seed"])[0][:FRAMES]
    out = {"sequence": SEQUENCE, "frames": FRAMES, "cv2": cv2.__version__,
           "frame_sha256": [sha(f) for f in frames], "H": {}, "orb": []}
    for method in METHODS:
        gmc = JaxGMC(method)
        out["H"][method] = [gmc.apply(f).tolist() for f in frames]
    prep = JaxGMC("orb")._prep
    for t in (0, 1):
        kps, desc = cv2.ORB_create().detectAndCompute(prep(frames[t]), None)
        out["orb"].append({"frame": t, "keypoints": len(kps),
                           "keypoints_sha256": sha(keypoint_rows(kps)),
                           "descriptors_sha256": sha(desc)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    text = json.dumps(answer(), indent=1) + "\n"
    if args.check:
        same = OUT.is_file() and OUT.read_text() == text
        print("pan_h.json", "matches" if same else "differs")
        return 0 if same else 1
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(text)
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Write the committed video fixtures of `mgdt_yolo_tpu_torch/native/fixtures/
video/` (run from the repository's root, with cv2 and PIL):

    python tests/torch_video_fixtures.py

* `clip.avi`, `clip.mp4`, `clip.mkv`: 5 frames of a seeded 64x112 pan as
  Motion JPEG at 12.5 fps, written by `cv2.VideoWriter` (ffmpeg's encoder:
  the three hold the same JPEG bytes); `clip_<i>.png`: libjpeg's reading
  (`cv2.imdecode`) of frame i, the twin the card's nvJPEG reading is held
  to (`chip_smoke.py` phase 26);
* `clip.gif`: 4 frames of the pan quantised by PIL (local palettes,
  disposal 2, interlaced); `gif_<i>.png`: `cv2.VideoCapture`'s frame i,
  which the port's GIF decoder gives bit for bit.

`tests/test_torch_video.py` checks the twins against cv2 on the CPU.
"""
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "mgdt_yolo_tpu_torch" / "native" / "fixtures" / "video"
SHAPE, FRAMES, FPS = (64, 112), 5, 12.5


def pan(n):
    from mgdt_yolo_tpu_torch.data.synthetic import panning_sequence
    return panning_sequence(n, SHAPE, seed=11, tile=SHAPE[1])[0]


def main():
    from PIL import Image
    from mgdt_yolo_tpu_torch.native.video import VideoReader
    OUT.mkdir(parents=True, exist_ok=True)
    frames = pan(FRAMES)
    data = []
    for ext in ("avi", "mp4", "mkv"):
        p = OUT / f"clip.{ext}"
        vw = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"MJPG"), FPS,
                             (SHAPE[1], SHAPE[0]))
        for f in frames:
            vw.write(f)
        vw.release()
        r = VideoReader(p)
        data.append(r.frame_bytes(range(r.frames)))
    assert data[0] == data[1] == data[2], "the containers hold other frames"
    for i, b in enumerate(data[0]):
        cv2.imwrite(str(OUT / f"clip_{i}.png"),
                    cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR))
    ims = [Image.fromarray(f[..., ::-1]).quantize(200) for f in pan(4)]
    gif = OUT / "clip.gif"
    ims[0].save(gif, save_all=True, append_images=ims[1:], duration=[80, 40, 40, 120],
                loop=0, disposal=2)
    cap = cv2.VideoCapture(str(gif))
    i = 0
    while True:
        ok, img = cap.read()
        if not ok:
            break
        cv2.imwrite(str(OUT / f"gif_{i}.png"), img)
        i += 1


if __name__ == "__main__":
    main()

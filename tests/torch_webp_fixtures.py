"""Write the committed WebP fixtures of `mgdt_yolo_tpu_torch/native/fixtures/
webp/` (run from the repository's root, on a machine with cv2 and libwebp's
shared library, `libwebp.so.7`):

    python tests/torch_webp_fixtures.py

Each small `<name>.webp` has its twin `<name>.png`: `cv2.imread`'s reading
of it, written by cv2. They cover what cv2's and PIL's encoders cannot
reach, made by libwebp's own encoder through ctypes (here, never in the
port):

* `simple_filter`: the simple loop filter; `sharp3`, `sharp7`: the normal
  filter at sharpness 3 and 7; `parts2`, `parts4`, `parts8`: 2, 4 and 8
  token partitions; `seg1`, `seg4`: 1 and 4 segments; `alpha_filtered`:
  lossy with a VP8L-compressed `ALPH` under the horizontal filter (64x136
  images with noise, so the encoder keeps every feature; 9 macroblock
  rows, so each of 8 partitions holds one);
* `scene_lossy` (quality 90) and `scene_lossless`: a 1080x1920 picture at
  full detail, synthetic scene 7 at 1920 px cut to 1080 rows
  (`synthetic_scene(7, 1920, seed=7)[:1080]`, `SCENE`, every pixel its
  own, with the scene's noise; one on which the flagship's committed
  weights find objects), which `chip_smoke.py` phase 26 times beside a
  quality-95 JPEG of the same picture and runs the predictor over. Their
  twins would be 5 MB each, so `digests.json` holds, for each, the shape
  and the SHA-256 of the bytes of `cv2.imread`'s reading instead.

The twins are written at PNG compression 9.

`tests/test_torch_webp.py` holds the port's decoder to the twins and to cv2.
"""
import ctypes
import hashlib
import json
import sys
from pathlib import Path

import cv2
import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "mgdt_yolo_tpu_torch" / "native" / "fixtures" / "webp"
SCENE = 7  # synthetic_scene's index of the 1080x1920 scenes
ENCODER_ABI = 0x020F  # WEBP_ENCODER_ABI_VERSION of the headers the layout below follows


class WebPConfig(ctypes.Structure):
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR") else ctypes.c_int)
                for name in ("lossless", "quality", "method", "image_hint", "target_size",
                             "target_PSNR", "segments", "sns_strength", "filter_strength",
                             "filter_sharpness", "filter_type", "autofilter",
                             "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
                             "show_compressed", "preprocessing", "partitions",
                             "partition_limit", "emulate_jpeg_size", "thread_level",
                             "low_memory", "near_lossless", "exact", "use_delta_palette",
                             "use_sharp_yuv", "qmin", "qmax")]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32)]


P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


class WebPPicture(ctypes.Structure):
    _fields_ = [("use_argb", I), ("colorspace", I), ("width", I), ("height", I),
                ("y", P), ("u", P), ("v", P), ("y_stride", I), ("uv_stride", I), ("a", P),
                ("a_stride", I), ("pad1", U * 2), ("argb", P), ("argb_stride", I),
                ("pad2", U * 3), ("writer", P), ("custom_ptr", P), ("extra_info_type", I),
                ("extra_info", P), ("stats", P), ("error_code", I), ("progress_hook", P),
                ("user_data", P), ("pad3", U * 3), ("pad4", P), ("pad5", P), ("pad6", U * 8),
                ("memory_", P), ("memory_argb_", P), ("pad7", P * 2)]


def encode(img, alpha=None, **options):
    """`img` (BGR uint8) with an optional alpha plane, encoded by libwebp
    under `options` (WebPConfig's fields) over its default lossy config."""
    lib = ctypes.CDLL("libwebp.so.7")
    cfg = WebPConfig()
    assert lib.WebPConfigInitInternal(ctypes.byref(cfg), 0, ctypes.c_float(75.0), ENCODER_ABI)
    for k, v in options.items():
        setattr(cfg, k, v)
    assert lib.WebPValidateConfig(ctypes.byref(cfg)), options
    pic = WebPPicture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), ENCODER_ABI)
    h, w = img.shape[:2]
    pic.width, pic.height, pic.use_argb = w, h, 1
    if alpha is None:
        rgb = np.ascontiguousarray(img[..., ::-1])
        assert lib.WebPPictureImportRGB(ctypes.byref(pic), rgb.ctypes.data_as(P), w * 3)
    else:
        rgba = np.ascontiguousarray(np.dstack([img[..., ::-1], alpha]))
        assert lib.WebPPictureImportRGBA(ctypes.byref(pic), rgba.ctypes.data_as(P), w * 4)
    wr = WebPMemoryWriter()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, P).value
    pic.custom_ptr = ctypes.cast(ctypes.byref(wr), P).value
    ok = lib.WebPEncode(ctypes.byref(cfg), ctypes.byref(pic))
    data = ctypes.string_at(wr.mem, wr.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    assert ok, f"WebPEncode failed ({pic.error_code})"
    return data


def textured(h, w, seed):
    """A smooth seeded image with noise: every macroblock has detail."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (h // 8 + 2, w // 8 + 2, 3)).astype(np.float32)
    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC) + r.normal(0, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def cases():
    from mgdt_yolo_tpu_torch.data.synthetic import synthetic_scene
    img = textured(136, 64, 5)
    out = {
        "simple_filter": encode(img, quality=60, filter_type=0, filter_strength=60),
        "sharp3": encode(img, quality=50, filter_type=1, filter_strength=70, filter_sharpness=3),
        "sharp7": encode(img, quality=50, filter_type=1, filter_strength=70, filter_sharpness=7),
        # the encoder keeps one partition above method 0
        "parts2": encode(img, quality=80, partitions=1, method=0),
        "parts4": encode(img, quality=80, partitions=2, method=0),
        "parts8": encode(img, quality=80, partitions=3, method=0),
        "seg1": encode(img, quality=70, segments=1),
        "seg4": encode(img, quality=70, segments=4, sns_strength=100),
    }
    # a ramp, for which the encoder keeps a prediction filter (the horizontal one)
    yy, xx = np.mgrid[:136, :64]
    data = encode(img, ((2 * xx + yy) % 256).astype(np.uint8), quality=70, alpha_compression=1,
                  alpha_filtering=2, alpha_quality=100)
    alph = data[data.index(b"ALPH") + 8]
    assert alph & 3 == 1 and (alph >> 2) & 3 == 1, hex(alph)
    out["alpha_filtered"] = data
    scene = np.ascontiguousarray(synthetic_scene(SCENE, 1920, seed=7)[:1080])
    out["scene_lossy"] = encode(scene, quality=90, method=4)
    out["scene_lossless"] = encode(scene, lossless=1, quality=75, method=4)
    return out


def digest(img):
    """The shape and SHA-256 of a BGR image's bytes, as `digests.json` holds
    them."""
    return {"shape": list(img.shape), "sha256": hashlib.sha256(img.tobytes()).hexdigest()}


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    digests = {}
    for name, data in cases().items():
        p = OUT / f"{name}.webp"
        p.write_bytes(data)
        img = cv2.imread(str(p))
        assert img is not None, name
        if name.startswith("scene_"):
            digests[name] = digest(img)
        else:
            cv2.imwrite(str(OUT / f"{name}.png"), img, [cv2.IMWRITE_PNG_COMPRESSION, 9])
        print(f"{name}: {len(data)} bytes, {img.shape[1]}x{img.shape[0]}")
    (OUT / "digests.json").write_text(json.dumps(digests, indent=1) + "\n")


if __name__ == "__main__":
    main()

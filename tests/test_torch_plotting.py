"""The port's drawing and image writers against cv2 and the JAX package's
plotting, on the CPU.

Tolerances, each with its reason:

* the committed glyphs and colormaps: equal to a fresh probe of the installed
  cv2 5 and matplotlib (`tests/torch_draw_probe.py`);
* rectangles (outlined and filled, `LINE_8` and `LINE_AA`), circles,
  convex polygons, polylines and lines within the image: bit for bit cv2's
  (the same fixed-point arithmetic and anti-aliasing tables), except a
  1-px `LINE_8` line between points with fractional bits, which cv2 5
  rounds its own way and no plot draws (a known difference, left out);
* text at the probed (scale, weight) pairs, `getTextSize` for every
  printable character: bit for bit cv2's; at a scale that was not probed
  the glyphs are resampled, and the share of pixels that differ inside the
  text's box is printed (a known difference);
* `Annotator.box_label`, `plot_images`, `Results.plot` and `save_one_box`:
  their arrays bit for bit JAX's (cv2's) at the line widths 2-6;
* JPEG at quality 95 read back through cv2: within 0.5 dB PSNR of cv2's own
  quality-95 file of the same array, at most 1.3 times its size, and within
  `draw.JPEG_READ_MEAN` grey levels on average of `draw.jpeg_reference`,
  the numpy model of a decoder's reading (decoders round their inverse DCT
  and chroma upsampling their own ways): `draw.jpeg_reading`, the gate
  `chip_smoke.py` holds the card's read-back to, with PIL's quality-95
  4:2:0 file standing for cv2's (the same bytes); a quality-85 file fails
  that gate on each kind of image the card's run writes; PNG read back
  through cv2: exact;
* the charts: JAX's file names and pixel sizes, and matplotlib's binning
  of the same data (their pixels are the port's own).
"""
from pathlib import Path

import cv2
import numpy as np
import pytest

import mgdt_yolo_tpu.utils.plotting as jax_plotting
from mgdt_yolo_tpu.engine.results import Results as JaxResults
from mgdt_yolo_tpu.utils.metrics import ConfusionMatrix as JaxConfusionMatrix
from mgdt_yolo_tpu_torch.engine.results import Results
from mgdt_yolo_tpu_torch.utils import charts, draw, plotting
from mgdt_yolo_tpu_torch.utils.metrics import ConfusionMatrix
from torch_draw_probe import ATLAS, COLORMAPS, COMBOS, probe_all, probe_colormaps
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

NAMES = {0: "person", 1: "car", 2: "a_long_class_name"}
PRINTABLE = "".join(chr(c) for c in range(32, 127))


def _psnr(a, b) -> float:
    mse = np.mean((a.astype(np.float64) - b) ** 2)
    return 10 * np.log10(255 ** 2 / mse) if mse else np.inf


def test_committed_data_is_a_fresh_probe():
    with np.load(ATLAS) as f:
        probed = probe_all()
        assert sorted(f.files) == sorted(probed)
        for k, v in probed.items():
            np.testing.assert_array_equal(f[k], v, err_msg=k)
    with np.load(COLORMAPS) as f:
        for name, table in probe_colormaps().items():
            assert table.shape == (256, 3)
            np.testing.assert_array_equal(f[name], table, err_msg=name)


@pytest.mark.parametrize("name", ["Blues", "viridis"])
def test_colormaps_map_as_matplotlib(name):
    import matplotlib
    cmap = matplotlib.colormaps[name]
    v = np.linspace(-0.2, 1.2, 1001)
    want = cmap(np.clip(v, 0, 1), bytes=True)[:, :3][:, ::-1]
    np.testing.assert_array_equal(charts.colorize(v, name, 0.0, 1.0), want)


def _scenes(seed, n=80):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(20, 160, 2))
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        col = tuple(int(v) for v in rng.integers(0, 256, 3))
        yield rng, img, col


PRIMITIVES = ["rectangle", "circle", "line", "fill_convex_poly", "polylines"]


@pytest.mark.parametrize("line_type", [cv2.LINE_8, cv2.LINE_AA], ids=["LINE_8", "LINE_AA"])
@pytest.mark.parametrize("prim", PRIMITIVES)
def test_primitives_are_cv2s(prim, line_type):
    for rng, img, col in _scenes(PRIMITIVES.index(prim) * 2 + (line_type == cv2.LINE_AA)):
        h, w = img.shape[:2]
        far = [tuple(int(v) for v in rng.integers(-40, 200, 2)) for _ in range(2)]
        inside = [(int(rng.integers(0, w)), int(rng.integers(0, h))) for _ in range(2)]
        for th in (1, 2, 3, 4, 5, 6, -1):
            a, b = img.copy(), img.copy()
            if prim == "rectangle":
                cv2.rectangle(a, *far, col, th, line_type)
                draw.rectangle(b, *far, col, th, line_type)
            elif prim == "circle":
                r = int(rng.integers(0, 30))
                cv2.circle(a, far[0], r, col, th, line_type)
                draw.circle(b, far[0], r, col, th, line_type)
            elif prim == "line" and th > 0:
                # cv2 5 clips a thick line to the image its own way: within it, cv2's
                cv2.line(a, *inside, col, th, line_type)
                draw.line(b, *inside, col, th, line_type)
            elif prim in ("fill_convex_poly", "polylines"):
                c = rng.uniform(0, 1, 2) * (w, h)
                ang = np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 9))))
                rad = rng.uniform(5, 60)
                pts = np.stack([c[0] + rad * np.cos(ang), c[1] + rad * np.sin(ang)], 1)
                pts = np.rint(pts * 16).astype(np.int32)  # 4 fractional bits
                if prim == "fill_convex_poly":
                    cv2.fillConvexPoly(a, pts, col, line_type, 4)
                    draw.fill_convex_poly(b, pts, col, line_type, 4)
                elif th > 0:
                    # a 1-px LINE_8 line at fractional points is cv2 5's own
                    # rounding (no plot draws one): integer points there
                    shift = 0 if line_type == cv2.LINE_8 and th == 1 else 4
                    pts = pts if shift else (pts + 8) >> 4
                    cv2.polylines(a, [pts], bool(th % 2), col, th, line_type, shift)
                    draw.polylines(b, pts, bool(th % 2), col, th, line_type, shift)
            np.testing.assert_array_equal(a, b, err_msg=f"{prim} thickness {th}")


@pytest.mark.parametrize("scale,thickness", COMBOS, ids=[f"{s:.3f}-{t}" for s, t in COMBOS])
def test_text_is_cv2s_at_the_probed_scales(scale, thickness):
    for c in PRINTABLE:
        assert draw.get_text_size(c, scale, thickness) == \
            cv2.getTextSize(c, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness), repr(c)
    assert draw.get_text_size("", scale, thickness) == \
        cv2.getTextSize("", cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
    for rng, img, col in _scenes(11):
        text = "".join(rng.choice(list(PRINTABLE), int(rng.integers(1, 14))))
        org = (int(rng.integers(-20, img.shape[1])), int(rng.integers(-5, img.shape[0] + 20)))
        assert draw.get_text_size(text, scale, thickness) == \
            cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
        a, b = img.copy(), img.copy()
        cv2.putText(a, text, org, cv2.FONT_HERSHEY_SIMPLEX, scale, col, thickness, cv2.LINE_AA)
        draw.put_text(b, text, org, scale, col, thickness, draw.LINE_AA)
        np.testing.assert_array_equal(a, b, err_msg=repr(text))


@pytest.mark.parametrize("scale,thickness", [(0.7, 1), (4.0, 11)])
def test_text_at_an_unprobed_scale_is_close(scale, thickness):
    """A known difference: the nearest probed face, resampled. The share of
    equal pixels inside the text's box is printed."""
    same = total = 0
    for rng, _, col in _scenes(12, 40):
        text = "".join(rng.choice(list(PRINTABLE[1:]), int(rng.integers(3, 12))))
        (w, h), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)
        img = np.full((h + base + 20, w + 20, 3), 90, np.uint8)
        a, b = img.copy(), img.copy()
        cv2.putText(a, text, (10, h + 10), cv2.FONT_HERSHEY_SIMPLEX, scale, col, thickness)
        draw.put_text(b, text, (10, h + 10), scale, col, thickness)
        box = (slice(10, h + base + 10), slice(10, w + 10))
        same += int((a[box] == b[box]).all(-1).sum())
        total += (h + base) * w
    print(f"scale {scale:.3f} thickness {thickness}: {same / total:.4f} of the text box equal")
    assert same / total > 0.5


@pytest.mark.parametrize("shape", [(96, 128, 3), (480, 640, 3), (900, 1000, 3),
                                   (1300, 1500, 3), (1500, 1900, 3), (1900, 2200, 3)],
                         ids=lambda s: f"lw{max(round(sum(s) / 2 * 0.003), 2)}")
def test_annotator_is_jaxs(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ours, theirs = plotting.Annotator(img.copy()), jax_plotting.Annotator(img.copy())
    assert ours.lw == theirs.lw
    for _ in range(10):
        x1, y1 = int(rng.integers(-20, shape[1])), int(rng.integers(-20, shape[0]))
        box = [x1, y1, x1 + int(rng.integers(4, 300)), y1 + int(rng.integers(4, 300))]
        c = int(rng.integers(0, 3))
        label = f"{NAMES[c]} {rng.random():.2f}"
        ours.box_label(box, label, plotting.color(c))
        theirs.box_label(box, label, jax_plotting.color(c))
    kp = np.concatenate([rng.uniform(0, shape[1], (6, 1)), rng.uniform(0, shape[0], (6, 1)),
                         rng.uniform(0, 1, (6, 1))], 1)
    ours.kpts(kp)
    theirs.kpts(kp)
    masks = rng.random((2, *shape[:2])) > 0.7
    ours.masks(masks, [(255, 0, 0), (0, 0, 255)])
    theirs.masks(masks, [(255, 0, 0), (0, 0, 255)])
    np.testing.assert_array_equal(ours.result(), theirs.result())


def _capture(monkeypatch, module, name):
    written = {}

    def keep(path, img):
        written[Path(str(path)).name] = np.array(img)
        return True
    monkeypatch.setattr(module, name, keep)
    return written


def test_plot_images_is_jaxs(monkeypatch, tmp_path):
    rng = np.random.default_rng(3)
    imgs = rng.random((5, 96, 128, 3)).astype(np.float32)
    boxes = [np.concatenate([rng.integers(-5, 90, (4, 2)), rng.integers(20, 140, (4, 2)),
                             rng.random((4, 1)), rng.integers(0, 3, (4, 1))], 1).astype(np.float32)
             for _ in range(5)]
    ours = _capture(monkeypatch, plotting.draw, "imwrite")
    theirs = _capture(monkeypatch, jax_plotting.cv2, "imwrite")
    plotting.plot_images(imgs, boxes, NAMES, str(tmp_path / "a.jpg"))
    jax_plotting.plot_images(imgs, boxes, NAMES, str(tmp_path / "a.jpg"))
    assert ours["a.jpg"].shape == (288, 384, 3)
    np.testing.assert_array_equal(ours["a.jpg"], theirs["a.jpg"])


def test_save_one_box_is_jaxs(tmp_path):
    rng = np.random.default_rng(4)
    im = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    for box in ([10.5, 20.2, 80.9, 99.1], [-10, -4, 30, 40], [100, 60, 170, 130]):
        for square in (False, True):
            for bgr in (False, True):
                ours = plotting.save_one_box(box, im, square=square, BGR=bgr, save=False)
                theirs = jax_plotting.save_one_box(box, im, square=square, BGR=bgr, save=False)
                np.testing.assert_array_equal(ours, theirs)
    for i in range(2):  # the second is numbered, as JAX's
        plotting.save_one_box([10, 20, 80, 99], im, file=tmp_path / "ours" / "c.jpg")
        jax_plotting.save_one_box([10, 20, 80, 99], im, file=tmp_path / "jax" / "c.jpg")
    names = sorted(p.name for p in (tmp_path / "ours").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jax").iterdir()) == ["c.jpg", "c2.jpg"]
    a, b = (cv2.imread(str(tmp_path / d / "c.jpg")) for d in ("ours", "jax"))
    crop = plotting.save_one_box([10, 20, 80, 99], im, BGR=True, save=False)
    assert a.shape == b.shape == crop.shape and _psnr(a, crop) >= _psnr(b, crop) - 0.5


@pytest.mark.parametrize("shape", [(480, 640, 3), (1080, 1920, 3), (2160, 3840, 3)])
def test_results_plot_and_crops_are_jaxs(shape, tmp_path):
    rng = np.random.default_rng(shape[0])
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    xy = rng.uniform(-10, shape[0] * 0.7, (7, 2))
    det = np.concatenate([xy, xy + rng.uniform(8, shape[0] * 0.3, (7, 2)), rng.random((7, 1)),
                          rng.integers(0, 3, (7, 1))], 1).astype(np.float32)
    ours, theirs = Results(img, "x.jpg", NAMES, det), JaxResults(img, "x.jpg", NAMES, det)
    np.testing.assert_array_equal(ours.plot(), theirs.plot())
    ours.save_crop(tmp_path / "ours", "x.jpg")
    theirs.save_crop(tmp_path / "jax", "x.jpg")
    files = sorted(str(p.relative_to(tmp_path / "ours")) for p in (tmp_path / "ours").rglob("*.jpg"))
    assert files == sorted(str(p.relative_to(tmp_path / "jax"))
                           for p in (tmp_path / "jax").rglob("*.jpg"))


def _jpeg_images():
    rng = np.random.default_rng(5)
    smooth = cv2.GaussianBlur(rng.integers(0, 256, (240, 320, 3), dtype=np.uint8), (0, 0), 4)
    drawn = smooth.copy()
    plotting.Annotator(drawn).box_label([20, 40, 200, 180], "person 0.91", plotting.color(0))
    return {"noise": rng.integers(0, 256, (97, 131, 3), dtype=np.uint8), "smooth": smooth,
            "drawn": drawn, "grey": rng.integers(0, 256, (33, 17), dtype=np.uint8),
            "one-pixel": rng.integers(0, 256, (1, 1, 3), dtype=np.uint8),
            "flat": np.full((64, 48, 3), 200, np.uint8)}


@pytest.mark.parametrize("name", list(_jpeg_images()))
def test_writers_against_cv2(name, tmp_path):
    img = _jpeg_images()[name]
    draw.imwrite(tmp_path / "a.jpg", img)
    cv2.imwrite(str(tmp_path / "b.jpg"), img)
    flag = cv2.IMREAD_UNCHANGED
    ours, theirs = (cv2.imread(str(tmp_path / f), flag) for f in ("a.jpg", "b.jpg"))
    assert ours.shape == img.shape
    assert _psnr(ours, img) >= _psnr(theirs, img) - 0.5
    # the numpy model of a decoder's reading, which the card's read-back is held to
    d = np.abs(ours.astype(np.int16) - draw.jpeg_reference(img))
    assert d.mean() <= draw.JPEG_READ_MEAN
    assert draw.jpeg_reading(ours, img, theirs)["holds"]
    size, cv2_size = ((tmp_path / f).stat().st_size for f in ("a.jpg", "b.jpg"))
    assert size <= 1.3 * cv2_size
    draw.imwrite(tmp_path / "a.png", img)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "a.png"), flag), img)
    print(f"{name}: PSNR {_psnr(ours, img):.3f} dB (cv2 {_psnr(theirs, img):.3f}), "
          f"{size} bytes (cv2 {cv2_size}); against the reference reading max {d.max()}, "
          f"mean {d.mean():.4f}")


def _written_kinds(monkeypatch):
    """An array of each kind the card's run writes as JPEG: a scene drawn by
    `Results.plot`, a crop of it, a batch mosaic and the labels chart."""
    rng = np.random.default_rng(5)
    scene = cv2.GaussianBlur(rng.integers(0, 256, (480, 640, 3), dtype=np.uint8), (0, 0), 6)
    xy = rng.uniform(0, 300, (5, 2))
    det = np.concatenate([xy, xy + rng.uniform(40, 160, (5, 2)), rng.random((5, 1)),
                          rng.integers(0, 3, (5, 1))], 1).astype(np.float32)
    written = _capture(monkeypatch, plotting.draw, "imwrite")
    tiles = cv2.GaussianBlur(rng.integers(0, 256, (640, 160, 3), dtype=np.uint8), (0, 0), 4)
    plotting.plot_images((tiles.reshape(4, 160, 160, 3) / 255).astype(np.float32),
                         [det / 3] * 4, NAMES, "mosaic.jpg")
    boxes = rng.uniform(0.05, 0.95, (300, 4))
    boxes[:, 2:] = rng.uniform(0.02, 0.4, (300, 2))
    charts.plot_labels(boxes, rng.integers(0, 3, 300), NAMES, "unused")
    return {"result": Results(scene, "x.jpg", NAMES, det).plot(),
            "crop": plotting.save_one_box(det[0, :4], scene, BGR=True, save=False),
            "mosaic": written["mosaic.jpg"], "labels": written["labels.jpg"]}


def test_jpeg_reading_gate_refuses_a_q85_file(monkeypatch):
    """`draw.jpeg_reading`, the card's read-back gate: the port's quality-95
    file holds, a quality-85 one does not, on each kind of image; PIL's
    quality-95 4:2:0 file (the card's stand-in) is cv2's byte for byte."""
    import io

    from PIL import Image

    def read(data):
        return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    for name, img in _written_kinds(monkeypatch).items():
        img = np.ascontiguousarray(img)
        cv2_file = cv2.imencode(".jpg", img)[1].tobytes()
        buf = io.BytesIO()
        Image.fromarray(np.ascontiguousarray(img[..., ::-1])).save(buf, "JPEG", quality=95,
                                                                   subsampling=2)
        assert buf.getvalue() == cv2_file, name
        ref = draw.jpeg_reference(img)
        got = {q: draw.jpeg_reading(read(draw.encode_jpeg(img, q)), img, read(cv2_file), ref)
               for q in (95, 90, 85)}
        assert got[95]["holds"], (name, got[95])
        assert not got[85]["holds"], (name, got[85])
        print(name, {q: (round(r["mean_diff"], 4), round(r["psnr_gap_db"], 4), r["holds"])
                     for q, r in got.items()})


def test_imwrite_refuses_other_suffixes(tmp_path):
    for suffix in (".bmp", ".webp", ".tif", ""):
        with pytest.raises(ValueError, match="jpg"):
            draw.imwrite(tmp_path / f"a{suffix}", np.zeros((4, 4, 3), np.uint8))


def _labels(seed=6, n=300, nc=3):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 0.6, (n, 4)).astype(np.float32), rng.integers(0, nc, n)


def test_label_bins_are_matplotlibs():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    boxes, cls = _labels()
    bins = charts.label_bins(boxes, cls)
    fig, ax = plt.subplots()
    n, edges, _ = ax.hist(cls, bins=np.arange(cls.max() + 2) - 0.5, rwidth=0.8)
    np.testing.assert_array_equal(bins["classes"][0], n)
    np.testing.assert_array_equal(bins["classes"][1], edges)
    for key, (i, j) in (("xy", (0, 1)), ("wh", (2, 3))):
        h, xe, ye, _ = ax.hist2d(boxes[:, i], boxes[:, j], bins=50, cmap="Blues")
        for got, want in zip(bins[key], (h, xe, ye)):
            np.testing.assert_array_equal(got, want)
    plt.close(fig)


def test_charts_write_jaxs_files_at_jaxs_sizes(tmp_path):
    boxes, cls = _labels()
    for pkg, out in ((charts, tmp_path / "ours"), (jax_plotting, tmp_path / "jax")):
        pkg.plot_labels(boxes, cls, NAMES, str(out))
        csv = out / "results.csv"
        csv.write_text("epoch,box_loss,cls_loss,map50\n0,1.5,2.0,0.1\n1,1.2,1.7,0.3\n2,1.0,1.5,0.4\n")
        pkg.plot_results(str(csv))
        stats = {"a": {"ap": np.full((3, 10), 0.4), "recall": [0.1, 0.5], "precision": [0.9, 0.6]},
                 "b": {"ap": np.full((3, 10), 0.3), "recall": [0.2, 0.6], "precision": [0.8, 0.5]}}
        pkg.plot_pr_curves(stats, str(out / "pr_curves.png"))
        pkg.feature_visualization(np.random.default_rng(0).random((1, 20, 24, 9)), 3,
                                  str(out / "features"))
    cm_ours, cm_jax = ConfusionMatrix(3), JaxConfusionMatrix(3)
    rng = np.random.default_rng(7)
    cm_ours.matrix[:] = cm_jax.matrix[:] = rng.integers(0, 30, (4, 4))
    cm_ours.plot(str(tmp_path / "ours"), NAMES)
    cm_jax.plot(str(tmp_path / "jax"), NAMES)
    m = cm_jax.matrix.astype(np.float64)
    np.testing.assert_array_equal(cm_ours.normalized(), m / (m.sum(0, keepdims=True) + 1e-9))
    sizes = {"labels.jpg": (1200, 1200), "results.png": (960, 960),
             "pr_curves.png": (720, 840), "confusion_matrix.png": (840, 960)}
    for name, hw in sizes.items():
        ours, theirs = (cv2.imread(str(tmp_path / d / name)) for d in ("ours", "jax"))
        assert ours.shape[:2] == theirs.shape[:2] == hw, name
    # bbox_inches="tight": matplotlib's own size in JAX; the port's is 3 x 160 px
    assert cv2.imread(str(tmp_path / "ours" / "features" / "layer_3.png")).shape == (480, 480, 3)
    assert (tmp_path / "jax" / "features" / "layer_3.png").is_file()

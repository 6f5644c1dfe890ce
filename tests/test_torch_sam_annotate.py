"""`data/utils.auto_annotate` in the port against the JAX package's on the
CPU: the committed flagship (`weights/mgdt_n_synth.npz`) detects objects
in seeded synthetic scenes written as PNG files (at the detector's size,
so the letterbox is exact), each box's centre prompts the tiny SAM of
`tests/test_torch_sam.py` (JAX's variables carried onto the port), and
both packages write YOLO-seg label files. They must be the same files:
the same lines, classes and `:.4g` coordinates, and "\\n" for an image
without detections. Float32 on both sides; the detections agree to 1e-3
px (`tests/test_torch_predict.py`) and the masks' logits are of a few
units, so no contour pixel sits on a rounding tie.
"""
import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from mgdt_yolo_tpu.data.utils import auto_annotate as jax_auto_annotate
from mgdt_yolo_tpu.engine.model import YOLO as JaxYOLO
from mgdt_yolo_tpu.vit.sam import model as jax_model
from mgdt_yolo_tpu_torch.data.synthetic import synthetic_scene
from mgdt_yolo_tpu_torch.data.utils import auto_annotate
from mgdt_yolo_tpu_torch.engine.model import YOLO
from mgdt_yolo_tpu_torch.vit.sam import SAM
from mgdt_yolo_tpu_torch.vit.sam import model as port_model
from test_torch_predict import NPZ
from test_torch_sam import TINY, carry, fill_flax
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

IMGSZ = 128


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("annotate")
    src = root / "images"
    src.mkdir()
    for i in range(3):
        cv2.imwrite(str(src / f"scene{i}.png"), synthetic_scene(i, IMGSZ, seed=4))
    cv2.imwrite(str(src / "blank.png"), np.full((IMGSZ, IMGSZ, 3), 120, np.uint8))
    return root


@pytest.mark.parametrize("sam_imgsz", [64, 256], ids=["sam64", "sam256"])
def test_auto_annotate_writes_jaxs_label_files(scenes, sam_imgsz, monkeypatch):
    monkeypatch.setitem(jax_model.SAM_ARCHS, "sam_t", TINY)
    monkeypatch.setitem(port_model.SAM_ARCHS, "sam_t", TINY)
    monkeypatch.chdir(scenes)  # JAX's predictor saves drawn images under runs/
    js = jax_model.SAM("sam_t", img_size=sam_imgsz)
    js.variables = fill_flax(js.module, jnp.zeros((1, sam_imgsz, sam_imgsz, 3)),
                             jnp.zeros((1, 1, 2)), jnp.ones((1, 1), jnp.int32), seed=8,
                             logit_gain=60.0)
    port_sam = SAM("sam_t", img_size=sam_imgsz, device="cpu")
    carry(port_sam.module, js.variables)
    want = jax_auto_annotate(str(scenes / "images"), det_model=JaxYOLO(str(NPZ)), sam_model=js,
                             out_dir=str(scenes / f"jax{sam_imgsz}"), imgsz=IMGSZ)
    got = auto_annotate(str(scenes / "images"), det_model=YOLO(NPZ, device="cpu"),
                        sam_model=port_sam, out_dir=str(scenes / f"port{sam_imgsz}"),
                        imgsz=IMGSZ)
    names = sorted(p.name for p in want.iterdir())
    assert names == sorted(p.name for p in got.iterdir()) == \
        ["blank.txt", "scene0.txt", "scene1.txt", "scene2.txt"]
    texts = {n: (got / n).read_text() for n in names}
    for n in names:
        assert texts[n] == (want / n).read_text(), n
    assert texts["blank.txt"] == "\n"
    lines = [ln for n in names for ln in texts[n].splitlines() if ln]
    assert len(lines) >= 3 and {ln.split()[0] for ln in lines} <= {"0", "1"}
    assert all(len(ln.split()) >= 7 for ln in lines)  # a class and at least 3 points

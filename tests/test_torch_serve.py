"""The port's demo server (``nsof_tpu_torch/serve/app.py``) against the JAX
package's, with ``device='cpu'``.

- ``DemoService.flow`` on the same base64 PNG payloads as the JAX
  ``DemoService.flow`` (64×64 frame pairs of a moving bright box, on black
  and over a random texture, preset grasp, the device grid snapped to 8 px):
  the port in ``kernel_mode='xla'``, the JAX package's route off the TPU.
  Box, ``any_active``, ``region_pct`` and the decoded mask equal;
  ``mean_mag`` within 1e-6; the flow image ≥ 99.9 % equal and within one
  level (atan2, ROADMAP queue 3).  Measured on the CPU: masks equal, flow
  images 99.99 % and 100 % equal.
- ``draw_overlay`` with ``labels=None`` equal to the JAX one (OpenCV's
  2-pixel rectangles) pixel for pixel, boxes inside, across and outside
  the image, degenerate and with swapped corners.
- ``BrightnessSegmenter``'s masks, in order, equal to the JAX one's
  (OpenCV's labelling) on random blob images, bright and "dark" prompts.
- The server's lifecycle, ``tests/test_serve.py``'s checks ported: GET /
  and /api/health, POST /api/segment (no local OWL-ViT or SAM weights: the
  ``brightness-fallback`` backend) and /api/flow, a malformed and a JPEG
  payload answered with 400, the server up after them.
- ``/api/segment`` with an injected OWL-ViT → SAM chain: ``box_threshold``
  changes the instances for its request and leaves the shared proposer's
  threshold as it was.
"""

import base64
import json
import threading
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest
import scipy.ndimage
import torch

from nsof_tpu.data.gt_tooling import BrightnessSegmenter as JSegmenter
from nsof_tpu.serve import app as japp
from nsof_tpu_torch.data.gt_tooling import BrightnessSegmenter as TSegmenter
from nsof_tpu_torch.serve import app as tapp
from nsof_tpu_torch.utils.png import decode_png, encode_png
from torch_single_thread import one_torch_thread  # noqa: F401  (autouse)


def _b64_cv(arr) -> str:
    ok, buf = cv2.imencode(".png", arr)
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def _decode(data_url: str) -> np.ndarray:
    return decode_png(base64.b64decode(data_url.split(",")[1]))


def _box_frames(textured: bool):
    prev = np.zeros((64, 64), np.uint8)
    prev[20:36, 10:26] = 230
    nxt = np.zeros((64, 64), np.uint8)
    nxt[20:36, 13:29] = 230
    if textured:
        tex = (np.random.default_rng(0).random((64, 64)) * 60).astype(np.uint8)
        prev, nxt = np.maximum(prev, tex), np.maximum(nxt, tex)
    return prev, nxt


@pytest.fixture(scope="module")
def flows():
    jsvc = japp.DemoService()
    tsvc = tapp.DemoService(device="cpu", kernel_mode="xla")
    out = []
    for textured in (False, True):
        prev, nxt = _box_frames(textured)
        req = {"prev": _b64_cv(prev), "next": _b64_cv(nxt), "preset": "grasp"}
        out.append((tsvc.flow(req), jsvc.flow(req)))
    return out


@pytest.mark.parametrize("case", [0, 1], ids=["box", "textured_box"])
def test_flow_equals_jax(flows, case):
    got, ref = flows[case]
    assert got["box"] == ref["box"]
    assert got["any_active"] == ref["any_active"]
    assert got["region_pct"] == ref["region_pct"]
    assert abs(got["mean_mag"] - ref["mean_mag"]) <= 1e-6
    np.testing.assert_array_equal(_decode(got["mask"]), _decode(ref["mask"]))
    g, r = (_decode(x["flow"]).astype(np.int64) for x in (got, ref))
    diff = np.abs(g - r).max(axis=-1)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    assert _decode(got["overlay"]).shape == (64, 64, 3)


BOXES = [[8, 8, 15, 15], [0, 0, 0, 0], [30, 5, 2, 20], [-4, -3, 70, 10],
         [50.4, 40.6, 63, 47], [60, 44, 90, 90]]


def test_draw_overlay_equals_jax():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    masks = [rng.random((48, 64)) > 0.7 for _ in range(3)]
    for boxes in (BOXES, None):
        got = tapp.draw_overlay(img, masks, boxes)
        ref = japp.draw_overlay(img, masks, boxes)
        np.testing.assert_array_equal(got, ref)
    # labels are accepted and not drawn
    np.testing.assert_array_equal(tapp.draw_overlay(img, masks, BOXES, ["a"] * 6),
                                  tapp.draw_overlay(img, masks, BOXES))


def _blob_image(rng, h=97, w=131):
    blobs = scipy.ndimage.gaussian_filter(rng.random((h, w)), 2.0)
    g = ((blobs - blobs.min()) / (blobs.max() - blobs.min()) * 255).astype(np.uint8)
    return np.stack([g, np.roll(g, 3, axis=1), 255 - g], axis=-1)


@pytest.mark.parametrize("prompt", ["bright spots", "dark spots", "  Dark blobs"])
def test_brightness_segmenter_equals_jax(prompt):
    rng = np.random.default_rng(2)
    n_masks = 0
    for _ in range(6):
        img = _blob_image(rng)
        for thresh, min_area in ((150, 1), (150, 30), (180, 100)):
            got = TSegmenter(thresh, min_area)(img, prompt)
            ref = JSegmenter(thresh, min_area)(img, prompt)
            assert len(got) == len(ref)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
            n_masks += len(got)
    assert n_masks > 20


def test_server_endpoints_end_to_end():
    srv = tapp.make_server(device="cpu")
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def get(path):
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status, r.read()

    def post(path, obj):
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                     data=json.dumps(obj).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())

    def b64(arr):
        return base64.b64encode(encode_png(arr)).decode()

    try:
        code, page = get("/")
        assert code == 200 and b"nsof_tpu_torch" in page
        code, health = get("/api/health")
        health = json.loads(health)
        assert code == 200 and health["ok"]
        assert health["device"] == "cpu" and health["device_name"] == "cpu"

        img = np.zeros((48, 64, 3), np.uint8)
        img[10:30, 20:40] = 255
        code, seg = post("/api/segment", {"image": b64(img), "prompt": "white box"})
        assert code == 200, seg
        # no local OWL-ViT or SAM weights: the chain falls back
        assert seg["n_instances"] == 1 and seg["backend"] == "brightness-fallback"
        assert seg["boxes"] == [[20, 10, 39, 29]] and seg["labels"] == ["white box"]
        assert seg["image"].startswith("data:image/png;base64,")

        prev, nxt = _box_frames(textured=True)
        code, fl = post("/api/flow", {"prev": b64(prev), "next": b64(nxt),
                                      "preset": "tabletennis"})
        assert code == 200, fl
        for k in ("flow", "mask", "overlay"):
            assert fl[k].startswith("data:image/png;base64,"), k
            raw = base64.b64decode(fl[k].split(",")[1])
            dec = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_UNCHANGED)
            assert dec is not None and dec.shape[:2] == (64, 64)
        assert isinstance(fl["box"], list) and len(fl["box"]) == 4
        assert isinstance(fl["region_pct"], float) and isinstance(fl["any_active"], bool)

        ok, jpeg = cv2.imencode(".jpg", img)
        for bad, words in (("not-a-png", "base64"),
                           (base64.b64encode(jpeg.tobytes()).decode(), "JPEG")):
            with pytest.raises(urllib.error.HTTPError) as err:
                post("/api/segment", {"image": bad})
            assert err.value.code == 400
            message = json.loads(err.value.read())["error"]
            assert words in message and "PNG" in message, message
        code, _ = get("/api/health")
        assert code == 200
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()


def test_segment_chain_box_threshold():
    """``/api/segment`` with an injected OWL-ViT → SAM chain (the port's
    models at ``TINY_OWLVIT`` and ``TINY_SAM`` on seeded weights, the toy
    tokenizer): ``box_threshold`` sets the proposer's score threshold for
    that request only — the instances equal the chain called directly at
    that threshold, and the shared proposer keeps its own."""
    from nsof_tpu_torch.data import gt_tooling as tgt
    from nsof_tpu_torch.models import owlvit as to
    from nsof_tpu_torch.models import sam as ts

    cfg = to.TINY_OWLVIT
    proposer = tgt.TorchOwlVitBoxProposer.from_params(
        cfg, to.synthetic_owlvit_state_dict(cfg, seed=5),
        tgt.toy_tokenizer(cfg.vocab_size, cfg.max_text_len), score_threshold=0.3, device="cpu")
    sam = ts.Sam(ts.TINY_SAM)
    sam.load_state_dict({k: torch.from_numpy(v)
                         for k, v in ts.synthetic_sam_state_dict(ts.TINY_SAM, 7).items()})
    chain = tgt.TorchSamSegmenter(sam, proposer, device="cpu")
    svc = tapp.DemoService(segmenter=chain, device="cpu")
    img = np.random.default_rng(8).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    body = {"image": base64.b64encode(encode_png(img)).decode(), "prompt": "bright object"}
    scores = []
    for thr in (None, 0.0, 1.0):
        out = svc.segment(body if thr is None else {**body, "box_threshold": thr})
        assert out["backend"] == "TorchSamSegmenter"
        assert proposer.score_threshold == 0.3 and chain.box_proposer is proposer
        proposer.score_threshold = 0.3 if thr is None else thr
        want = chain(img, "bright object")
        proposer.score_threshold = 0.3
        assert out["n_instances"] == len(want)
        scores.append(out["n_instances"])
    # every patch's box at 0, none at 1; the default lies between
    assert scores[1] == (cfg.image_size // cfg.patch_size) ** 2 and scores[2] == 0

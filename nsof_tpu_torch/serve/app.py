"""Interactive demo server — the reference's Gradio LangSAM app
(codebase/lang-segment-anything/app.py:18-76) rebuilt on the stdlib: the
port's counterpart of :mod:`nsof_tpu.serve.app`, with the same endpoints,
JSON fields and page.

* **Text-prompted segmentation** — image + text prompt (+ box/text
  thresholds, app.py:21-26) → instance masks drawn over the image.  Uses
  the injected segmenter, else the OWL-ViT → SAM chain
  (:func:`~nsof_tpu_torch.data.gt_tooling.lang_sam_segmenter`, on the
  service's device, from local weights), else — only where a package or the
  weights are missing — the weightless
  :class:`~nsof_tpu_torch.data.gt_tooling.BrightnessSegmenter`; the response
  reports which backend served it.  ``box_threshold`` sets the proposer's
  score threshold on a copy for the request; one request segments at a time
  (a segmenter holds its image embedding between its two stages).
* **Optical-flow pipelines** (beyond the reference's app) — a frame pair
  → device-state scan (kernel K8) → ROI-gated Farnebäck (K1–K4) →
  Middlebury flow image + motion mask + ROI box, i.e. the headline pipeline
  live, on the device of the :class:`DemoService`.

Images travel as base64 PNG, decoded and encoded by
:mod:`nsof_tpu_torch.utils.png`; another format gets a 400 error asking for
PNG.  :func:`draw_overlay` paints masks and boxes as the JAX one does but
writes no label text.

Endpoints:
    GET  /            the single-page UI
    GET  /api/health  {"ok", "device", "device_name", "segment_backend"}
    POST /api/segment {"image": b64png, "prompt", "box_threshold",
                       "text_threshold"} -> {"image", "boxes", "labels",
                       "n_instances", "backend"}
    POST /api/flow    {"prev": b64png, "next": b64png, "preset"} ->
                      {"flow", "mask", "overlay", "box", "region_pct",
                       "any_active", "mean_mag"}
"""

from __future__ import annotations

import base64
import copy
import dataclasses
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.data import gt_tooling as gt
from nsof_tpu_torch.utils.png import decode_png, encode_png

_PALETTE = [
    (66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
    (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
]


def _b64_to_image(data: str, gray: bool = False) -> np.ndarray:
    """A base64 PNG (with or without its ``data:`` prefix) → uint8 RGB
    ``[H, W, 3]``, or ``[H, W]`` with ``gray``; raises ``ValueError`` for
    anything but PNG."""
    try:
        raw = base64.b64decode(data.split(",")[-1], validate=True)
    except ValueError:
        raise ValueError("image payload is not base64; send base64 PNG") from None
    return decode_png(raw, gray=gray)


def _image_to_b64(img: np.ndarray) -> str:
    return "data:image/png;base64," + base64.b64encode(encode_png(img)).decode()


def _box_band(h: int, w: int, box) -> np.ndarray:
    """The pixels ``cv2.rectangle(img, (x0, y0), (x1, y1), color, 2)`` paints
    on an ``[h, w]`` image: the band within one pixel of the rectangle's
    edges, without its four outer corner pixels."""
    x0, y0, x1, y1 = (int(round(float(v))) for v in np.asarray(box)[:4])
    x0, x1 = sorted((x0, x1))
    y0, y1 = sorted((y0, y1))
    yy = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    outer = (xx >= x0 - 1) & (xx <= x1 + 1) & (yy >= y0 - 1) & (yy <= y1 + 1)
    inner = (xx >= x0 + 2) & (xx <= x1 - 2) & (yy >= y0 + 2) & (yy <= y1 - 2)
    corner = ((xx == x0 - 1) | (xx == x1 + 1)) & ((yy == y0 - 1) | (yy == y1 + 1))
    return outer & ~inner & ~corner


def draw_overlay(
    image_rgb: np.ndarray,
    masks: list[np.ndarray],
    boxes: list[np.ndarray] | None = None,
    labels: list[str] | None = None,
    alpha: float = 0.45,
) -> np.ndarray:
    """lang_sam.utils.draw_image equivalent: alpha-blend colored instance
    masks and draw 2-pixel boxes, as the JAX function does with OpenCV.
    ``labels`` are accepted and not drawn: the port has no text renderer."""
    out = image_rgb.astype(np.float32).copy()
    for i, m in enumerate(masks):
        color = np.array(_PALETTE[i % len(_PALETTE)], np.float32)
        mm = m.astype(bool)
        out[mm] = (1 - alpha) * out[mm] + alpha * color
    out = out.astype(np.uint8)
    if boxes is not None:
        for i, b in enumerate(boxes):
            out[_box_band(*out.shape[:2], b)] = _PALETTE[i % len(_PALETTE)]
    return out


class DemoService:
    """Model state shared across requests (the ServeGradio
    build_model/predict split, app.py:58-73).  Runs the flow pipeline on
    ``device`` (default the CUDA device; raises ``RuntimeError`` without one
    unless ``device='cpu'``), its fast Farnebäck in ``kernel_mode``."""

    def __init__(self, segmenter=None, device=None, kernel_mode: str = "auto"):
        self.device = _build.resolve_device(device)
        self.kernel_mode = kernel_mode
        self._segmenter = segmenter
        self._segment_backend = None
        self._lock = threading.Lock()
        self._segment_lock = threading.Lock()
        self._flow_cache: dict[tuple, object] = {}

    # -- text-prompted segmentation ------------------------------------
    def _build_segmenter(self):
        if self._segmenter is not None:
            self._segment_backend = type(self._segmenter).__name__
            return
        try:
            self._segmenter = gt.lang_sam_segmenter(device=self.device)
            self._segment_backend = "owlvit+sam"
        except (ImportError, OSError):  # no transformers, or no local weights
            self._segmenter = gt.BrightnessSegmenter()
            self._segment_backend = "brightness-fallback"

    def segmenter(self):
        with self._lock:
            if self._segment_backend is None:
                self._build_segmenter()
            return self._segmenter, self._segment_backend

    def segment(self, req: dict) -> dict:
        image = _b64_to_image(req["image"])
        prompt = str(req.get("prompt", ""))
        seg, backend = self.segmenter()
        # box_threshold is the proposer's score threshold (app.py:22; OWL-ViT
        # has one score, so text_threshold is accepted and not used).  The
        # shared proposer is never changed: the request gets shallow copies
        # carrying its threshold, the model shared by reference.
        proposer = getattr(seg, "box_proposer", None)
        if ("box_threshold" in req and hasattr(proposer, "score_threshold")
                and float(req["box_threshold"]) != proposer.score_threshold):
            seg = copy.copy(seg)
            seg.box_proposer = copy.copy(proposer)
            seg.box_proposer.score_threshold = float(req["box_threshold"])
        with self._segment_lock:
            masks = seg(image, prompt)
        boxes, labels = [], []
        for m in masks:
            ys, xs = np.nonzero(m)
            if len(xs) == 0:
                continue
            boxes.append(
                [int(xs.min()), int(ys.min()), int(xs.max()), int(ys.max())]
            )
            labels.append(prompt)
        out = draw_overlay(image, masks, boxes, labels)
        return {
            "image": _image_to_b64(out),
            "boxes": boxes,
            "labels": labels,
            "n_instances": len(masks),
            "backend": backend,
        }

    # -- flow pipeline --------------------------------------------------
    # one closure per uploaded (h, w, preset); bounded so arbitrary uploads
    # cannot grow the cache forever (the oldest entry is evicted first)
    _FLOW_CACHE_MAX = 8

    def _flow_fn(self, h: int, w: int, preset: str):
        key = (h, w, preset)
        with self._lock:
            if key in self._flow_cache:
                return self._flow_cache[key]

        from nsof_tpu_torch.config import DATASETS
        from nsof_tpu_torch.device.frame_sim import FrameSimConfig
        from nsof_tpu_torch.pipelines.segmentation import seg_step
        from nsof_tpu_torch.pipelines.stream import stream_masks

        cfg = DATASETS.get(preset, DATASETS["tabletennis"])
        ms = cfg.roi.memsize
        if h % ms or w % ms or (h, w) != (cfg.image_h, cfg.image_w):
            # snap the device grid to the uploaded size
            ms = max(8, min(h, w) // 8)
            ms = next(m for m in range(ms, 0, -1) if h % m == 0 and w % m == 0)
            cfg = dataclasses.replace(
                cfg,
                image_h=h, image_w=w, window_h=None, window_w=None,
                roi=dataclasses.replace(cfg.roi, memsize=ms),
            )
        sim = FrameSimConfig(m=ms, n=ms)
        dev = self.device

        def run(prev_gray: torch.Tensor, nxt_gray: torch.Tensor) -> dict:
            s = stream_masks(torch.stack([prev_gray, nxt_gray]), cfg, sim,
                             kernel_mode=self.kernel_mode, device=dev)
            step = seg_step(s["mem_gray"][0], prev_gray, nxt_gray, cfg, device=dev)
            return {
                "flow": step["flow"],
                "mask": s["masks"][0],
                "box": step["box"],
                "any_active": s["any_active"][0],
                "region_pct": s["region_pct"][0],
            }

        with self._lock:
            while len(self._flow_cache) >= self._FLOW_CACHE_MAX:
                self._flow_cache.pop(next(iter(self._flow_cache)))
            self._flow_cache[key] = run
        return run

    def flow(self, req: dict) -> dict:
        from nsof_tpu_torch.utils.flow_viz import flow_to_image

        prev = _b64_to_image(req["prev"], gray=True)
        nxt = _b64_to_image(req["next"], gray=True)
        if prev.shape != nxt.shape:
            raise ValueError(
                f"frame shapes differ: {prev.shape} vs {nxt.shape}"
            )
        preset = str(req.get("preset", "tabletennis"))
        h, w = prev.shape
        out = self._flow_fn(h, w, preset)(torch.from_numpy(prev).to(self.device),
                                          torch.from_numpy(nxt).to(self.device))
        flow_img = flow_to_image(out["flow"]).cpu().numpy()
        out = {k: v.cpu().numpy() for k, v in out.items()}
        flow, mask, box = out["flow"], out["mask"], out["box"]
        rgb = np.repeat(prev[..., None], 3, axis=-1)
        overlay = draw_overlay(rgb, [mask > 0], [box], ["motion"])
        return {
            "flow": _image_to_b64(flow_img),
            "mask": _image_to_b64(mask),
            "overlay": _image_to_b64(overlay),
            "box": [int(v) for v in box],
            "any_active": bool(out["any_active"]),
            "region_pct": float(out["region_pct"]),
            "mean_mag": float(np.hypot(flow[..., 0], flow[..., 1]).mean()),
        }

    def health(self) -> dict:
        dev = self.device
        return {
            "ok": True,
            "device": str(dev),
            "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "segment_backend": self._segment_backend or "unbuilt",
        }


_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>nsof_tpu_torch demo</title>
<style>
 body{font-family:system-ui,sans-serif;margin:2rem auto;max-width:70rem;
      color:#1a1a2e}
 h1{font-size:1.4rem} h2{font-size:1.1rem;margin-top:2rem}
 fieldset{border:1px solid #ccd;border-radius:8px;margin:1rem 0;
          padding:1rem}
 label{display:inline-block;margin:.3rem 1rem .3rem 0}
 img{max-width:100%;border:1px solid #dde;border-radius:6px;margin:.4rem}
 .row{display:flex;flex-wrap:wrap;gap:.5rem}
 .row > div{flex:1;min-width:16rem}
 button{padding:.45rem 1rem;border-radius:6px;border:1px solid #88a;
        background:#eef;cursor:pointer}
 pre{background:#f6f6fa;padding:.6rem;border-radius:6px;overflow:auto}
</style></head><body>
<h1>nsof_tpu_torch — neuromorphic spatiotemporal optical flow (PyTorch + CUDA)</h1>
<p id="health">checking device…</p>

<h2>Text-prompted segmentation</h2>
<fieldset>
 <label>Image (PNG) <input type="file" id="segimg" accept="image/png"></label>
 <label>Prompt <input type="text" id="prompt" value="object"></label>
 <label>Box thr <input type="number" id="boxthr" value="0.3" step="0.05"
        min="0" max="1" style="width:4.5rem"></label>
 <label>Text thr <input type="number" id="textthr" value="0.25" step="0.05"
        min="0" max="1" style="width:4.5rem"></label>
 <button onclick="runSeg()">Segment</button>
 <div class="row"><div><img id="segout" alt=""></div></div>
 <pre id="seginfo"></pre>
</fieldset>

<h2>ROI-gated optical flow (device scan &rarr; ROI &rarr; Farneb&auml;ck)</h2>
<fieldset>
 <label>Frame t (PNG) <input type="file" id="prev" accept="image/png"></label>
 <label>Frame t+1 (PNG) <input type="file" id="next" accept="image/png"></label>
 <label>Preset <select id="preset">
   <option>tabletennis</option><option>grasp</option><option>uav</option>
   <option>uavnew2</option><option>autodriving</option></select></label>
 <button onclick="runFlow()">Run pipeline</button>
 <div class="row">
  <div><div>flow</div><img id="flowout" alt=""></div>
  <div><div>mask</div><img id="maskout" alt=""></div>
  <div><div>ROI overlay</div><img id="overlayout" alt=""></div>
 </div>
 <pre id="flowinfo"></pre>
</fieldset>

<script>
async function b64(file){return new Promise((res,rej)=>{
  const r=new FileReader();r.onload=()=>res(r.result);
  r.onerror=rej;r.readAsDataURL(file);});}
async function post(url,body){
  const r=await fetch(url,{method:'POST',
    headers:{'Content-Type':'application/json'},
    body:JSON.stringify(body)});
  const j=await r.json();
  if(!r.ok)throw new Error(j.error||r.statusText);return j;}
async function runSeg(){
  const f=document.getElementById('segimg').files[0];
  if(!f){alert('pick an image');return}
  document.getElementById('seginfo').textContent='running…';
  try{
    const j=await post('/api/segment',{image:await b64(f),
      prompt:document.getElementById('prompt').value,
      box_threshold:+document.getElementById('boxthr').value,
      text_threshold:+document.getElementById('textthr').value});
    document.getElementById('segout').src=j.image;
    document.getElementById('seginfo').textContent=JSON.stringify(
      {backend:j.backend,n_instances:j.n_instances,boxes:j.boxes},null,1);
  }catch(e){document.getElementById('seginfo').textContent=''+e}}
async function runFlow(){
  const a=document.getElementById('prev').files[0];
  const b=document.getElementById('next').files[0];
  if(!a||!b){alert('pick two frames');return}
  document.getElementById('flowinfo').textContent=
    'running… (the first call builds the kernels)';
  try{
    const j=await post('/api/flow',{prev:await b64(a),next:await b64(b),
      preset:document.getElementById('preset').value});
    document.getElementById('flowout').src=j.flow;
    document.getElementById('maskout').src=j.mask;
    document.getElementById('overlayout').src=j.overlay;
    document.getElementById('flowinfo').textContent=JSON.stringify(
      {box:j.box,any_active:j.any_active,
       region_pct:j.region_pct,mean_mag:j.mean_mag},null,1);
  }catch(e){document.getElementById('flowinfo').textContent=''+e}}
fetch('/api/health').then(r=>r.json()).then(j=>{
  document.getElementById('health').textContent=
    'device: '+j.device+' · segmentation backend: '+j.segment_backend;});
</script></body></html>
"""


def make_handler(service: DemoService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, code: int, obj: dict):
            self._send(
                code, json.dumps(obj).encode(), "application/json"
            )

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(200, _PAGE.encode(), "text/html; charset=utf-8")
            elif self.path == "/api/health":
                self._send_json(200, service.health())
            else:
                self._send_json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/api/segment":
                    self._send_json(200, service.segment(req))
                elif self.path == "/api/flow":
                    self._send_json(200, service.flow(req))
                else:
                    self._send_json(404, {"error": "not found"})
            except Exception as e:  # surface the message to the page
                self._send_json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def make_server(
    host: str = "127.0.0.1", port: int = 0, segmenter=None, device=None,
    kernel_mode: str = "auto",
) -> ThreadingHTTPServer:
    """Build (but don't start) the server; port 0 picks a free port."""
    service = DemoService(segmenter, device, kernel_mode)
    return ThreadingHTTPServer((host, port), make_handler(service))


def serve(host: str = "127.0.0.1", port: int = 7860, segmenter=None,
          device=None) -> None:
    srv = make_server(host, port, segmenter, device)
    print(f"nsof_tpu_torch demo serving on http://{host}:{srv.server_address[1]}")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()

"""Ground-truth mask tooling: the port of :mod:`nsof_tpu.data.gt_tooling`.

The reference makes the ``gtmask/`` folders that every accuracy metric is
scored against with GroundingDINO + SAM ("LangSAM",
codebase/lang-segment-anything/lang_sam/lang_sam.py:117-123; CLI
running_test.py:27-56).  As in the JAX package, the chain is built around a
pluggable :class:`PromptSegmenter`:

- :class:`TorchOwlVitBoxProposer` — text → boxes with the port's OWL-ViT
  (:mod:`nsof_tpu_torch.models.owlvit`), GroundingDINO's role
  (lang_sam.py:91-103); ``FlaxOwlVitBoxProposer``'s counterpart;
- :func:`sam_gt_batch` — the ground-truth step on the device: B frames and
  their box prompts → each frame's OR of its instance masks, with the
  port's SAM (:mod:`nsof_tpu_torch.models.sam`), ``multimask_output=False``
  as the reference's ``predict_sam`` (lang_sam.py:105-115);
- :class:`TorchSamSegmenter` — boxes from a proposer → masks through
  :func:`sam_gt_batch`; ``FlaxSamSegmenter``'s counterpart;
- :class:`OwlVitBoxProposer`, :class:`TransformersSamSegmenter` — the
  Hugging Face ``transformers`` models, imported inside the class;
- :func:`lang_sam_segmenter` — the text → boxes → masks chain;
- :class:`BrightnessSegmenter`, :class:`BrightnessBoxProposer` — weightless
  stand-ins for tests and machines without weights.

Weights are read only from local files: a Hugging Face name is a local
directory or resolves in the local cache (``local_files_only``), a SAM
checkpoint is a path.  Without them the constructors raise ``OSError``
(checked before ``transformers``, slow to import, is imported), or
``ImportError`` without ``transformers``.  Every model runs on the
constructor's ``device``: the CUDA device unless the caller passes another,
``RuntimeError`` without one.  :func:`generate_gt_masks` is the reference
CLI's loop, ``batch`` frames a step; frames are read as
:mod:`nsof_tpu_torch.data.scenes` reads them (PNG through
:mod:`nsof_tpu_torch.utils.png`, OpenCV imported inside the call only for
another format) and masks are written as PNG.
"""

from __future__ import annotations

import dataclasses
import pathlib
import zlib
from typing import Optional, Protocol

import numpy as np
import scipy.ndimage
import torch

from nsof_tpu_torch import _build
from nsof_tpu_torch.data.imgproc import resize_cubic
from nsof_tpu_torch.ops.colorspace import rgb_to_gray_u8
from nsof_tpu_torch.utils.timing import span

_EIGHT = np.ones((3, 3), bool)


class PromptSegmenter(Protocol):
    def __call__(self, image_rgb: np.ndarray, text_prompt: str) -> list[np.ndarray]:
        """Returns a list of boolean instance masks for the prompt."""
        ...


class BoxProposer(Protocol):
    def __call__(self, image_rgb: np.ndarray, text_prompt: str) -> list[list[float]]:
        """Returns [x0, y0, x1, y1] boxes grounded in the text prompt."""
        ...


def components_cv2_order(binary: np.ndarray):
    """The 8-connected components of a 2-D boolean image in
    ``cv2.connectedComponentsWithStats(binary, 8)``'s label order: by the
    first 2×2 block (in raster order of the blocks) holding a pixel of the
    component, since OpenCV's default 8-connected labelling scans the image
    two rows at a time.

    Returns ``(labels, order, areas)``: scipy's label image, its label ids
    in OpenCV's order, and the pixel count of each label id (index 0 the
    background)."""
    labels, n = scipy.ndimage.label(binary, structure=_EIGHT)
    if n == 0:
        return labels, np.zeros(0, np.int64), np.zeros(1, np.int64)
    ys, xs = np.nonzero(labels)
    lab = labels[ys, xs]
    block = (ys // 2) * ((binary.shape[1] + 1) // 2) + xs // 2
    first_block = np.full(n + 1, np.iinfo(np.int64).max)
    np.minimum.at(first_block, lab, block)
    areas = np.bincount(lab, minlength=n + 1)
    order = np.argsort(first_block[1:], kind="stable") + 1
    return labels, order, areas


class BrightnessSegmenter:
    """Weightless stand-in: segments bright (or dark) blobs; the text
    prompt selects polarity ('dark ...' → dark blobs).

    The gray image is ``cv2.COLOR_RGB2GRAY``'s; the blobs are the
    8-connected components of the thresholded image with at least
    ``min_area`` pixels, listed in ``cv2.connectedComponentsWithStats``'s
    label order (:func:`components_cv2_order`).
    """

    def __init__(self, thresh: int = 180, min_area: int = 100):
        self.thresh = thresh
        self.min_area = min_area

    def __call__(self, image_rgb, text_prompt: str) -> list[np.ndarray]:
        gray = rgb_to_gray_u8(torch.as_tensor(np.asarray(image_rgb))).numpy()
        if text_prompt.strip().lower().startswith("dark"):
            binary = gray <= 255 - self.thresh  # THRESH_BINARY_INV
        else:
            binary = gray > self.thresh  # THRESH_BINARY
        labels, order, areas = components_cv2_order(binary)
        return [labels == i for i in order if areas[i] >= self.min_area]


class BrightnessBoxProposer:
    """Weightless text → box stand-in: the bounding boxes of bright or dark
    blobs (polarity from the prompt, as :class:`BrightnessSegmenter`)."""

    def __init__(self, thresh: int = 180, min_area: int = 100):
        self._seg = BrightnessSegmenter(thresh, min_area)

    def __call__(self, image_rgb, text_prompt):
        boxes = []
        for m in self._seg(image_rgb, text_prompt):
            ys, xs = np.nonzero(m)
            boxes.append([float(xs.min()), float(ys.min()), float(xs.max() + 1),
                          float(ys.max() + 1)])
        return boxes


def toy_tokenizer(vocab_size: int, max_len: int):
    """A deterministic stand-in for CLIP's tokenizer where ``transformers``
    or the tokenizer files are missing: BOS (``vocab_size − 2``), one id a
    word from its CRC-32 in [1, vocab_size − 3], EOS (``vocab_size − 1``,
    the highest id, where the text tower pools), zero-padded to
    ``max_len``.  It is not CLIP's vocabulary: only random or synthetic
    weights make sense with it."""
    def tokenize(text: str) -> np.ndarray:
        words = [1 + zlib.crc32(w.encode()) % (vocab_size - 3) for w in text.lower().split()]
        ids = [vocab_size - 2] + words[: max_len - 2] + [vocab_size - 1]
        return np.asarray(ids + [0] * (max_len - len(ids)), dtype=np.int64)

    return tokenize


def _whole_image(img, prompt):
    return [[0, 0, img.shape[1], img.shape[0]]]


def _require_local(model_name: str) -> None:
    """Raises ``OSError`` unless ``model_name`` is a local directory or is
    in the local Hugging Face cache, before ``transformers`` is imported
    (``ImportError`` without ``huggingface_hub``)."""
    if pathlib.Path(model_name).is_dir():
        return
    from huggingface_hub import try_to_load_from_cache

    try:
        found = try_to_load_from_cache(model_name, "config.json")
    except ValueError:  # not a valid repository name
        found = None
    if not isinstance(found, str):
        raise OSError(f"{model_name!r} is neither a local directory nor in the "
                      "local Hugging Face cache")


class OwlVitBoxProposer:
    """Text → boxes with Hugging Face's OWL-ViT pipeline (the JAX package's
    class of the same name); ``score_threshold`` plays box_threshold's role
    (the reference's default 0.3, lang_sam.py:117).  Needs ``transformers``
    and the model in the local Hugging Face cache.  Runs on ``device``
    (default the CUDA device; raises ``RuntimeError`` without one unless
    ``device='cpu'``)."""

    def __init__(self, model_name: str = "google/owlvit-base-patch32",
                 score_threshold: float = 0.3, device=None):
        self.device = _build.resolve_device(device)
        _require_local(model_name)
        from transformers import OwlViTForObjectDetection, OwlViTProcessor

        self.model = OwlViTForObjectDetection.from_pretrained(
            model_name, local_files_only=True).to(self.device).eval()
        self.processor = OwlViTProcessor.from_pretrained(model_name, local_files_only=True)
        self.score_threshold = score_threshold

    def __call__(self, image_rgb, text_prompt):
        from nsof_tpu_torch.models.owlvit import post_process_detection

        inputs = self.processor(text=[[text_prompt]], images=image_rgb, return_tensors="pt")
        with torch.no_grad():
            out = self.model(**{k: v.to(self.device) for k, v in inputs.items()})
        # the port's post-processing: the processor's own moved between
        # transformers 4 and 5
        boxes, _, _ = post_process_detection(out.logits[0].cpu().numpy(),
                                             out.pred_boxes[0].cpu().numpy(),
                                             image_rgb.shape[:2], threshold=self.score_threshold)
        return [list(map(float, b)) for b in boxes]


class TorchOwlVitBoxProposer:
    """Text → boxes with the port's OWL-ViT (``FlaxOwlVitBoxProposer``'s
    counterpart): the frame resized to the model's square with
    ``cv2.resize(INTER_CUBIC)``'s arithmetic (:func:`resize_cubic`, on the
    host), uploaded as uint8 and CLIP-normalised on the device, one forward,
    Hugging Face's post-processing at ``score_threshold``, the boxes clipped
    to the frame (SAM's box prompts must lie inside it).

    The default constructor reads a Hugging Face ``OwlViTForObjectDetection``
    and its tokenizer from the local cache (``transformers`` imported here);
    :meth:`from_params` takes (config, state dict, tokenizer).  Runs on
    ``device`` (default the CUDA device; raises ``RuntimeError`` without one
    unless ``device='cpu'``)."""

    # CLIP preprocessing constants (Hugging Face OwlViTImageProcessor defaults)
    MEAN = (0.48145466, 0.4578275, 0.40821073)
    STD = (0.26862954, 0.26130258, 0.27577711)

    def __init__(self, model_name: str = "google/owlvit-base-patch32",
                 score_threshold: float = 0.3, device=None):
        device = _build.resolve_device(device)
        _require_local(model_name)
        from transformers import AutoTokenizer, OwlViTForObjectDetection

        from nsof_tpu_torch.models.owlvit import infer_owlvit_config

        state = OwlViTForObjectDetection.from_pretrained(
            model_name, local_files_only=True).state_dict()
        cfg = infer_owlvit_config(state)
        hf_tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)

        def tokenizer(text: str) -> np.ndarray:
            return np.asarray(hf_tok(text, padding="max_length", truncation=True,
                                     max_length=cfg.max_text_len)["input_ids"], dtype=np.int64)

        self._init(cfg, state, tokenizer, score_threshold, device)

    @classmethod
    def from_params(cls, cfg, state_dict, tokenizer, score_threshold: float = 0.3, device=None):
        self = cls.__new__(cls)
        self._init(cfg, state_dict, tokenizer, score_threshold, device)
        return self

    def _init(self, cfg, state_dict, tokenizer, score_threshold, device):
        from nsof_tpu_torch.models.owlvit import load_owlvit_state

        self.device = _build.resolve_device(device)
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.score_threshold = score_threshold
        self.model = load_owlvit_state(state_dict, cfg).to(self.device).eval()
        self.model.requires_grad_(False)
        dev = self.device
        self._mean = torch.tensor(self.MEAN, dtype=torch.float32, device=dev)
        self._std = torch.tensor(self.STD, dtype=torch.float32, device=dev)
        self._255 = torch.tensor(255.0, dtype=torch.float32, device=dev)

    def pixels(self, image_rgb: np.ndarray) -> torch.Tensor:
        """The frame as the model's ``[1, 3, S, S]`` input on the device."""
        s = self.cfg.image_size
        x = torch.from_numpy(resize_cubic(np.ascontiguousarray(image_rgb), s, s))
        x = x.to(self.device).to(torch.float32) / self._255
        return ((x - self._mean) / self._std).permute(2, 0, 1)[None]

    def __call__(self, image_rgb, text_prompt):
        from nsof_tpu_torch.models.owlvit import post_process_detection

        ids = torch.as_tensor(self.tokenizer(text_prompt), dtype=torch.int64)
        with torch.inference_mode():
            out = self.model(self.pixels(image_rgb), ids.reshape(1, 1, -1).to(self.device))
        h, w = image_rgb.shape[:2]
        boxes, _, _ = post_process_detection(out["logits"][0].cpu().numpy(),
                                             out["pred_boxes"][0].cpu().numpy(), (h, w),
                                             threshold=self.score_threshold)
        if len(boxes):
            boxes = np.clip(boxes, 0.0, [w, h, w, h])
        return [list(map(float, b)) for b in boxes]


class TransformersSamSegmenter:
    """SAM through Hugging Face ``transformers`` with box prompts from a box
    proposer; needs the model in the local Hugging Face cache.  Runs on
    ``device`` (default the CUDA device; raises ``RuntimeError`` without one
    unless ``device='cpu'``)."""

    def __init__(self, model_name: str = "facebook/sam-vit-base", box_proposer=None,
                 device=None):
        self.device = _build.resolve_device(device)
        _require_local(model_name)
        from transformers import SamModel, SamProcessor

        self.model = SamModel.from_pretrained(
            model_name, local_files_only=True).to(self.device).eval()
        self.processor = SamProcessor.from_pretrained(model_name, local_files_only=True)
        self.box_proposer = box_proposer or _whole_image

    def __call__(self, image_rgb, text_prompt):
        boxes = self.box_proposer(image_rgb, text_prompt)
        if not boxes:
            return []
        inputs = self.processor(image_rgb, input_boxes=[[list(map(float, b)) for b in boxes]],
                                return_tensors="pt")
        with torch.no_grad():
            out = self.model(**{k: v.to(self.device) for k, v in inputs.items()})
        masks = self.processor.image_processor.post_process_masks(
            out.pred_masks.cpu(), inputs["original_sizes"].cpu(),
            inputs["reshaped_input_sizes"].cpu())[0]
        return [np.asarray(m[0]) > 0 for m in masks]


def sam_gt_batch(model, frames: torch.Tensor, boxes: torch.Tensor, box_frame: torch.Tensor,
                 instances: bool = False) -> dict:
    """The ground-truth step on a batch, on the model's device with no host
    synchronisation: uint8 RGB ``frames`` ``[B, H, W, 3]``, float32
    ``boxes`` ``[N, 4]`` xyxy in frame pixels and int64 ``box_frame`` ``[N]``
    (each box's frame, sorted) →

    - ``mask`` bool ``[B, H, W]``: the OR of each frame's instance masks,
      all False for a frame with no box;
    - ``low_res`` ``[N, 1, 4S', 4S']`` logits and ``iou`` ``[N, 1]``, the
      first mask token's (``multimask_output=False``);
    - with ``instances``, ``instances`` bool ``[N, H, W]``, each box's mask.

    One encoder call on the B frames (:func:`~nsof_tpu_torch.models.sam.
    preprocess_frames`, :func:`~nsof_tpu_torch.models.sam.encode_images`),
    one decoder call on the N boxes, each on its own frame's embedding
    (:func:`~nsof_tpu_torch.models.sam.decode_prompts`), then the two
    resizes, the threshold and the OR (an integer count per pixel).  Spans:
    ``nsof.sam_gt_batch`` around the ``nsof.sam.*`` of the pieces; the
    frames and boxes are counted in ``_build.COUNTS``."""
    from nsof_tpu_torch.models import sam as tsam

    b, h, w = frames.shape[:3]
    n = boxes.shape[0]
    cfg = model.config
    input_size = tsam.preprocess_shape(h, w, cfg.img_size)
    with span("nsof.sam_gt_batch"), torch.inference_mode():
        emb = tsam.encode_images(model, tsam.preprocess_frames(model, frames))
        if n:
            corners = tsam.transform_coords(boxes.reshape(-1, 2, 2), (h, w), input_size)
            low_res, iou = tsam.decode_prompts(model, emb, boxes=corners.reshape(-1, 4),
                                               image_index=box_frame)
            low_res, iou = low_res[:, :1], iou[:, :1]
        else:
            side = 4 * cfg.embedding_size
            low_res, iou = emb.new_zeros((0, 1, side, side)), emb.new_zeros((0, 1))
        with span("nsof.sam.postprocess"):
            inst = tsam.postprocess_masks(low_res, input_size, (h, w), cfg.img_size)[:, 0]
            inst = inst > tsam.MASK_THRESHOLD
            count = torch.zeros((b, h, w), dtype=torch.int32, device=frames.device)
            count.index_add_(0, box_frame, inst.to(torch.int32))
            out = {"mask": count > 0, "low_res": low_res, "iou": iou}
    _build.COUNTS["sam_frames"] += b
    _build.COUNTS["sam_boxes"] += n
    if instances:
        out["instances"] = inst
    return out


class TorchSamSegmenter:
    """Boxes from a proposer → masks with the port's SAM
    (``FlaxSamSegmenter``'s counterpart) through :func:`sam_gt_batch`,
    ``multimask_output=False`` as the reference's ``predict_sam``
    (lang_sam.py:105-115).  Takes a
    :class:`~nsof_tpu_torch.models.sam.Sam` holding its weights; build from
    an official ``sam_vit_*.pth`` with :meth:`for_checkpoint`.  The proposer
    defaults to the whole frame.  Runs on ``device`` (default the CUDA
    device; raises ``RuntimeError`` without one unless ``device='cpu'``)."""

    def __init__(self, model, box_proposer=None, device=None):
        self.device = _build.resolve_device(device)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.box_proposer = box_proposer or _whole_image

    @classmethod
    def for_checkpoint(cls, path: str, box_proposer=None, device=None):
        from nsof_tpu_torch.models.sam import pretrained_sam

        device = _build.resolve_device(device)
        return cls(pretrained_sam(path), box_proposer, device)

    def _step(self, images: list, boxes: list, instances: bool = False) -> dict:
        """:func:`sam_gt_batch` on same-sized frames and their box lists."""
        dev = self.device
        frames = torch.from_numpy(np.stack([np.ascontiguousarray(i) for i in images])).to(dev)
        flat = np.asarray([b for bs in boxes for b in bs], np.float32).reshape(-1, 4)
        owner = np.repeat(np.arange(len(boxes)), [len(bs) for bs in boxes])
        return sam_gt_batch(self.model, frames, torch.from_numpy(flat).to(dev),
                            torch.from_numpy(owner).to(dev), instances)

    def __call__(self, image_rgb, text_prompt):
        boxes = self.box_proposer(image_rgb, text_prompt)
        if not boxes:
            return []
        return list(self._step([image_rgb], [boxes], instances=True)["instances"].cpu().numpy())

    def combined_masks(self, images: list, text_prompt: str) -> list[tuple[np.ndarray, int]]:
        """Each frame's OR of its instance masks and their count: the boxes of
        every frame, then one :func:`sam_gt_batch` on the frames that have a
        box (runs of consecutive frames of one size)."""
        boxes = [self.box_proposer(img, text_prompt) for img in images]
        out = [(np.zeros(img.shape[:2], bool), len(bs)) for img, bs in zip(images, boxes)]
        runs = []
        for i in (i for i, bs in enumerate(boxes) if bs):
            if runs and images[runs[-1][-1]].shape == images[i].shape:
                runs[-1].append(i)
            else:
                runs.append([i])
        for run in runs:
            masks = self._step([images[i] for i in run], [boxes[i] for i in run])["mask"]
            for i, m in zip(run, masks.cpu().numpy()):
                out[i] = (m, len(boxes[i]))
        return out


def lang_sam_segmenter(sam_model: str = "facebook/sam-vit-base",
                       owl_model: str = "google/owlvit-base-patch32",
                       score_threshold: float = 0.3, sam_checkpoint: Optional[str] = None,
                       native_grounding: bool = True, device=None) -> PromptSegmenter:
    """The LangSAM chain (lang_sam.py:117-123): open-vocabulary text → boxes
    (OWL-ViT in GroundingDINO's place) feeding SAM's box-prompted masks.
    With ``sam_checkpoint`` (an official ``sam_vit_*.pth``) the port's SAM
    makes the masks, otherwise Hugging Face's SAM from the local cache.  The
    boxes come from the port's OWL-ViT built from the locally cached Hugging
    Face checkpoint, or with ``native_grounding=False`` from Hugging Face's
    pipeline.  Every model runs on ``device``.  Raises ``ImportError``
    or ``OSError`` where a package or the weights are missing.  Build the
    pieces yourself to substitute stand-ins."""
    if native_grounding:
        proposer = TorchOwlVitBoxProposer(owl_model, score_threshold, device)
    else:
        proposer = OwlVitBoxProposer(owl_model, score_threshold, device)
    if sam_checkpoint is not None:
        return TorchSamSegmenter.for_checkpoint(sam_checkpoint, proposer, device)
    return TransformersSamSegmenter(sam_model, proposer, device)


@dataclasses.dataclass
class MaskGenResult:
    frame: str
    n_instances: int
    mask_path: str


def _read_rgb(path: pathlib.Path) -> np.ndarray:
    """A frame as uint8 RGB: PNG by the port's codec, another format by
    OpenCV (imported here)."""
    if path.suffix.lower() == ".png":
        from nsof_tpu_torch.utils.png import decode_png

        return decode_png(path.read_bytes())
    import cv2

    bgr = cv2.imread(str(path))
    if bgr is None:
        raise OSError(f"cannot read {path}")
    return cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)


def generate_gt_masks(image_dir, imgs_txt, out_dir, text_prompt: str,
                      segmenter: PromptSegmenter, batch: int = 1) -> list[MaskGenResult]:
    """The reference mask-generation loop (running_test.py:27-56): for each
    frame listed in ``imgs_txt``, OR all instance masks of the prompt and
    write a {0, 255} mask PNG (all black when nothing is found) under the
    frame's own name, where :func:`~nsof_tpu_torch.data.scenes.load_scene`
    looks for it (OpenCV's ``imread`` decodes it by content whatever the
    suffix).  Frames are read ``batch`` at a time; a segmenter with a
    ``combined_masks`` method (:class:`TorchSamSegmenter`) takes them as one
    step, any other one frame at a time.  The PNGs are written after the
    step."""
    from nsof_tpu_torch.utils.png import encode_png

    image_dir = pathlib.Path(image_dir)
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    names = [s for s in pathlib.Path(imgs_txt).read_text().splitlines() if s.strip()]
    combined = getattr(segmenter, "combined_masks", None) or (
        lambda images, prompt: [_or_masks(rgb, segmenter(rgb, prompt)) for rgb in images])
    results = []
    for start in range(0, len(names), batch):
        group = names[start : start + batch]
        masks = combined([_read_rgb(image_dir / name) for name in group], text_prompt)
        for name, (mask, n) in zip(group, masks):
            out_path = out_dir / name
            out_path.write_bytes(encode_png(mask.astype(np.uint8) * 255))
            results.append(MaskGenResult(name, n, str(out_path)))
    return results


def _or_masks(rgb: np.ndarray, masks: list) -> tuple[np.ndarray, int]:
    combined = np.zeros(rgb.shape[:2], bool)
    for m in masks:
        combined |= np.asarray(m) > 0
    return combined, len(masks)

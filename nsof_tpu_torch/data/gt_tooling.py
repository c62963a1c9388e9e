"""Ground-truth mask tooling: the port's weightless segmenter.

The port's counterpart of :class:`nsof_tpu.data.gt_tooling.BrightnessSegmenter`,
the deterministic stand-in the demo server segments with.  The JAX module's
text-grounded chain (OWL-ViT boxes → SAM masks, ``lang_sam_segmenter``) is
not ported yet.
"""

from __future__ import annotations

import numpy as np
import scipy.ndimage
import torch

from nsof_tpu_torch.ops.colorspace import rgb_to_gray_u8

_EIGHT = np.ones((3, 3), bool)


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

"""Image listing and decode for the enhance, predict and evaluate routes.

Counterpart of the part of ``retinex_tpu/data/dataset.py`` that those need
(its two extension sets, a non-recursive ``list_image_files`` and
``decode_image``); the training datasets and loaders land with training.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

VALID_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp"}  # predict, evaluate
VALID_EXTENSIONS_ENHANCE = VALID_EXTENSIONS | {".tif", ".tiff"}


def list_image_files(image_dir: str, extensions=VALID_EXTENSIONS_ENHANCE) -> list[str]:
    """Sorted, non-recursive scan of `image_dir` for files whose lower-cased
    extension is in `extensions`."""
    return sorted(
        os.path.join(image_dir, n)
        for n in os.listdir(image_dir)
        if os.path.splitext(n)[1].lower() in extensions
    )


def decode_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 HWC via PIL."""
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))

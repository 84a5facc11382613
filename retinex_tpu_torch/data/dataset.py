"""Image listing and decode for the enhance routes.

Counterpart of the part of ``retinex_tpu/data/dataset.py`` that enhance
needs (its enhance extension set, ``list_image_files`` and
``decode_image``); the training datasets and loaders land with training.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

VALID_EXTENSIONS_ENHANCE = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}


def list_image_files(image_dir: str) -> list[str]:
    """Sorted, non-recursive scan of `image_dir` for files whose lower-cased
    extension is in VALID_EXTENSIONS_ENHANCE."""
    return sorted(
        os.path.join(image_dir, n)
        for n in os.listdir(image_dir)
        if os.path.splitext(n)[1].lower() in VALID_EXTENSIONS_ENHANCE
    )


def decode_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 HWC via PIL."""
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))

"""Adaptive parameter analysis + Lab-CLAHE enhancement of the net output.

Counterpart of ``retinex_tpu/infer/adaptive_params.py``: the
brightness-histogram features, the rule-based parameter table, and Lab-CLAHE
post-processing (clip 2.0, 8x8 tiles) of the network output. As in the JAX
package, the parameter table is computed and then not used by the
enhancement, which applies CLAHE only.
"""

from __future__ import annotations

import torch

from retinex_tpu_torch.ops.clahe import clahe_lab_rgb
from retinex_tpu_torch.ops.colorspace import ieee_div, rgb_to_luma


def gray_levels(x: torch.Tensor) -> torch.Tensor:
    """The OpenCV gray image of x [..., 3] float [0,1] as float levels
    [..., 1]: the Rec.601 luma of the u8-rounded image, rounded. The byte /
    255 is the IEEE quotient on every device (``ieee_div``), so the card
    gives the CPU's levels."""
    return torch.round(rgb_to_luma(ieee_div(torch.round(x * 255.0), 255.0)) * 255.0)


def brightness_features(x: torch.Tensor) -> dict[str, torch.Tensor]:
    """x: [H,W,3] or [B,H,W,3] float [0,1]. Features of the OpenCV gray image
    (``gray_levels``)."""
    gray = gray_levels(x)
    return {
        "mean_brightness": gray.mean() / 255.0,
        "brightness_std": gray.std(unbiased=False) / 255.0,
        "dark_pixel_ratio": (gray < 50.0).float().mean(),
        "mid_pixel_ratio": ((gray >= 50.0) & (gray <= 200.0)).float().mean(),
        "bright_pixel_ratio": (gray > 200.0).float().mean(),
    }


class AdaptiveParameterAdjuster:
    """Rule-based parameter adjustment + CLAHE application."""

    default_params = {
        "enhance_strength": 1.0,
        "color_balance": 1.0,
        "brightness_boost": 1.0,
        "contrast_adjust": 1.0,
    }

    def calculate_brightness_features(self, image: torch.Tensor) -> dict[str, float]:
        return {k: float(v) for k, v in brightness_features(image).items()}

    def adjust_parameters(self, image: torch.Tensor) -> dict[str, float]:
        """The reference's rule table."""
        f = self.calculate_brightness_features(image)
        params = dict(self.default_params)
        mb = f["mean_brightness"]
        if mb < 0.2:
            params["enhance_strength"], params["brightness_boost"] = 1.5, 1.3
        elif mb < 0.4:
            params["enhance_strength"], params["brightness_boost"] = 1.3, 1.2
        elif mb > 0.7:
            params["enhance_strength"], params["brightness_boost"] = 0.8, 0.9
        std = f["brightness_std"]
        if std < 0.1:
            params["contrast_adjust"] = 1.3
        elif std < 0.2:
            params["contrast_adjust"] = 1.1
        else:
            params["contrast_adjust"] = 0.9
        dark = f["dark_pixel_ratio"]
        if dark > 0.6:
            params["color_balance"] = 1.2
        elif dark > 0.3:
            params["color_balance"] = 1.1
        return params

    def apply_clahe_enhancement(self, image: torch.Tensor) -> torch.Tensor:
        """Lab-space CLAHE on the L channel (clip 2.0, 8x8 tiles)."""
        return clahe_lab_rgb(image)

    def apply_adaptive_enhancement(self, apply_fn, image: torch.Tensor):
        """Net forward then CLAHE on the output.

        apply_fn: NHWC batch -> (enhanced, reflectance, illumination).
        Returns (enhanced, illumination), batch dim dropped for an HWC input."""
        x = image
        squeeze = x.ndim == 3
        if squeeze:
            x = x[None]
        # Computed for API parity and unused, as in the reference; skipped
        # while torch.export traces (its float() reads the data), as the JAX
        # package skips it under a tracer.
        if not torch.compiler.is_exporting():
            self.adjust_parameters(x)
        enhanced, _refl, illu = apply_fn(x)
        enhanced = clahe_lab_rgb(torch.clamp(enhanced, 0.0, 1.0))
        if squeeze:
            return enhanced[0], illu[0]
        return enhanced, illu

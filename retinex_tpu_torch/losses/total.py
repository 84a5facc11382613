"""TotalLoss: the weighted mix of the seven losses, with the
texture-adaptive smoothness weight and DWA (dynamic weight averaging).

Counterpart of ``retinex_tpu/losses/total.py``. The DWA history is a
fixed-size carry, ``LossState`` (the last two loss vectors and a step
count), threaded through the train step and checkpointed, as in the JAX
package. Its quirk is kept: the reference's own train loop never passes
``epoch``, so its ``adaptive_weights and epoch > 1`` gate keeps DWA off; here
(as in the JAX package) DWA engages once two steps of history exist, with
``adaptive_weights=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from retinex_tpu_torch.losses.losses import (
    color_loss,
    decoupling_loss,
    exposure_loss,
    frequency_loss,
    perceptual_loss,
    smoothness_loss,
    spatial_consistency_loss,
    texture_complexity,
)
from retinex_tpu_torch.parallel.distributed import all_reduce_sum, data_world, global_mean

LOSS_NAMES = ("exposure", "smoothness", "color", "spatial", "decouple", "perceptual", "frequency")
# The losses each rank computes whole across ranks (the rest are shares).
WHOLE_LOSSES = [LOSS_NAMES.index("color")]


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and toggles (the JAX package's defaults)."""

    weight_exp: float = 10.0
    weight_smooth: float = 1.0
    weight_col: float = 0.5
    weight_spa: float = 1.0
    weight_decouple: float = 0.1
    weight_perceptual: float = 1.0
    weight_freq: float = 0.5
    use_freq_loss: bool = False
    use_perceptual_loss: bool = True
    adaptive_weights: bool = False
    use_dynamic_smooth_weight: bool = True
    texture_method: str = "tv"
    dwa_temperature: float = 2.0

    def base_weights(self, device=None) -> torch.Tensor:
        return torch.tensor(
            [self.weight_exp, self.weight_smooth, self.weight_col, self.weight_spa,
             self.weight_decouple, self.weight_perceptual, self.weight_freq],
            dtype=torch.float32, device=device,
        )


@dataclasses.dataclass
class LossState:
    """DWA carry: the last two per-loss vectors ([7] f32) and a step count
    (0-dim int32), all on the device."""

    prev: torch.Tensor
    prev2: torch.Tensor
    step: torch.Tensor

    @classmethod
    def create(cls, device=None) -> "LossState":
        z = torch.zeros(len(LOSS_NAMES), dtype=torch.float32, device=device)
        return cls(prev=z, prev2=z.clone(), step=torch.zeros((), dtype=torch.int32, device=device))


def _dwa_weights(cfg: LossConfig, state: LossState) -> torch.Tensor:
    """w_i = (loss_i[t-1] / loss_i[t-2]) / T, renormalised to sum to N; the
    static weights until two steps of history exist."""
    floor = torch.full_like(state.prev2, 1e-8)
    ratio = torch.where(state.prev2 > 1e-8, state.prev / torch.maximum(state.prev2, floor), torch.ones_like(floor))
    w = ratio / cfg.dwa_temperature
    w = float(len(LOSS_NAMES)) * w / torch.maximum(w.sum(), floor[0])
    return torch.where(state.step >= 2, w, cfg.base_weights(w.device))


class TotalLoss:
    """Callable aggregator. `vgg` maps [B,H,W,3] -> (f1, f2, f3) (a
    ``models/vgg.VGG19Features``), or None to leave the perceptual term at
    0."""

    def __init__(self, config: LossConfig | None = None, vgg: Callable | None = None):
        self.config = config or LossConfig()
        self.vgg = vgg

    def __call__(
        self,
        img_low: torch.Tensor,
        img_enhanced: torch.Tensor,
        illu_map: torch.Tensor,
        reflectance: torch.Tensor | None = None,
        state: LossState | None = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor], LossState]:
        """Returns (total, loss_dict, new_state): loss_dict holds the total
        and the seven losses as 0-dim device tensors, to be fetched once per
        logging interval. Across ranks `total` is this rank's part, whose
        gradients summed over the ranks are the global batch's; loss_dict
        and the DWA carry hold the global batch's losses."""
        cfg = self.config
        dev = img_enhanced.device
        state = state or LossState.create(dev)
        zero = torch.zeros((), device=dev)

        l_exp = exposure_loss(img_enhanced, img_low)
        l_smooth = smoothness_loss(illu_map, img_low)
        l_col = color_loss(img_enhanced)
        l_spa = spatial_consistency_loss(img_enhanced, img_low)
        use_vgg = cfg.use_perceptual_loss and self.vgg is not None
        l_percep = perceptual_loss(self.vgg, img_enhanced, img_low) if use_vgg else zero
        l_dec = decoupling_loss(illu_map, reflectance) if reflectance is not None else zero
        l_freq = frequency_loss(img_enhanced, img_low) if cfg.use_freq_loss else zero
        losses = torch.stack([l_exp, l_smooth, l_col, l_spa, l_dec, l_percep, l_freq])

        weights = _dwa_weights(cfg, state) if cfg.adaptive_weights else cfg.base_weights(dev)
        if cfg.use_dynamic_smooth_weight:
            with torch.no_grad():
                avg_complexity = global_mean(texture_complexity(img_low, cfg.texture_method))
                # jnp.clip's order: the maximum, then the minimum.
                w_smooth = torch.clamp(weights[1] * (1.0 - avg_complexity * 0.8), 0.1, 5.0)
            weights = torch.cat([weights[:1], w_smooth[None], weights[2:]])

        total = (weights * losses).sum()
        reported, reported_total = losses, total
        if data_world() > 1:
            # The global batch's losses: the ranks' shares summed, and the
            # colour loss, which every rank holds whole, once.
            with torch.no_grad():
                whole = torch.zeros_like(losses)
                whole[WHOLE_LOSSES] = 1.0
                reported = all_reduce_sum(losses * (1.0 - whole)) + losses * whole
                reported_total = (weights * reported).sum()
        new_state = LossState(prev=reported.detach(), prev2=state.prev, step=state.step + 1)
        loss_dict = {"total": reported_total, **dict(zip(LOSS_NAMES, reported))}
        return total, loss_dict, new_state

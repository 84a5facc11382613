"""Driver hook: the flagship net's forward with an example input.

Counterpart of ``__graft_entry__.py::entry``: ``entry()`` returns
``(forward, (example,))``, the eval-mode forward of MultiScaleUPRetinex with
pre-activation blocks and ASPP (untrained weights, seed 0, as the JAX hook's
``PRNGKey(0)``) and a [1, 128, 128, 3] float input from numpy seed 0, both on
the card unless ``device="cpu"``. The JAX hook's ``dryrun_multichip`` drives
the data-parallel and spatially sharded paths, which the port does not have
yet (ROADMAP Queue 1 items 8 and 9).
"""

from __future__ import annotations

import numpy as np
import torch

from retinex_tpu_torch.device import resolve_device


def entry(device: str | torch.device | None = None):
    from retinex_tpu_torch.models.init import init_untrained
    from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex

    dev = resolve_device(device)
    model = init_untrained(MultiScaleUPRetinex(use_preact=True, use_aspp=True), 0).eval().to(dev)

    def forward(batch: torch.Tensor):
        with torch.inference_mode():
            return model(batch)

    example = np.random.default_rng(0).random((1, 128, 128, 3)).astype(np.float32)
    return forward, (torch.from_numpy(example).to(dev),)

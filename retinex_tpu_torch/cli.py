"""CLI of the port: ``--mode enhance`` on one image file.

Counterpart of ``retinex_tpu/cli.py`` for the route this port runs so far::

    python -m retinex_tpu_torch.cli --mode enhance --input_path photo.jpg \\
        --output_dir out --max_size 1920

It runs MultiScaleUPRetinex through the space-to-depth packed forward
(``models/packed_inference.py``, the Config default, with the FAM on CUDA
kernels: K4, K5, and K6 or, where the frame's sides are not multiples of 16,
K11), then Lab-CLAHE (on three more kernels where the sides are multiples
of 16), and writes ``<name>_enhanced.png``, ``_illumination.png`` and
``_comparison.png``.
``--no-packed_inference`` runs the standard forward instead. ``--device cpu``
runs the same route on the CPU with the kernels' plain versions. Weights come
from a reference ``.pth`` given as ``--checkpoint``, or else are initialised
untrained from ``--seed``. Every other mode and the options this route does
not run yet raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import math
import os
from pathlib import Path

import torch

from retinex_tpu_torch.config import CLASSICAL_MODES, Config, add_config_args, config_from_args
from retinex_tpu_torch.device import resolve_device
from retinex_tpu_torch.models.convert import load_reference_checkpoint
from retinex_tpu_torch.models.packed_inference import PackedRetinex
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex


def init_untrained(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Untrained weights from a seeded generator on the CPU, so every device
    gets the same numbers: PyTorch's default conv init (uniform in
    +-1/sqrt(fan_in) for weights and biases), BatchNorm at identity."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                bound = 1.0 / math.sqrt(m.weight.shape[1] * m.weight[0, 0].numel())
                m.weight.uniform_(-bound, bound, generator=g)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=g)
    return model


def build_model(config: Config, device: torch.device) -> MultiScaleUPRetinex:
    """The net in eval mode on `device`, with a reference checkpoint's weights
    when `config.checkpoint` names a ``.pth`` file, else untrained."""
    if config.use_amp:
        raise NotImplementedError("bf16 compute (use_amp) lands with training, ROADMAP Queue 1 item 12")
    model = MultiScaleUPRetinex(use_preact=config.use_preact, use_aspp=config.use_aspp)
    ckpt = config.checkpoint
    if ckpt and os.path.exists(ckpt):
        if not ckpt.endswith(".pth"):
            raise NotImplementedError(
                f"{ckpt}: the port reads reference .pth checkpoints; the JAX package's "
                "checkpoints land with training, ROADMAP Queue 1 item 12"
            )
        state_dict, epoch = load_reference_checkpoint(ckpt)
        model.load_state_dict(state_dict)
        print(f"Loaded reference checkpoint {ckpt} (epoch {epoch})")
    else:
        print(f"Using untrained model weights from seed {config.seed}")
        init_untrained(model, config.seed)
    return model.eval().to(device)


def build_apply_fn(config: Config, device: torch.device):
    """NHWC batch -> (enhanced, reflectance, illumination) through the
    packed forward (``config.packed_inference``) or the standard one."""
    if config.spatial_shard:
        raise NotImplementedError("spatial sharding lands in ROADMAP Queue 1 item 15")
    model = build_model(config, device)
    forward = model
    if config.packed_inference:
        forward = PackedRetinex(model)
        print("Using space-to-depth packed inference")

    def apply_fn(batch: torch.Tensor):
        with torch.inference_mode():
            return forward(batch)

    return apply_fn


def run(config: Config):
    device = resolve_device(config.device)
    if config.mode != "enhance":
        raise NotImplementedError(f"--mode {config.mode}: the port runs --mode enhance (ROADMAP Queue 1)")
    if config.classical_mode in CLASSICAL_MODES:
        raise NotImplementedError("the classical modes land in ROADMAP Queue 1 item 8")
    input_path = Path(config.input_path)
    if input_path.is_dir():
        raise NotImplementedError("directory enhance lands in ROADMAP Queue 1 item 7")
    if not input_path.is_file():
        raise FileNotFoundError(f"Input path does not exist: {config.input_path}")
    if device.type == "cuda":
        # f32 compute is f32: no TF32 in cuDNN convolutions or matmuls.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    from retinex_tpu_torch.infer.enhance import enhance_single_image

    apply_fn = build_apply_fn(config, device)
    os.makedirs(config.output_dir, exist_ok=True)
    return enhance_single_image(
        apply_fn,
        str(input_path),
        config.output_dir,
        max_size=config.max_size,
        enable_multi_scale=config.multi_scale,
        enable_content_aware=config.content_aware,
        device=device,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="retinex-tpu-torch: low-light image enhancement on PyTorch/CUDA")
    add_config_args(parser)
    config = config_from_args(parser.parse_args(argv))
    print(f"Mode: {config.mode} on {config.device}")
    return run(config)


if __name__ == "__main__":
    main()

"""Export a checkpoint as a serving artifact (``torch.export``).

    python -m retinex_tpu_torch.scripts.export_serving \
        --checkpoint ckpts/best --height 1088 --width 1920 \
        --out enhancer_1080p.pt2 [--use_preact] [--use_aspp] [--device cpu]

Counterpart of ``scripts/export_serving.py``. The artifact is the u8-in/u8-out
enhance step for one letterbox canvas with a symbolic batch dimension
(``infer/serving.py``), exported on the device it serves on: the card unless
``--device cpu``. ``--checkpoint`` takes a reference ``.pth`` or an Orbax
directory, one of the port's training checkpoints (``<save_dir>/best``) or
one of the JAX package's, as the CLI's does.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument(
        "--checkpoint", required=True,
        help="reference .pth, or an Orbax directory: the port's training checkpoint or the JAX package's",
    )
    ap.add_argument("--height", type=int, required=True)
    ap.add_argument("--width", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--use_preact", action="store_true")
    ap.add_argument("--use_aspp", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="the device the artifact serves on")
    ap.add_argument(
        "--pipeline", default="enhance", choices=("enhance", "predict"),
        help="enhance = net + adaptive CLAHE (matches --mode enhance); "
        "predict = raw model outputs (matches --mode predict)",
    )
    args = ap.parse_args(argv)

    from retinex_tpu_torch.cli import build_model
    from retinex_tpu_torch.config import Config
    from retinex_tpu_torch.device import resolve_device
    from retinex_tpu_torch.infer.serving import export_enhancer

    device = resolve_device(args.device)
    config = Config(checkpoint=args.checkpoint, use_preact=args.use_preact, use_aspp=args.use_aspp, device=args.device)
    model = build_model(config, device, require_checkpoint=True)
    blob = export_enhancer(
        model, height=args.height, width=args.width, path=args.out, device=device, pipeline=args.pipeline
    )
    print(f"wrote {args.out}: {len(blob) / 1e6:.2f} MB "
          f"(canvas {args.height}x{args.width}, {args.pipeline} pipeline, symbolic batch, {device.type})")
    return blob


if __name__ == "__main__":
    main()

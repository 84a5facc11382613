"""CLI of the port: ``--mode train``, ``enhance``, ``predict`` and
``evaluate``, and the simple-enhance entry point.

Counterpart of ``retinex_tpu/cli.py``::

    python -m retinex_tpu_torch.cli --mode train --train_dir images/ \\
        --save_dir checkpoints
    python -m retinex_tpu_torch.cli --mode predict --checkpoint checkpoints/best \\
        --input_path photos/ --output_dir out --max_size 1920
    python -m retinex_tpu_torch.cli --mode enhance --input_path photo.jpg \\
        --output_dir out --max_size 1920
    python -m retinex_tpu_torch.cli --mode enhance --input_path photos/ \\
        --output_dir out --max_size 1920 --batch_size 8
    python -m retinex_tpu_torch.cli --mode predict --checkpoint model.pth \\
        --input_path photos/ --output_dir out --max_size 1920
    python -m retinex_tpu_torch.cli --mode evaluate --input_path out/ \\
        --test_dir references/ --output_dir out
    retinex-tpu-torch-simple-enhance --input photo.jpg --output out

Every enhance route of the JAX package runs, and writes ``<name>_enhanced.png``,
``_illumination.png`` and ``_comparison.png`` per image:

- the net (MultiScaleUPRetinex) with adaptive Lab-CLAHE, the default. It
  runs through the space-to-depth packed forward (``models/packed_inference.py``,
  the FAM on the CUDA kernels K4, K5, and K6 or, where the frame's sides are
  not multiples of 16, K11), then Lab-CLAHE on K1-K3 where the sides are
  multiples of 2*tiles. ``--no-packed_inference`` runs the standard forward;
- ``--content_aware`` and ``--multi_scale``: the two other net enhancers;
- ``--classical_mode ssr|msr|msrcr`` (no net, plain PyTorch),
  ``--classical_mode clahe`` (Lab-CLAHE: K1-K3 on one image, K8 and K2 on a
  directory) and ``--classical_mode clahe_luma`` (K2 and K7), with
  ``--clahe_clip_limit``, ``--clahe_tiles`` and ``--clahe_hist_subsample``.

``--mode train`` trains the net with the seven losses, on one device or as
the ranks of a data-parallel run (``train/trainer.py``): the epoch lines, ``best`` and
``latest`` full-state checkpoints under ``--save_dir``, ``metrics.jsonl``,
``results.csv``, sample visualisations, early stopping, ``--resume`` and a
checkpoint on SIGTERM. ``--mode predict`` runs the net alone (no CLAHE) on a
file or a directory and writes the same three PNGs (``infer/predict.py``);
it needs ``--checkpoint``.
``--mode evaluate`` scores the images of ``--input_path`` (with PSNR, SSIM and
MSE against same-named images of ``--test_dir`` where that directory exists)
and writes ``<output_dir>/metrics.csv`` (``infer/evaluate.py``).
``simple_enhance_main`` mirrors the JAX package's ``retinex-simple-enhance``:
``--mode enhance`` with the pre-activation + ASPP net, untrained.

A directory is run in chunks of ``--batch_size`` images of one letterboxed
canvas (without ``--max_size`` each image is letterboxed to its longer
side), with ``--num_workers`` threads writing the PNGs. ``--device cpu`` runs
every route on the CPU with the kernels' plain versions. Weights come from
``--checkpoint``: a training checkpoint of the port or of the JAX package
(an Orbax directory) or a reference ``.pth``; or else (enhance only) are
initialised untrained as the JAX CLI does (Flax's lecun-normal kernels,
zero biases, always seed 0 like its ``PRNGKey(0)``; ``--seed`` does not
reach them).
``--use_amp`` computes the net in bf16 for ``--mode enhance`` and
``predict`` (``models/layers.py``, ``models/packed_inference.py``: the FAM
kernels' bf16 instances) and the net and VGG19 in bf16 for ``--mode train``
(the parameters and the optimizer's state stay f32; the checkpoints keep
their format); Lab-CLAHE and the enhancers stay f32, as the JAX package's
do. ``--remat`` recomputes the net's blocks in training's backward.
``--n_devices`` (default: every visible card) runs directories over a data
mesh: each chunk split along the batch, the whole pipeline on each card's
slice with its own copy of the weights (``infer/batch_driver.py``), the
same bytes as one card; one image runs on one card. ``--mode train`` on
several cards starts one process per card, each a rank of the JAX
package's global-batch step (NCCL; ``parallel/distributed.py``), and
``--coordinator host:port --num_processes P --process_id i`` joins the
ranks of P hosts. ``--spatial_shard`` splits one frame's height over the
mesh's devices (``parallel/spatial.py``): the net's standard forward where
H % (8 n) == 0 (else it says so and runs on one device), and on one file
``--classical_mode clahe|clahe_luma`` where the mesh divides the tiles and
H, W are multiples of 2 * tiles (else likewise); on one device the flag
is ignored, with a message, and a directory with the net turns batch
sharding off. ``--checkpoint`` and ``--resume`` also take a directory
written by the JAX package (Orbax, ``<save_dir>/best``; read without orbax
by ``train/orbax.py``). ``--mode train`` takes the
packed train step (``--packed_train``, on by default;
``models/packed_train.py``) on the card where ``--image_size`` is a
multiple of 32, and the standard step with ``--no-packed_train``, on the
CPU, or at other sizes, as the JAX trainer does (and says why).
"""

from __future__ import annotations

import argparse
import copy
import os
from pathlib import Path

import torch

from retinex_tpu_torch.config import CLASSICAL_MODES, Config, add_config_args, config_from_args
from retinex_tpu_torch.device import resolve_device
from retinex_tpu_torch.models.convert import load_reference_checkpoint
from retinex_tpu_torch.models.init import TRUNC_STD, fan_in, init_untrained  # noqa: F401
from retinex_tpu_torch.models.packed_inference import PackedRetinex
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
from retinex_tpu_torch.parallel.mesh import create_mesh, replicate
from retinex_tpu_torch.train.checkpoint import load_params_for_inference, state_dict_for


# The JAX CLI initialises the untrained net from PRNGKey(0).
UNTRAINED_SEED = 0


def build_model(config: Config, device: torch.device, require_checkpoint: bool = False) -> MultiScaleUPRetinex:
    """The net in eval mode on `device`, computing in
    `config.compute_dtype` (bf16 with ``--use_amp``), with the weights of
    `config.checkpoint` where it exists (a directory: the JAX package's Orbax
    checkpoint, ``train/orbax.py``; a file: a reference ``.pth`` or one of
    the port's training checkpoints), else untrained (or, with
    `require_checkpoint`, FileNotFoundError)."""
    model = MultiScaleUPRetinex(use_preact=config.use_preact, use_aspp=config.use_aspp, dtype=config.compute_dtype)
    ckpt = config.checkpoint
    if ckpt and os.path.isdir(ckpt):
        model.load_state_dict(state_dict_for(model, load_params_for_inference(ckpt)))
        print(f"Loaded checkpoint {ckpt} (Orbax)")
    elif ckpt and os.path.exists(ckpt):
        state_dict, epoch = load_reference_checkpoint(ckpt)
        model.load_state_dict(state_dict)
        print(f"Loaded checkpoint {ckpt} (epoch {epoch})")
    elif require_checkpoint:
        raise FileNotFoundError(f"Checkpoint not found: {ckpt}. Train a model first or pass --checkpoint.")
    else:
        print(f"Using untrained model weights (lecun-normal from seed {UNTRAINED_SEED}, as the JAX CLI's PRNGKey(0))")
        init_untrained(model, UNTRAINED_SEED)
    return model.eval().to(device)


def build_apply_fn(config: Config, device: torch.device, require_checkpoint: bool = False, mesh=None):
    """NHWC batch -> (enhanced, reflectance, illumination) through the
    packed forward (``config.packed_inference``) or the standard one. With
    `mesh` (``parallel/mesh.py``) one copy of the weights lives on each of
    its devices and the forward runs the copy on its input's device.

    With ``config.spatial_shard`` on a mesh of n > 1 devices
    (``--n_devices``) the forward is the standard one with each frame's
    height split over them (``parallel/spatial.make_spatial_forward``), the
    outputs gathered on the input's device, where H % (8 n) == 0; other
    heights run the standard forward on one device, which is said. On one
    device the flag is ignored (said too)."""
    model = build_model(config, device, require_checkpoint)
    home = next(model.parameters()).device
    if config.use_amp:
        print("Computing the net in bf16 (--use_amp)")
    if config.spatial_shard:
        sp_mesh = create_mesh(config.n_devices, device)
        n = sp_mesh.size
        if n > 1:
            from retinex_tpu_torch.parallel.spatial import gather_rows, make_spatial_forward, shard_rows

            print(f"Spatial sharding: H split over {n} devices (row halos copied between slabs)")
            spatial = make_spatial_forward(model, sp_mesh)

            def spatial_fn(batch: torch.Tensor):
                if batch.shape[1] % (8 * n) == 0:
                    return tuple(gather_rows(o, batch.device) for o in spatial(shard_rows(batch, sp_mesh)))
                print(f"  H={batch.shape[1]} not divisible by {8 * n}; single-device fallback")
                with torch.inference_mode():
                    return model(batch)

            return spatial_fn
        print("Spatial sharding requested but only one device is visible; ignoring")
    if config.packed_inference:
        print("Using space-to-depth packed inference")

    def make(dev: torch.device):
        net = model if dev == home else copy.deepcopy(model).to(dev)
        forward = PackedRetinex(net) if config.packed_inference else net

        def apply_fn(batch: torch.Tensor):
            with torch.inference_mode():
                return forward(batch)

        return apply_fn

    return make(home) if mesh is None else replicate(make, mesh)


def run(config: Config):
    device = resolve_device(config.device)
    if config.mode not in ("train", "enhance", "predict", "evaluate"):
        raise ValueError(f"Unknown mode: {config.mode}")
    if config.mode == "train":
        from retinex_tpu_torch.train.trainer import train

        os.makedirs(config.save_dir, exist_ok=True)
        for flag, label in [
            (config.use_freq_loss, "frequency loss"),
            (config.adaptive_weights, "adaptive (DWA) loss weights"),
            (config.use_preact, "pre-activation residual blocks"),
            (config.use_aspp, "ASPP module"),
            (config.advanced_augment, "advanced augmentation"),
        ]:
            if flag:
                print(f"  + {label}")
        return train(config)
    from retinex_tpu_torch.infer.batch_driver import maybe_mesh

    # The data mesh of directory runs (--n_devices; every visible card by
    # default, as the JAX package's): None on one device.
    mesh = maybe_mesh(config.n_devices, device)
    if device.type == "cuda":
        # f32 compute is f32: no TF32 in cuDNN convolutions or matmuls; a
        # bf16 matmul sums in f32 and rounds once, as XLA's does.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    if config.mode == "evaluate":
        from retinex_tpu_torch.infer.evaluate import evaluate_directory

        ref_dir = config.test_dir if os.path.isdir(config.test_dir) else None
        os.makedirs(config.output_dir, exist_ok=True)
        return evaluate_directory(
            config.input_path,
            reference_dir=ref_dir,
            output_csv=os.path.join(config.output_dir, "metrics.csv"),
            batch_size=config.batch_size,
            device=device,
            mesh=mesh,
        )

    input_path = Path(config.input_path)
    if not input_path.is_dir():
        mesh = None  # one image runs on one device, as in the JAX package
    elif config.spatial_shard and (config.mode == "predict" or config.classical_mode not in CLASSICAL_MODES):
        # The net's forward splits each chunk's height over the devices itself.
        mesh = None
        print("Directory input: spatial sharding handles each chunk; batch-sharding off")
    if config.mode == "predict":
        from retinex_tpu_torch.infer.predict import predict_batch, predict_single_image

        apply_fn = build_apply_fn(config, device, require_checkpoint=True, mesh=mesh)
        os.makedirs(config.output_dir, exist_ok=True)
        knobs = dict(max_size=config.max_size, save_comparison=not config.no_comparison, device=device)
        if input_path.is_file():
            return predict_single_image(apply_fn, str(input_path), config.output_dir, **knobs)
        if input_path.is_dir():
            return predict_batch(
                apply_fn, str(input_path), config.output_dir, batch_size=config.batch_size,
                num_workers=config.num_workers, mesh=mesh, **knobs,
            )
        raise FileNotFoundError(f"Input path does not exist: {config.input_path}")

    if not (input_path.is_file() or input_path.is_dir()):
        raise FileNotFoundError(f"Input path does not exist: {config.input_path}")
    from retinex_tpu_torch.infer.enhance import enhance_batch_images, enhance_single_image

    apply_fn = None if config.classical_mode in CLASSICAL_MODES else build_apply_fn(config, device, mesh=mesh)
    os.makedirs(config.output_dir, exist_ok=True)
    knobs = dict(
        classical_mode=config.classical_mode,
        clip_limit=config.clahe_clip_limit,
        tiles=config.clahe_tiles,
        hist_subsample=config.clahe_hist_subsample,
        enable_multi_scale=config.multi_scale,
        enable_content_aware=config.content_aware,
        device=device,
    )
    if input_path.is_file():
        # --spatial_shard with a CLAHE mode splits the frame's height over the
        # mesh (parallel/spatial.make_spatial_clahe); None on one device.
        sp_mesh = None
        if config.spatial_shard and config.classical_mode in ("clahe", "clahe_luma"):
            from retinex_tpu_torch.infer.batch_driver import maybe_mesh

            sp_mesh = maybe_mesh(config.n_devices, device)
        return enhance_single_image(
            apply_fn, str(input_path), config.output_dir, max_size=config.max_size, mesh=sp_mesh, **knobs
        )
    return enhance_batch_images(
        apply_fn,
        str(input_path),
        config.output_dir,
        max_size=config.max_size,
        batch_size=config.batch_size,
        num_workers=config.num_workers,
        mesh=mesh,
        **knobs,
    )


def main(argv=None):
    parser = argparse.ArgumentParser(description="retinex-tpu-torch: low-light image enhancement on PyTorch/CUDA")
    add_config_args(parser)
    config = config_from_args(parser.parse_args(argv))
    print(f"Mode: {config.mode} on {config.device}")
    return run(config)


def simple_enhance_main(argv=None):
    """The JAX package's ``retinex-simple-enhance``: --mode enhance with the
    pre-activation + ASPP net, untrained weights. ``--device`` takes the
    port's ``cuda`` or ``cpu``."""
    parser = argparse.ArgumentParser(description="Simple enhance (no training required)")
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--output", type=str, default="./results")
    parser.add_argument("--max_size", type=int, default=None)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--multi_scale", action="store_true")
    parser.add_argument("--content_aware", action="store_true")
    parser.add_argument("--classical", type=str, default=None, choices=list(CLASSICAL_MODES))
    args = parser.parse_args(argv)
    config = Config(
        mode="enhance",
        input_path=args.input,
        output_dir=args.output,
        max_size=args.max_size,
        multi_scale=args.multi_scale,
        content_aware=args.content_aware,
        classical_mode=args.classical,
        checkpoint="",  # untrained net
        use_preact=True,
        use_aspp=True,
        device=args.device,
    )
    print(f"Simple enhance on {config.device}")
    return run(config)


if __name__ == "__main__":
    main()

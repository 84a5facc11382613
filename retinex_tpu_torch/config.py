"""One shared configuration dataclass for every entry point of the port.

Counterpart of ``retinex_tpu/config.py``: the same fields with the same
defaults, so the CLI flags read the same. ``compute_dtype`` names a torch
dtype. One field is the port's own: ``device``, the device the entry points
run on (``cuda`` unless the caller asks for ``cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

# Net-free enhance pipelines the JAX package accepts as `classical_mode`.
CLASSICAL_MODES = ("ssr", "msr", "msrcr", "clahe", "clahe_luma")


@dataclasses.dataclass
class Config:
    # Mode
    mode: str = "predict"  # train | predict | enhance | evaluate

    # Paths
    train_dir: str = "./data/train"
    test_dir: str = "./data/test"
    input_path: str = "./data/test"
    output_dir: str = "./results"
    checkpoint: str = "./checkpoints/best"
    save_dir: str = "./checkpoints"

    # Training hyperparameters
    num_epochs: int = 100
    batch_size: int = 8
    image_size: int = 640
    lr: float = 1e-4
    weight_decay: float = 1e-5
    resume: str | None = None
    num_workers: int = 4
    lr_decay_step: int = 30
    lr_decay_gamma: float = 0.5
    save_freq: int = 10
    seed: int = 0

    # Loss weights
    weight_exp: float = 10.0
    weight_smooth: float = 1.0
    weight_col: float = 0.5
    weight_spa: float = 1.0
    weight_decouple: float = 0.1
    weight_perceptual: float = 1.0
    weight_freq: float = 0.5

    # Inference
    max_size: int | None = None
    no_comparison: bool = False

    # Enhance toggles
    multi_scale: bool = False
    content_aware: bool = False

    # Advanced toggles
    use_amp: bool = False  # bf16 compute
    patience: int = 20
    use_cosine_scheduler: bool = False
    use_freq_loss: bool = False
    adaptive_weights: bool = False
    use_preact: bool = False
    use_aspp: bool = False
    advanced_augment: bool = False

    # Extensions of the JAX package
    use_perceptual_loss: bool = True
    vgg_weights: str | None = None
    n_devices: int | None = None
    coordinator: str | None = None
    num_processes: int | None = None
    process_id: int | None = None
    profile_dir: str | None = None
    classical_mode: str | None = None
    use_pallas_clahe: bool = True  # the CLAHE kernels; the port always takes them on cell-divisible shapes
    clahe_clip_limit: float = 2.0
    clahe_tiles: int = 8
    clahe_hist_subsample: int = 1
    packed_inference: bool = True
    packed_train: bool = True
    grad_accum: int = 1
    remat: bool = False
    spatial_shard: bool = False
    log_every: int = 100
    progress_bar: bool = True

    # The port's own: the device every entry point runs on.
    device: str = "cuda"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.use_amp else torch.float32


def add_config_args(parser: argparse.ArgumentParser, config: Config | None = None) -> argparse.ArgumentParser:
    """Register every Config field as a --flag on an argparse parser."""
    defaults = config or Config()
    for f in dataclasses.fields(Config):
        name = f"--{f.name}"
        default = getattr(defaults, f.name)
        if f.name == "device":
            parser.add_argument(name, choices=("cuda", "cpu"), default=default, help=f"(default: {default})")
        elif isinstance(default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction, default=default, help=f"(default: {default})")
        else:
            tstr = str(f.type)
            if default is not None:
                typ = type(default)
            elif "int" in tstr:
                typ = int
            elif "float" in tstr:
                typ = float
            else:
                typ = str
            parser.add_argument(name, type=typ, default=default, help=f"(default: {default})")
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    """Build a Config from a parsed argparse namespace (unknown attrs ignored)."""
    return Config(**{f.name: getattr(args, f.name) for f in dataclasses.fields(Config) if hasattr(args, f.name)})

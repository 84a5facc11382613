"""The training loop of the port (``--mode train``), on one device or as
the ranks of a data-parallel run.

Counterpart of ``retinex_tpu/train/trainer.py`` (in f32 or, with
``--use_amp``, with the net and VGG19 computing in bf16 and the parameters
and the optimizer's state in f32, as the JAX trainer's ``compute_dtype``;
``--remat`` checkpoints the net's blocks, as the JAX net's ``remat=``). The
step is the packed one (``--packed_train``, on by default) on the card
where ``--image_size`` is a multiple of 32, else the standard one, by the
JAX trainer's gate (``use_packed_train``):

- each batch goes to the device as uint8, is augmented there
  (``data/augment.py``, a generator seeded with ``seed + 1``) and takes one
  train step (``train/train_state.py``);
- the loss scalars stay on the device: they are fetched every
  ``log_every`` batches, and the epoch means are summed there and read once
  an epoch;
- ``drop_last`` whenever a full batch remains, early stopping on the
  epoch-mean total loss with ``patience``, ``best`` and ``latest``
  checkpoints (``train/checkpoint.py``), sample visualisations every
  ``save_freq`` epochs, ``metrics.jsonl`` and ``results.csv`` (and, where
  their packages import, TensorBoard events, loss-curve PNGs and a tqdm
  bar), ``--profile_dir`` as a ``torch.profiler`` trace;
- SIGTERM or SIGINT sets a flag: the current step finishes, ``latest`` is
  written as epoch - 1 (so the cut epoch re-runs on ``--resume``) and the
  run returns; a second signal raises KeyboardInterrupt.

A checkpoint's side file (``train/checkpoint.SIDE_FILE``) also holds the loader's shuffle state and the augmentation
generator's state as they were at the start of the next epoch to run, so
``--resume`` continues the batch order and the draws where the run left
them, and two epochs equal one epoch and a resume bit for bit. (The JAX
package restarts both on a resume, so its resumed epochs repeat the first
epochs' order and draws; a fresh run's batch order is the same in both.)

On several devices or hosts (``--n_devices``, ``--coordinator``) ``train``
starts one process per local device (``parallel/distributed.py``); each is
a rank of the JAX package's global-batch step. The loader shards the data
by process and each rank takes its rows of the process's batch; every rank
draws the global batch's augmentation; the preemption flag is any-reduced
every batch; the first rank alone prints, logs and writes the checkpoints,
curves and samples, with a barrier after each save; ``--resume`` loads the
same file on every rank, and a checksum at start-up asserts that every rank
holds the same parameters.
"""

from __future__ import annotations

import os
import time
from datetime import datetime

import numpy as np
import torch

from retinex_tpu_torch.config import Config
from retinex_tpu_torch.data.augment import augment_batch
from retinex_tpu_torch.data.dataset import get_train_loader
from retinex_tpu_torch.device import resolve_device
from retinex_tpu_torch.losses.total import LossConfig, TotalLoss
from retinex_tpu_torch.models.init import init_untrained
from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex, count_parameters
from retinex_tpu_torch.models.vgg import default_vgg, load_npz
from retinex_tpu_torch.parallel.distributed import (
    any_over_ranks,
    barrier,
    check_replicas_equal,
    data_shard,
    launch,
    local_shard,
    process_shard,
    rank_device,
    world_plan,
)
from retinex_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from retinex_tpu_torch.train.schedules import cosine_warm_restarts, step_decay
from retinex_tpu_torch.train.train_state import create_train_state, eval_step, train_step
from retinex_tpu_torch.utils.logging import MetricLogger, save_loss_curves, save_results_to_csv
from retinex_tpu_torch.utils.viz import visualize_results

LOG_KEYS = ("total", "exposure", "smoothness", "color", "spatial", "decouple", "perceptual", "frequency")


def use_packed_train(config: Config, device: torch.device) -> bool:
    """The JAX trainer's gate: the packed step (``models/packed_train.py``)
    where ``--packed_train`` is on, ``image_size`` is a multiple of 32 and
    the device is the card; otherwise the standard step, saying why with
    the JAX package's reasons. (Packing pays for wider convolutions on an
    accelerator; on the CPU its einsums and layout copies are overhead.)"""
    on_cpu = device.type == "cpu"
    use = config.packed_train and config.image_size % 32 == 0 and not on_cpu
    if use:
        print("packed_train: the s2d-packed train step")
    elif config.packed_train:
        reason = "CPU backend" if on_cpu else "image_size not divisible by 32"
        print(f"packed_train: {reason}, using the standard step")
    return use


def build_vgg(config: Config, device: torch.device):
    """The perceptual loss's VGG19 (frozen, eval mode) on `device`: a user's
    exported torchvision weights (``--vgg_weights``) or the default draw."""
    if not config.use_perceptual_loss:
        return None
    dtype = config.compute_dtype
    vgg = load_npz(config.vgg_weights, dtype) if config.vgg_weights else default_vgg(dtype)
    return vgg.to(device).eval()


def build_criterion(config: Config, device: torch.device) -> TotalLoss:
    loss_cfg = LossConfig(
        weight_exp=config.weight_exp,
        weight_smooth=config.weight_smooth,
        weight_col=config.weight_col,
        weight_spa=config.weight_spa,
        weight_decouple=config.weight_decouple,
        weight_perceptual=config.weight_perceptual,
        weight_freq=config.weight_freq,
        use_freq_loss=config.use_freq_loss,
        use_perceptual_loss=config.use_perceptual_loss,
        adaptive_weights=config.adaptive_weights,
    )
    return TotalLoss(loss_cfg, vgg=build_vgg(config, device))


def build_schedule(config: Config):
    if config.use_cosine_scheduler:
        return cosine_warm_restarts(config.lr)
    return step_decay(config.lr, config.lr_decay_step, config.lr_decay_gamma)


def train(config: Config) -> dict:
    """Run training; returns {'best_loss', 'epochs_run', 'save_dir'}.
    On one device it runs here. On several (``--n_devices``, by default
    every visible card) or several hosts (``--coordinator``) it starts one
    process per local device (``parallel/distributed.launch``), each a rank
    of the global-batch step, and returns the first local rank's result."""
    index, procs, local = world_plan(config)
    if procs * local == 1:
        return _train_rank(config)
    if procs > 1:
        print(f"Multi-host: process {index}/{procs} via {config.coordinator}")
    print(f"Data parallel: {procs * local} rank(s), {local} on this host, one per device "
          f"({'NCCL' if resolve_device(config.device).type == 'cuda' else 'gloo'})")
    return launch(_train_rank, (config,), config, local)


def _train_rank(config: Config) -> dict:
    """One rank's training. Signal handlers are installed before set-up (so
    a signal during it is caught too) and restored on every exit path;
    outside the main thread none are installed."""
    import signal

    preempted = {"flag": False, "signum": None}
    old_handlers = {}

    def _restore_handlers():
        for sig, handler in old_handlers.items():
            signal.signal(sig, handler)
        old_handlers.clear()

    def _on_preempt(signum, frame):
        if preempted["flag"]:
            _restore_handlers()
            raise KeyboardInterrupt
        preempted["flag"] = True
        preempted["signum"] = signum

    try:
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _on_preempt)
    except ValueError:
        old_handlers = {}
    try:
        return _train_impl(config, preempted)
    finally:
        _restore_handlers()


def _progress(iterable, total: int, desc: str, enabled: bool):
    """A tqdm bar where tqdm imports and `enabled`, else the iterable."""
    if enabled:
        try:
            from tqdm import tqdm

            return tqdm(iterable, total=total, desc=desc, leave=False)
        except ImportError:
            pass
    return iterable


def _train_impl(config: Config, preempted: dict) -> dict:
    resolve_device(config.device)
    device = rank_device(config)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False  # as the CLI's inference
    rank, world = data_shard()
    (proc_idx, proc_count), local = process_shard(), local_shard()
    lead = rank == 0  # prints, logs and writes the checkpoints, curves and samples
    print(f"Training on {device}" + (f" (rank {rank} of {world})" if world > 1 else ""))

    model = init_untrained(
        MultiScaleUPRetinex(use_preact=config.use_preact, use_aspp=config.use_aspp, dtype=config.compute_dtype,
                            remat=config.remat),
        config.seed,
    )
    if config.use_amp:
        print("Computing the net and VGG19 in bf16 (--use_amp); parameters and optimizer state in f32")
    if config.remat:
        print("Rematerialising the net's blocks and scale towers in the backward (--remat)")
    criterion = build_criterion(config, device)
    epoch_schedule = build_schedule(config)

    # Several hosts: this process loads its share of every global batch
    # (the JAX rule), and each local rank its rows of that share.
    local_batch = max(config.batch_size // proc_count, 1)

    def make_loader(drop_last: bool):
        return get_train_loader(
            image_dir=config.train_dir,
            batch_size=local_batch,
            image_size=config.image_size,
            num_workers=config.num_workers,
            shuffle=True,
            drop_last=drop_last,
            seed=config.seed,
            shard=(proc_idx, proc_count),
            rows=local,
        )

    # drop_last whenever a full batch remains: a ragged batch would weigh its
    # images otherwise than the rest; shuffling drops another remainder each
    # epoch. A dataset smaller than one batch trains on what it has.
    loader = make_loader(drop_last=True)
    if len(loader) == 0:
        loader = make_loader(drop_last=False)
    steps_per_epoch = max(len(loader), 1)
    dropped = len(loader.dataset) - steps_per_epoch * local_batch * proc_count
    print(
        f"{len(loader.dataset)} images, {steps_per_epoch} batches/epoch"
        + (f" ({dropped} re-shuffled into later epochs)" if dropped > 0 else "")
    )

    # Schedules step once an epoch; an applied update s is micro-batch
    # s * accum, so its epoch is (s * accum) // steps_per_epoch.
    accum = max(config.grad_accum, 1)
    state = create_train_state(
        model.to(device),
        lambda step: epoch_schedule((step * accum) // steps_per_epoch),
        seed=config.seed,
        weight_decay=config.weight_decay,
        grad_accum=accum,
    )
    if accum > 1:
        print(
            f"Gradient accumulation x{accum}: effective batch {config.batch_size * accum} "
            f"(optimizer applies every {accum} batches)"
        )
    print(f"Model parameters: {count_parameters(state.model):,}")
    aug_gen = torch.Generator(device=device).manual_seed(config.seed + 1)

    start_epoch, best_loss = 0, float("inf")
    if config.resume:
        state, start_epoch, best_loss, extra = load_checkpoint(state, config.resume)
        if "loader_rng" in extra:
            loader.rng.bit_generator.state = extra["loader_rng"]
            aug_gen.set_state(extra["aug_rng"])
        print(f"Resumed from {config.resume} at epoch {start_epoch}")
    # Every rank starts from the same parameters and statistics (the same
    # seed, or the same file): the summed gradients keep them so.
    check_replicas_equal(list(state.model.state_dict().values()), "initial parameters and statistics")
    packed = use_packed_train(config, device)

    if lead:
        log_dir = os.path.join(config.save_dir, "logs", datetime.now().strftime("%Y%m%d_%H%M%S"))
        logger = MetricLogger(log_dir)
        print(f"Logs: {log_dir}")
    else:
        logger = _NullLogger()
    loss_history: dict[str, list[float]] = {k: [] for k in LOG_KEYS}
    patience_counter = 0
    epochs_run = 0

    prof = None
    if config.profile_dir and lead:
        os.makedirs(config.profile_dir, exist_ok=True)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()

    def rng_states() -> dict:
        return {"loader_rng": loader.rng.bit_generator.state, "aug_rng": aug_gen.get_state()}

    for epoch in range(start_epoch, config.num_epochs):
        epoch_start = time.time()
        at_start = rng_states()
        epoch_sum = None  # the stacked losses, one add a batch, on the device
        num_batches = 0
        epoch_iter = iter(loader)
        bar = _progress(epoch_iter, steps_per_epoch, f"Epoch {epoch}/{config.num_epochs - 1}", config.progress_bar and lead)
        for batch_idx, host_batch in enumerate(bar):
            batch = torch.from_numpy(host_batch).to(device, non_blocking=True)  # uint8 over the bus
            batch = augment_batch(batch, aug_gen, basic=True, advanced=config.advanced_augment)
            loss_dict = train_step(state, criterion, batch, packed)
            num_batches += 1
            # A signal may reach some ranks only: all take the break at the
            # same step (one rank leaving would hang the others' next sum).
            if any_over_ranks(preempted["flag"], device):
                preempted["flag"] = True
                epoch_iter.close()
                print(
                    f"Signal {preempted['signum']} received: checkpointing and exiting "
                    f"(resume with --resume {config.save_dir}/latest)"
                )
                break
            if batch_idx % config.log_every == 0:
                fetched = {k: float(v) for k, v in loss_dict.items()}
                logger.add_scalars("Loss", fetched, epoch * steps_per_epoch + batch_idx)
                if hasattr(bar, "set_postfix"):
                    bar.set_postfix({"total": f"{fetched['total']:.4f}"})
            stacked = torch.stack([loss_dict[k] for k in LOG_KEYS])
            epoch_sum = stacked if epoch_sum is None else epoch_sum + stacked

        if preempted["flag"]:
            # Saved as epoch - 1 with the epoch's starting generator states:
            # --resume runs the cut epoch again, whole.
            if lead:
                save_checkpoint(state, config.save_dir, epoch - 1, best_loss, is_best=False, extra=at_start)
                print(f"Preemption checkpoint written: {config.save_dir}/latest")
            barrier()
            epochs_run = epoch
            break

        sums = epoch_sum.cpu().numpy() if epoch_sum is not None else np.full(len(LOG_KEYS), np.inf)
        avg_losses = {k: float(sums[i]) / max(num_batches, 1) for i, k in enumerate(LOG_KEYS)}
        for k, v in avg_losses.items():
            loss_history[k].append(v)
        current_lr = epoch_schedule(epoch)
        logger.add_scalar("Learning_Rate", current_lr, epoch)
        logger.add_scalars("Epoch_Loss", avg_losses, epoch)
        print(
            f"Epoch {epoch}: time {time.time() - epoch_start:.2f}s lr {current_lr:.6f} "
            + " ".join(f"{k}={v:.4f}" for k, v in avg_losses.items())
        )
        if epoch % max(config.save_freq, 1) == 0:
            if lead:
                save_sample_visualizations(state.model, loader, epoch, config.save_dir, device)
            else:
                loader.epoch_order()  # the shuffle the samples take, so every rank's order stays in step

        if avg_losses["total"] < best_loss:
            best_loss = avg_losses["total"]
            patience_counter = 0
            is_best = True
            print(f"  new best loss: {best_loss:.6f}")
        else:
            patience_counter += 1
            is_best = False
            print(f"  patience: {patience_counter}/{config.patience}")
        if lead:
            save_checkpoint(state, config.save_dir, epoch, best_loss, is_best, extra=rng_states())
        barrier()
        epochs_run = epoch + 1
        if patience_counter >= config.patience:
            print(f"Early stopping after {epoch + 1} epochs (best {best_loss:.6f})")
            break

    if prof is not None:
        prof.stop()
        prof.export_chrome_trace(os.path.join(config.profile_dir, "trace.json"))
        print(f"Profile: {config.profile_dir}/trace.json")
    logger.close()
    if lead:
        save_loss_curves(loss_history, config.save_dir)
        save_results_to_csv(loss_history, config.save_dir)
    print(f"Training completed. Best loss: {best_loss:.6f}. Models in {config.save_dir}")
    return {"best_loss": best_loss, "epochs_run": epochs_run, "save_dir": config.save_dir}


class _NullLogger:
    """The logger of the ranks that write no logs."""

    def add_scalar(self, *args, **kwargs):
        pass

    def add_scalars(self, *args, **kwargs):
        pass

    def close(self):
        pass


def save_sample_visualizations(model, loader, epoch: int, save_dir: str, device: torch.device) -> None:
    """Three-panel PNGs of the first two images of the first two batches of
    a fresh epoch iterator (which, as in the JAX package, takes one shuffle
    from the loader's generator)."""
    vis_dir = os.path.join(save_dir, "visualizations")
    os.makedirs(vis_dir, exist_ok=True)
    with iter(loader) as it:
        for batch_idx, host_batch in enumerate(it):
            if batch_idx >= 2:
                break
            batch = torch.from_numpy(host_batch[:2].astype(np.float32) / 255.0).to(device)
            enhanced, _refl, illu = eval_step(model, batch)
            for i in range(batch.shape[0]):
                visualize_results(
                    batch[i], enhanced[i], illu[i],
                    save_path=os.path.join(vis_dir, f"epoch_{epoch}_batch_{batch_idx}_sample_{i}.png"),
                )

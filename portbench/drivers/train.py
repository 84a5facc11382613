"""Traffic driver ``train``: the training step at the JAX package's
defaults, driven as ``train/trainer._train_impl`` drives it.

Set-up writes ``n_photos`` seeded PNGs of ``image_size`` and draws the
net's and VGG19's weights on the card (VGG19's written as the ``.npz`` of
``--vgg_weights``). It builds one train state as the trainer builds it
(the net in its compute dtype, the criterion with VGG19, the step-decay
schedule over the loader's steps per epoch, the dropout and augmentation
generators from the seed, the packed step where ``use_packed_train`` takes
it) and drives it from the seed through its first ``REFERENCE_STEPS``
steps by the window's own loop: the loader's next batch, to the card as
u8, augmented on the card, ``train_state.train_step``, the epoch's losses
summed on the card and read at each epoch's end. The window runs the same
loop on the same state until ``seconds`` have passed; no checkpoint is
written. The reference follows the first steps from the same weights and
photos, in the loader's order and with the same augmentation draws.

One step of the window, drawn from the seed among its first
``window_check_steps``, is kept: the state it starts from (parameters,
BatchNorm statistics, Adam's moments and count) and what it gives (its
loss, its forward's illumination map, Adam's first moment, the parameters
and statistics after it), copied on the card while the window runs and
read after it. The reference takes that one step again from the kept
state, on the batch it works out itself (the photos of that step in the
loader's order, the augmentation draws replayed to that step).
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from portbench.common import photos, weights
from portbench.common.cellbase import Check, Window, f32_backend
from portbench.reference import decode, net as rnet, precision, train as rtrain

REFERENCE_STEPS = 3
TRAINABLE = ("conv", "convT", "bias", "bn_w", "bn_b")
# Leaves whose gradient is nought to rounding in the reference (a bias
# under BatchNorm) move under Adam by round-off alone: their change is not
# compared. The rule is on the reference's first gradient.
STILL_LEAF = 1e-3


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params

    def setup(self) -> None:
        ctx, p = self.ctx, self.p
        size = p["image_size"]
        self.files = photos.write(ctx.sub("photos"), ctx.seed, p["n_photos"], size, size, "png")
        ctx.stage("photos")
        net = ctx.net
        spec = rnet.spec(net["use_preact"], net["use_aspp"])
        self.spec = spec
        self.sd = weights.draw(spec, ctx.seed, ctx.device)
        self.vgg_sd = weights.draw(weights.vgg_spec(), ctx.seed + 1, ctx.device)
        npz = weights.write_vgg_npz(self.vgg_sd, os.path.join(ctx.workdir, "vgg19.npz"))

        ctx.stage("weights")
        from retinex_tpu_torch.config import Config
        from retinex_tpu_torch.data.augment import augment_batch
        from retinex_tpu_torch.data.dataset import get_train_loader
        from retinex_tpu_torch.models.retinex_net import MultiScaleUPRetinex
        from retinex_tpu_torch.train import trainer
        from retinex_tpu_torch.train.train_state import create_train_state, train_step

        cfg = Config(
            mode="train", train_dir=os.path.dirname(self.files[0]), image_size=size, batch_size=p["batch_size"],
            num_workers=p["num_workers"], seed=ctx.seed, vgg_weights=npz, use_preact=net["use_preact"],
            use_aspp=net["use_aspp"], packed_train=True, device=ctx.device.type,
        )
        self.cfg = cfg
        if ctx.device.type == "cuda":
            f32_backend()
        model = MultiScaleUPRetinex(use_preact=cfg.use_preact, use_aspp=cfg.use_aspp, dtype=cfg.compute_dtype,
                                    remat=cfg.remat)
        model.load_state_dict(self.sd)
        self.criterion = trainer.build_criterion(cfg, ctx.device)
        schedule = trainer.build_schedule(cfg)
        self.loader = get_train_loader(
            image_dir=cfg.train_dir, batch_size=cfg.batch_size, image_size=size, num_workers=cfg.num_workers,
            shuffle=True, drop_last=True, seed=cfg.seed,
        )
        steps_per_epoch = max(len(self.loader), 1)
        self.state = create_train_state(
            model.to(ctx.device), lambda step: schedule(step // steps_per_epoch), seed=cfg.seed,
            weight_decay=cfg.weight_decay,
        )
        self.aug_gen = torch.Generator(device=ctx.device).manual_seed(cfg.seed + 1)
        self.packed = trainer.use_packed_train(cfg, ctx.device)
        self.augment_batch, self.train_step = augment_batch, train_step
        self._batches = self._epochs()

        ctx.stage("program")
        opt = self.state.optimizer
        self.p0 = {k: v.detach().clone() for k, v in opt.params.items()}
        self.s0 = self._stats()
        with self._first_forward():
            self.losses = [self._step()["total"]]
        self.illu1 = self.illu
        self.g1 = {k: (m / (1.0 - opt.b1)).clone() for k, m in opt.mu.items()}
        for _ in range(REFERENCE_STEPS - 1):
            self.losses.append(self._step()["total"])
        self.p3 = {k: v.detach().clone() for k, v in opt.params.items()}
        self.s3 = self._stats()
        self.losses = [float(v) for v in self.losses]
        self.b1 = opt.b1
        rng = np.random.default_rng([ctx.seed, 3])
        self.kept_step = int(rng.integers(1, int(p.get("window_check_steps", 16)) + 1))
        self.kept = None
        ctx.stage("first steps")

    @contextlib.contextmanager
    def _first_forward(self):
        """Keep the illumination map of the step's own forward (the packed
        forward, ``train_state.packed_train_apply``, or the model's
        standard one) in ``self.illu`` while it runs."""
        from retinex_tpu_torch.train import train_state

        packed_apply = train_state.packed_train_apply

        def keep(out):
            self.illu = out[2].detach().clone()
            return out

        hook = self.state.model.register_forward_hook(lambda _m, _a, out: keep(out))
        train_state.packed_train_apply = lambda model, batch: keep(packed_apply(model, batch))
        try:
            yield
        finally:
            train_state.packed_train_apply = packed_apply
            hook.remove()

    def _stats(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.state.model.state_dict().items()
                if k.endswith(("running_mean", "running_var"))}

    def _epochs(self):
        """The loader's batches, epoch after epoch, each epoch's losses summed
        on the card and read at its end, as the trainer reads them."""
        while True:
            self.epoch_sum = None
            with iter(self.loader) as it:
                while True:
                    with self.ctx.spans.span("loader_wait"):
                        host_batch = next(it, None)
                    if host_batch is None:
                        break
                    yield host_batch
            if self.epoch_sum is not None:
                self.epoch_sum.cpu()

    def _step(self) -> dict:
        host_batch = next(self._batches)
        spans = self.ctx.spans
        with spans.span("augment"):
            batch = torch.from_numpy(host_batch).to(self.ctx.device, non_blocking=True)
            batch = self.augment_batch(batch, self.aug_gen, basic=True, advanced=self.cfg.advanced_augment)
        with spans.span("train_step"):
            loss = self.train_step(self.state, self.criterion, batch, self.packed)
        stacked = torch.stack(list(loss.values()))
        self.epoch_sum = stacked if self.epoch_sum is None else self.epoch_sum + stacked
        return loss

    def _adam(self) -> tuple[dict, dict, int]:
        opt = self.state.optimizer
        return ({k: v.clone() for k, v in opt.mu.items()}, {k: v.clone() for k, v in opt.nu.items()}, opt.count)

    def _kept(self) -> None:
        """The window's step that the reference takes again: its start and
        its results copied on the card (no read, no wait)."""
        keys = list(self.sd)
        start = self.state.model.state_dict()
        start = {k: start[k].detach().clone() for k in keys}
        adam = self._adam()
        with self._first_forward():
            loss = self._step()["total"].detach().clone()
        after = self.state.model.state_dict()
        self.kept = {"start": start, "adam": adam, "loss": loss, "illu": self.illu,
                     "mu": self._adam()[0], "after": {k: after[k].detach().clone() for k in keys}}

    def window(self, seconds: float) -> Window:
        """Steps until `seconds` have passed, the kept step among them (a
        window shorter than the kept step runs on to it)."""
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or n < self.kept_step:
            if n + 1 == self.kept_step:
                self._kept()
            else:
                self._step()
            n += 1
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize(self.ctx.device)
        elapsed = time.perf_counter() - t0
        b = self.p["batch_size"]
        return Window(attempted=n, failed=0, seconds=elapsed, done=n,
                      metrics={"train_images_per_s": n * b / elapsed})

    def release(self) -> None:
        self._batches.close()
        self.state = self.criterion = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----- correctness -----
    def reference_batches(self, steps: list[int]) -> list[torch.Tensor]:
        """The batches of the steps numbered `steps` (from 0, ascending),
        worked out again: the photos in the loader's order (a shuffle an
        epoch from numpy's default_rng(seed), whole batches), augmented with
        the draws of a generator seeded as the trainer's, replayed through
        the steps between."""
        b = self.p["batch_size"]
        n = len(self.files)
        rng = np.random.default_rng(self.ctx.seed)
        batches = []
        while len(batches) <= steps[-1]:
            order = np.arange(n)
            rng.shuffle(order)
            batches += [order[i : i + b] for i in range(0, n - b + 1, b)]
        dev = self.ctx.device
        gen = torch.Generator(device=dev).manual_seed(self.ctx.seed + 1)
        out = []
        for s in range(steps[-1] + 1):
            if s not in steps:
                rtrain.draws(gen, b, dev)
                continue
            u8 = np.stack([decode.decode(self.files[i]) for i in batches[s]])
            out.append(rtrain.augment(torch.from_numpy(u8).to(dev), gen))
        return out

    def _lowered(self, lower: bool):
        return precision.tf32(self.ctx.device) if lower else contextlib.nullcontext((None, None))

    def _follow(self, lower: bool = False):
        """The reference through the first steps: (its state, each step's
        loss, the first gradient Adam took, the first step's illumination
        map)."""
        batches = self.reference_batches(list(range(REFERENCE_STEPS)))
        with self._lowered(lower) as (conv, conv_t):
            ref = rtrain.Step(self.sd, self.trainable, self.vgg_sd, self.ctx.net["use_preact"],
                              self.ctx.net["use_aspp"], conv=conv, conv_t=conv_t)
            losses, g1 = [], None
            for s, batch in enumerate(batches):
                total, taken = ref.step(batch)
                losses.append(total)
                if s == 0:
                    g1, illu1 = taken, ref.illu
        return ref, losses, g1, illu1

    def _follow_kept(self, lower: bool = False):
        """The reference's take of the kept step from the kept state: (its
        state after it, its loss, the gradient Adam took, its illumination
        map). The step lies in the schedule's first 30 epochs, at the rate
        of 1e-4."""
        [batch] = self.reference_batches([REFERENCE_STEPS + self.kept_step - 1])
        with self._lowered(lower) as (conv, conv_t):
            ref = rtrain.Step(self.kept["start"], self.trainable, self.vgg_sd, self.ctx.net["use_preact"],
                              self.ctx.net["use_aspp"], conv=conv, conv_t=conv_t, adam=self.kept["adam"])
            total, taken = ref.step(batch)
        return ref, total, taken, ref.illu

    @property
    def trainable(self) -> list[str]:
        return [k for k, (_s, kind) in self.spec.items() if kind in TRAINABLE]

    def control(self) -> list[Check]:
        """The control: the reference computed in TF32 put in the program's
        place, judged as the program is."""
        ref, losses, g1, illu1 = self._follow(lower=True)
        self.losses, self.g1, self.illu1 = losses, g1, illu1
        self.p3 = {k: ref.sd[k] for k in self.p3}
        self.s3 = {k: ref.sd[k] for k in self.s3}
        if self.kept is not None:
            ref, total, taken, illu = self._follow_kept(lower=True)
            self.kept.update(loss=torch.tensor(total), illu=illu, grad=taken, after=ref.sd)
        return self.check()

    def check(self) -> list[Check]:
        """The program's steps against the reference's: each step's loss,
        relative, and its forward's illumination map, by its largest
        difference; by leaf, the norms of the gradient Adam took, of the
        parameters' change and of the BatchNorm statistics' change: the
        worst leaf's gap, and the median leaf's for the gradient. Twice:
        the first steps, followed from the seed (the first step's loss, map
        and gradient, the change over the steps; the later steps' losses
        swing with the noise of the first updates and are reported in
        ``details``), and, named ``kept_``, the kept step of the window,
        taken again from the kept state."""
        ref, losses, g1, illu1 = self._follow()
        step_gaps = [abs(a - r) / abs(r) for a, r in zip(self.losses, losses)]
        stats = list(self.s0)
        first = judge(g1, self.g1, self.sd, ref.sd, {**self.p0, **self.s0}, {**self.p3, **self.s3},
                      self.trainable, stats)
        first.update(loss_step1_gap=step_gaps[0], illumination_step1_max_diff=map_diff(self.illu1, illu1))
        lim = self.ctx.limits
        checks = [Check(name, first[name], lim[name]) for name in COMPARED]
        self.details = {"step_loss_gaps": step_gaps, "still_leaves": first["still"],
                        "median_gaps": {"update": first["update_median"], "bn": first["bn_median"]}}
        if self.kept is None:  # the window never reached the kept step
            return checks + [Check("kept_step_run", 0.0, -1.0)]
        k = self.kept
        ref_k, total_k, taken_k, illu_k = self._follow_kept()
        mu0 = k["adam"][0]
        grad = k.get("grad") or {n: (k["mu"][n].double() - self.b1 * mu0[n].double()) / (1 - self.b1)
                                 for n in self.trainable}
        kept = judge(taken_k, grad, k["start"], ref_k.sd, k["start"], k["after"], self.trainable, stats)
        kept.update(loss_step1_gap=abs(float(k["loss"]) - total_k) / abs(total_k),
                    illumination_step1_max_diff=map_diff(k["illu"], illu_k))
        self.details.update(kept_step=self.kept_step, still_leaves_kept=kept["still"],
                            median_gaps_kept={"update": kept["update_median"], "bn": kept["bn_median"]},
                            **{kept_name(name): kept[name] for name in COMPARED if name not in KEPT_COMPARED})
        return checks + [Check(kept_name(name), kept[name], lim[kept_name(name)]) for name in KEPT_COMPARED]


# The numbers compared for the first steps; the kept step's are named by ``kept_name``.
COMPARED = ("loss_step1_gap", "illumination_step1_max_diff", "grad_norm_gap", "grad_median_gap",
            "update_norm_gap", "bn_stats_gap")
# Of those, the kept step's compared. Its loss and median gradient leaf are
# reported in ``details``: the control reads them within a few times the
# sound runs, and the first step reads those numbers at 10 to 100 times
# their median on a few seeds, so a limit under the control would now and
# then fail a sound run.
KEPT_COMPARED = ("illumination_step1_max_diff", "grad_norm_gap", "update_norm_gap", "bn_stats_gap")


def kept_name(name: str) -> str:
    return "kept_" + name.replace("_step1", "")


def map_diff(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest difference of two illumination maps; a map of another
    shape (a batch left out) is as far off as a map in [0, 1] can be."""
    if prog.shape != ref.shape:
        return 1.0
    return float((prog.double() - ref.double()).abs().max())


def judge(g_ref, g_prog, start_ref, after_ref, start, after, trainable, stats) -> dict:
    """One stretch of steps judged by leaf, the program's state going from
    `start` to `after` and the reference's from `start_ref` to `after_ref`:
    the gradient Adam took (the worst and the median leaf's gap), the
    parameters' change (the worst moving leaf's; leaves whose reference
    gradient is under ``STILL_LEAF`` of the median leaf's are left out) and
    the statistics' change."""

    def norms(d):
        return {k: float(v.double().norm()) for k, v in d.items()}

    def change(a, b, keys):
        return norms({k: a[k] - b[k] for k in keys})

    gr, gp = norms(g_ref), norms(g_prog)
    d_ref, d_prog = change(after_ref, start_ref, trainable), change(after, start, trainable)
    s_ref, s_prog = change(after_ref, start_ref, stats), change(after, start, stats)
    g_med = float(np.median(list(gr.values())))
    moving = [k for k in trainable if gr[k] >= STILL_LEAF * g_med]
    return {
        "grad_norm_gap": worst_gap(gp, gr, trainable),
        "grad_median_gap": median_gap(gp, gr, trainable),
        "update_norm_gap": worst_gap(d_prog, d_ref, moving),
        "bn_stats_gap": worst_gap(s_prog, s_ref, stats),
        "still": [k for k in trainable if k not in moving],
        "update_median": median_gap(d_prog, d_ref, moving),
        "bn_median": median_gap(s_prog, s_ref, stats),
    }


def median_gap(prog: dict, ref: dict, keys: list[str]) -> float:
    """The median leaf's gap, measured as ``worst_gap`` measures each."""
    med = float(np.median([ref[k] for k in keys]))
    return float(np.median([abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys]))


def worst_gap(prog: dict, ref: dict, keys: list[str]) -> float:
    """The largest gap between the program's and the reference's norm of a
    leaf, over the larger of that leaf's reference norm and the median
    leaf's."""
    med = float(np.median([ref[k] for k in keys]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)

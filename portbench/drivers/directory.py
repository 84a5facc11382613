"""Traffic driver ``directory``: a directory of photos enhanced round after
round, as a batch job does.

Set-up writes ``n_photos`` seeded JPEGs, draws the weights, writes them as
a reference ``.pth`` and builds the net through the program's CLI path
(``cli.build_apply_fn`` from ``Config.checkpoint``). The window calls
``infer/enhance.enhance_batch_images(..., save_outputs=False)`` over the
directory until ``seconds`` have passed, whole rounds; its end-to-end
metric is every image completed (decoded, enhanced, its u8 results on the
host) over the window's seconds. From each round two images drawn from the
seed are kept as the program fetched them; once the window has closed the
reference recomputes them from their files.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench.common import photos, weights
from portbench.common.cellbase import Check, Window, f32_backend
from portbench.reference import decode, enhance as ref_enhance, net as rnet

SAMPLES_PER_ROUND = 2
BLOCK = 4  # frames a reference call computes at once
# The traced run's spans: (module, attribute, span, kind).
SPANS = [
    ("retinex_tpu_torch.infer.batch_driver", "bucket_by_canvas", "plan", "host"),
    ("retinex_tpu_torch.infer.batch_driver", "decode_bucket", "decode", "host"),
    ("retinex_tpu_torch.infer.batch_driver", "fetch", "fetch", "host"),
]


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.captured: list[tuple[str, np.ndarray, np.ndarray]] = []
        self._paths: list[list[str]] = []
        self._want: set[str] = set()

    def frame(self) -> tuple[int, int, int]:
        """(batch, height, width) of the forward calls: the letterboxed canvas."""
        canvas = decode.letterbox(np.zeros((self.p["height"], self.p["width"], 3), np.uint8), self.p["max_size"])
        return self.p["batch_size"], canvas.shape[0], canvas.shape[1]

    # ----- set-up -----
    def setup(self) -> None:
        ctx, p = self.ctx, self.p
        self.files = photos.write(ctx.sub("photos"), ctx.seed, p["n_photos"], p["width"], p["height"], "jpeg")
        warm = ctx.sub("warm")
        for f in self.files[: 2 * p["batch_size"]]:
            os.symlink(f, os.path.join(warm, os.path.basename(f)))
        ctx.stage("photos")
        net = ctx.net
        self.sd = weights.draw(rnet.spec(net["use_preact"], net["use_aspp"]), ctx.seed, ctx.device)
        pth = weights.write_pth(self.sd, os.path.join(ctx.workdir, "weights.pth"))

        ctx.stage("weights")
        from retinex_tpu_torch import cli
        from retinex_tpu_torch.config import Config
        from retinex_tpu_torch.infer import batch_driver, enhance

        self.config = Config(
            mode="enhance", checkpoint=pth, use_preact=net["use_preact"], use_aspp=net["use_aspp"],
            packed_inference=True, max_size=p["max_size"], batch_size=p["batch_size"],
            num_workers=p["num_workers"], device=ctx.device.type,
        )
        if ctx.device.type == "cuda":
            f32_backend()
        self.apply_fn = cli.build_apply_fn(self.config, ctx.device)
        ctx.stage("program")
        self.enhance = enhance
        self._hook(batch_driver)
        self._run(warm)
        ctx.stage("warm-up")

    def _hook(self, batch_driver) -> None:
        """Keep the fetched results of the sampled files: decode_bucket's
        chunks in order, each fetch takes the oldest."""
        decode_bucket, fetch = batch_driver.decode_bucket, batch_driver.fetch
        order = self._paths

        def decode_hook(paths, *args, **kwargs):
            order.append(list(paths))
            return decode_bucket(paths, *args, **kwargs)

        def fetch_hook(outputs, n):
            out = fetch(outputs, n)
            if not order:
                raise RuntimeError("a chunk was fetched that was never decoded")
            paths = order.pop(0)
            enh, illu = out
            for j, path in enumerate(paths[:n]):
                if path in self._want:
                    self.captured.append((path, enh[j].copy(), illu[j].copy()))
                    self._want.discard(path)
            return out

        batch_driver.decode_bucket, batch_driver.fetch = decode_hook, fetch_hook

    def _run(self, directory: str) -> None:
        p = self.p
        self.enhance.enhance_batch_images(
            self.apply_fn, directory, os.path.join(self.ctx.workdir, "out"), max_size=p["max_size"],
            batch_size=p["batch_size"], num_workers=p["num_workers"], save_outputs=False, device=self.ctx.device,
        )

    # ----- window -----
    def window(self, seconds: float) -> Window:
        rng = np.random.default_rng([self.ctx.seed, 1])
        directory = os.path.dirname(self.files[0])
        done = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._want = {self.files[i] for i in rng.choice(len(self.files), SAMPLES_PER_ROUND, replace=False)}
            self._run(directory)
            done += len(self.files)
        elapsed = time.perf_counter() - t0
        return Window(attempted=done, failed=0, seconds=elapsed, done=done,
                      metrics={"images_per_s": done / elapsed})

    def release(self) -> None:
        self.apply_fn = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    # ----- correctness -----
    def _reference(self, lower: bool = False):
        net = self.ctx.net
        frames = [decode.letterbox(decode.decode(path), self.p["max_size"]) for path, _, _ in self.captured]
        return ref_enhance.enhance(self.sd, frames, net["use_preact"], net["use_aspp"], self.ctx.device,
                                   lower=lower, block=BLOCK)

    def control(self) -> list[Check]:
        """The control: the reference computed in TF32 put in the program's
        place, judged as the program is."""
        ctl = self._reference(lower=True)
        self.captured = [(path, c_enh, np.clip(np.floor(r_illu * np.float32(255.0)), 0, 255).astype(np.uint8)) for (path, _, _), (c_enh, r_illu) in zip(self.captured, ctl)]
        return self.check()

    def check(self) -> list[Check]:
        """The sampled results against the reference: the share of bytes
        that differ, in the worst image, of the enhanced image and of the
        illumination map (floor(255 v), the route's quantisation)."""
        ref = self._reference()
        enh_worst = illum_worst = 0.0
        for (path, enh, illu), (r_enh, r_illu) in zip(self.captured, ref):
            r_illu_u8 = np.clip(np.floor(r_illu * np.float32(255.0)), 0, 255).astype(np.uint8)
            enh_worst = max(enh_worst, float(np.mean(enh != r_enh)))
            illum_worst = max(illum_worst, float(np.mean(illu != r_illu_u8)))
        if not self.captured:
            return [Check("images_compared", 0.0, -1.0)]
        return [
            Check("enhanced_bytes_off", enh_worst, self.ctx.limits["enhanced_bytes_off"]),
            Check("illumination_bytes_off", illum_worst, self.ctx.limits["illumination_bytes_off"]),
        ]

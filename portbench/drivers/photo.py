"""Traffic driver ``photo``: one client in a closed loop, one photo per
call, the results kept in the host's memory.

Set-up writes a pool of ``n_photos`` seeded JPEGs, draws the weights,
writes them as a reference ``.pth`` and builds the net through the
program's CLI path. Each request is the next photo of a seeded order
through ``infer/enhance.enhance_single_image(..., save_outputs=False)``,
then the enhanced image and the illumination copied to the host; its
latency is the host clock from the call to both arrays on the host. Every
``CAPTURE_STRIDE``-th request, from an offset drawn from the seed, is kept
for the reference.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from portbench.common import photos, stats, weights
from portbench.common.cellbase import Check, Window, f32_backend
from portbench.reference import decode, enhance as ref_enhance, net as rnet

WARM_REQUESTS = 3
BLOCK = 2  # frames a reference call computes at once
# The traced run's spans: (module, attribute, span, kind); the net's span
# ("net", CUDA events) wraps the apply_fn, the copy back is "to_host".
SPANS = [
    ("retinex_tpu_torch.infer.enhance", "load_image", "decode", "host"),
    ("retinex_tpu_torch.infer.adaptive_params", "clahe_lab_rgb", "clahe", "cuda"),
]


class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self.captured: list[tuple[str, np.ndarray, np.ndarray]] = []

    def frame(self) -> tuple[int, int, int]:
        """(batch, height, width) of the forward calls."""
        canvas = decode.letterbox(np.zeros((self.p["height"], self.p["width"], 3), np.uint8), self.p["max_size"])
        return 1, canvas.shape[0], canvas.shape[1]

    def setup(self) -> None:
        ctx, p = self.ctx, self.p
        self.files = photos.write(ctx.sub("photos"), ctx.seed, p["n_photos"], p["width"], p["height"], "jpeg")
        ctx.stage("photos")
        net = ctx.net
        self.sd = weights.draw(rnet.spec(net["use_preact"], net["use_aspp"]), ctx.seed, ctx.device)
        pth = weights.write_pth(self.sd, os.path.join(ctx.workdir, "weights.pth"))

        ctx.stage("weights")
        from retinex_tpu_torch import cli
        from retinex_tpu_torch.config import Config
        from retinex_tpu_torch.infer import enhance

        config = Config(
            mode="enhance", checkpoint=pth, use_preact=net["use_preact"], use_aspp=net["use_aspp"],
            packed_inference=True, max_size=p["max_size"], device=ctx.device.type,
        )
        if ctx.device.type == "cuda":
            f32_backend()
        self.enhance = enhance
        apply_fn = cli.build_apply_fn(config, ctx.device)
        self.apply_fn = ctx.spans.wrap(apply_fn, "net", "cuda")
        ctx.stage("program")
        rng = np.random.default_rng([ctx.seed, 2])
        self.order = rng.permutation(len(self.files))
        self.stride = int(p.get("capture_stride", 16))
        self.capture_offset = int(rng.integers(self.stride))
        for i in range(WARM_REQUESTS):
            self._request(self.files[self.order[-1 - i]])
        ctx.stage("warm-up")

    def _request(self, path: str):
        enhanced, illu, _ = self.enhance.enhance_single_image(
            self.apply_fn, path, os.path.join(self.ctx.workdir, "out"), max_size=self.p["max_size"],
            save_outputs=False, device=self.ctx.device,
        )
        with self.ctx.spans.span("to_host"):
            return enhanced.cpu().numpy(), illu.cpu().numpy()

    def window(self, seconds: float) -> Window:
        lat = []
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            path = self.files[self.order[i % len(self.order)]]
            ts = time.perf_counter()
            enh, illu = self._request(path)
            lat.append(time.perf_counter() - ts)
            if i % self.stride == self.capture_offset:
                self.captured.append((path, np.round(enh * np.float32(255.0)).astype(np.uint8), illu))
            i += 1
        elapsed = time.perf_counter() - t0
        ms = [v * 1e3 for v in lat]
        return Window(attempted=i, failed=0, seconds=elapsed, done=i, metrics={
            "latency_p50_ms": stats.percentile(ms, 50), "latency_p95_ms": stats.percentile(ms, 95)})

    def release(self) -> None:
        self.apply_fn = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, lower: bool = False):
        net = self.ctx.net
        frames = [decode.letterbox(decode.decode(path), self.p["max_size"]) for path, _, _ in self.captured]
        return ref_enhance.enhance(self.sd, frames, net["use_preact"], net["use_aspp"], self.ctx.device,
                                   lower=lower, block=BLOCK)

    def control(self) -> list[Check]:
        """The control: the reference computed in TF32 put in the program's
        place, judged as the program is."""
        ctl = self._reference(lower=True)
        self.captured = [(path, c_enh, r_illu) for (path, _, _), (c_enh, r_illu) in zip(self.captured, ctl)]
        return self.check()

    def check(self) -> list[Check]:
        """The kept requests against the reference: the share of the enhanced
        image's bytes that differ, and the largest difference of the
        illumination map, in the worst request."""
        if not self.captured:
            return [Check("requests_compared", 0.0, -1.0)]
        ref = self._reference()
        enh_worst = illum_worst = 0.0
        for (path, enh, illu), (r_enh, r_illu) in zip(self.captured, ref):
            enh_worst = max(enh_worst, float(np.mean(enh != r_enh)))
            illum_worst = max(illum_worst, float(np.max(np.abs(illu.astype(np.float64) - r_illu))))
        return [
            Check("enhanced_bytes_off", enh_worst, self.ctx.limits["enhanced_bytes_off"]),
            Check("illumination_max_diff", illum_worst, self.ctx.limits["illumination_max_diff"]),
        ]

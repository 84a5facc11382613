"""What the per-layer metrics read: the traced window, the profiler's
summary, the spans and the launch counters. Each reader in ``metrics/``
returns a number or None, where it finds nothing to read."""

from __future__ import annotations

import dataclasses

from portbench.counts import flops, kernels, peaks


@dataclasses.dataclass
class ReadContext:
    workload: dict
    config: dict
    window: object  # cellbase.Window
    summary: object  # trace.Summary
    spans: object  # spans.Spans
    cell: object

    @property
    def rate(self) -> float:
        """Units (images, requests or steps) completed per second of the traced window."""
        return self.window.done / self.window.seconds


def idle_pct(rc: ReadContext) -> float | None:
    s = rc.summary
    if s is None or s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)


def net_mfu_pct(rc: ReadContext) -> float | None:
    """The standard forward's FLOPs of each image at the cell's frame, times
    images per second, over the f32 peak."""
    if rc.window.done == 0:
        return None
    _batch, h, w = rc.cell.frame()
    net = rc.config["net"]
    return 100.0 * flops.net_forward(net["use_preact"], net["use_aspp"], h, w) * rc.rate / peaks.F32_FLOPS


def train_mfu_pct(rc: ReadContext) -> float | None:
    if rc.window.done == 0:
        return None
    net, p = rc.config["net"], rc.workload["params"]
    step = flops.train_step(net["use_preact"], net["use_aspp"], p["batch_size"], p["image_size"])
    return 100.0 * step * rc.rate / peaks.F32_FLOPS


def kernel_roofline_pct(rc: ReadContext) -> float | None:
    if rc.summary is None:
        return None
    batch, h, w = rc.cell.frame()
    return kernels.roofline_pct(rc.summary.device_ops, batch, h, w)


def span_ms_per_unit(rc: ReadContext, span: str) -> float | None:
    """Milliseconds in span `span` per completed unit of the window."""
    secs = rc.spans.seconds(span)
    if not secs or rc.window.done == 0:
        return None
    return 1e3 * sum(secs) / rc.window.done

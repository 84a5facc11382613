"""The traced run's reading of ``torch.profiler``.

The profiler records the host's operations and the card's (CUPTI) over the
window; the window itself is a host span ``pb:window``. From the card's
events inside it come the busy seconds (the union of every kernel, copy
and fill), the device seconds and launches by operation name, and the idle
gaps; each gap is put down to the innermost benchmark span (``pb:*``) that
the host was in at the gap's middle, or ``other``.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.common.spans import PREFIX

WINDOW = PREFIX + "window"
# Gaps shorter than this are launch gaps between kernels, counted together.
SHORT_GAP_NS = 20_000
SHORT_LABEL = "gaps under 20 us"


@dataclasses.dataclass
class Summary:
    window_s: float
    busy_s: float
    device_ops: dict[str, tuple[int, float]]  # name -> (launches, seconds)
    idle_by_host: dict[str, float]  # what the host was doing -> idle seconds


class Tracer:
    def __init__(self, device: torch.device):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self._window = None

    def start(self) -> None:
        self.prof.start()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        self._window.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> Summary:
        events = self.prof.profiler.kineto_results.events()
        host, dev = [], []
        win = None
        for e in events:
            name = e.name()
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if "CUDA" in str(e.device_type()):
                if name.startswith(PREFIX) or getattr(e, "is_user_annotation", lambda: False)():
                    continue
                dev.append((start, end, name))
            elif name == WINDOW:
                win = (start, end)
            elif name.startswith(PREFIX):
                host.append((start, end, name[len(PREFIX):]))
        if win is None:
            raise RuntimeError("the traced window's span is missing from the profile")
        w0, w1 = win
        ops: dict[str, list] = {}
        spans = []
        for s, e, name in dev:
            s, e = max(s, w0), min(e, w1)
            if e <= s:
                continue
            rec = ops.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += (e - s) / 1e9
            spans.append((s, e))
        merged: list[list[int]] = []
        for s, e in sorted(spans):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        gaps, prev = [], w0
        for s, e in merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if w1 > prev:
            gaps.append((prev, w1))
        idle: dict[str, float] = {}
        for g0, g1 in gaps:
            if g1 - g0 < SHORT_GAP_NS:
                label = SHORT_LABEL
            else:
                mid = (g0 + g1) / 2
                inside = [(e - s, name) for s, e, name in host if s <= mid <= e]
                label = min(inside)[1] if inside else "other"
            idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e9
        return Summary(
            window_s=(w1 - w0) / 1e9,
            busy_s=busy / 1e9,
            device_ops={k: (v[0], v[1]) for k, v in ops.items()},
            idle_by_host=idle,
        )


def breakdown(summary: Summary, top: int = 10) -> dict:
    ops = sorted(summary.device_ops.items(), key=lambda kv: -kv[1][1])[:top]
    gaps = sorted(summary.idle_by_host.items(), key=lambda kv: -kv[1])[:top]
    return {
        "device_ops": [[name[:160], secs] for name, (_n, secs) in ops],
        "idle_gaps": [[name, secs] for name, secs in gaps],
    }

"""The benchmark's own spans: calls into the program, wrapped by module
attribute for the traced run, timed on the host clock and marked for the
profiler.

A span of kind ``host`` times the call on the host clock; ``cuda`` times
it with CUDA events, read once the window has closed, so it waits for
nothing inside the window. Every span also opens a ``torch.profiler``
``record_function`` named ``pb:<name>``, so the trace can say what the
host was doing in an idle gap.
"""

from __future__ import annotations

import functools
import importlib
import time
from contextlib import contextmanager

import torch

PREFIX = "pb:"


class Spans:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.host: dict[str, list[float]] = {}
        self._events: dict[str, list] = {}
        self._undo: list = []

    @contextmanager
    def span(self, name: str, kind: str = "host"):
        if not self.enabled:
            yield
            return
        cuda = self.device.type == "cuda"
        with torch.profiler.record_function(PREFIX + name):
            if kind == "cuda" and cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    yield
                finally:
                    end.record()
                    self._events.setdefault(name, []).append((start, end))
                return
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.host.setdefault(name, []).append(time.perf_counter() - t0)

    def wrap(self, fn, name: str, kind: str = "host"):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with self.span(name, kind):
                return fn(*args, **kwargs)

        return wrapped

    def patch(self, module: str, attr: str, name: str, kind: str = "host") -> None:
        """Replace ``module.attr`` by a spanned call of it until ``restore``."""
        if not self.enabled:
            return
        mod = importlib.import_module(module)
        orig = getattr(mod, attr)
        setattr(mod, attr, self.wrap(orig, name, kind))
        self._undo.append((mod, attr, orig))

    def restore(self) -> None:
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()

    def clear(self) -> None:
        """Forget what set-up recorded: the window's spans start here."""
        self.host.clear()
        self._events.clear()

    def seconds(self, name: str) -> list[float]:
        """Every duration of span `name`, in seconds (CUDA events read here)."""
        if name in self._events:
            torch.cuda.synchronize(self.device)
            return [s.elapsed_time(e) / 1e3 for s, e in self._events[name]]
        return list(self.host.get(name, []))

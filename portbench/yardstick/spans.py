"""Spans the harness records around its calls into the program's
layers: name, start, end (host ``perf_counter_ns``) and the span open
around it. Kept in memory; the per-layer readers and the trace's idle
gaps read them once the window has closed."""
from __future__ import annotations

import functools
import time


class Spans:
    def __init__(self):
        self.records: list[tuple[str, int, int, str | None]] = []
        self._open: list[str] = []
        self.on = False

    def span(self, name: str):
        return _Span(self, name)

    def wrap(self, obj, method: str) -> None:
        """Record a span around every call of ``obj.method`` (an object
        the harness built; the program's source is left alone)."""
        fn = getattr(obj, method)

        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with self.span(method):
                return fn(*args, **kwargs)

        setattr(obj, method, traced)

    def durations_s(self, name: str) -> list[float]:
        return [(b - a) / 1e9 for n, a, b, _ in self.records if n == name]

    def open_at(self, t_ns: int) -> str | None:
        """The innermost span open at host time ``t_ns``."""
        best = None
        for n, a, b, _ in self.records:
            if a <= t_ns < b and (best is None or a >= best[1]):
                best = (n, a)
        return None if best is None else best[0]


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()
        self.spans._open.append(self.name)
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self.spans._open.pop()
        if self.spans.on:
            parent = self.spans._open[-1] if self.spans._open else None
            self.spans.records.append((self.name, self.t0, t1, parent))
        return False

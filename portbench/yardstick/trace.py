"""The device trace of a measured window: ``torch.profiler`` recording
CUDA activity only (host activity would multiply its cost at thousands
of launches a round), read into sums by kernel, the busy share and the
idle gaps.

The sums by kernel follow the port's ``chip_smoke.kernel_times`` (a
frozen rewrite of it). Device timestamps are put on the host's clock by
a marker: right after a synchronise the host notes the time and launches
``torch.cuda._sleep`` (the profiler names it ``spin_kernel``), so the
marker starts a few microseconds after that note. An idle gap is then
named by the harness span that was open on the host at its middle.
"""
from __future__ import annotations

import re
import time

MARKER = "spin_kernel"
NOT_KERNEL = ("Memset", "Memcpy")


def kernel_name(raw: str) -> str:
    name = raw.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    return re.sub(r"\(.*", "", name.removeprefix("void ")).strip()


class DeviceTrace:
    """Profile from :meth:`start` to :meth:`stop`; then ``kernels``
    (name -> [seconds, launches]), ``busy_s``, ``window_s`` and
    ``gaps`` ([(host ns of the gap's middle, seconds)]) are set."""

    def __init__(self):
        self.kernels: dict[str, list] = {}
        self.busy_s = 0.0
        self.window_s = 0.0
        self.gaps: list[tuple[int, float]] = []

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self.t0 = time.perf_counter_ns()
        torch.cuda._sleep(1000)

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.t1 = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)
        self.window_s = (self.t1 - self.t0) / 1e9
        self._read()
        del self._prof

    def _read(self) -> None:
        from torch.autograd import DeviceType
        spans = []
        marker = None
        for e in self._prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            a, b = e.time_range.start, e.time_range.end        # us
            if b <= a:
                continue
            name = kernel_name(e.name)
            if MARKER in name and marker is None:
                marker = a
                continue
            spans.append((a, b))
            rec = self.kernels.setdefault(name, [0.0, 0])
            rec[0] += (b - a) / 1e6
            rec[1] += 1
        if not spans:
            return
        spans.sort()
        start = marker if marker is not None else spans[0][0]
        end = start + self.window_s * 1e6
        busy, gaps, cur_a, cur_b = 0.0, [], None, None
        prev_end = start
        for a, b in spans:
            a, b = max(a, start), min(b, end)
            if b <= a:
                continue
            if cur_b is None or a > cur_b:
                if cur_b is not None:
                    busy += cur_b - cur_a
                if a > prev_end:
                    gaps.append((prev_end, a))
                cur_a, cur_b = a, b
            else:
                cur_b = max(cur_b, b)
            prev_end = max(prev_end, cur_b)
        if cur_b is not None:
            busy += cur_b - cur_a
        if end > prev_end:
            gaps.append((prev_end, end))
        self.busy_s = busy / 1e6
        to_host = lambda us: self.t0 + int((us - start) * 1e3)
        self.gaps = [(to_host((a + b) / 2), (b - a) / 1e6) for a, b in gaps]

    def kernel_seconds(self, pattern: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name
        matches ``pattern`` (``re.search``)."""
        rx = re.compile(pattern)
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if rx.search(name):
                s += sec
                n += cnt
        return s, n

    def launches(self) -> int:
        return sum(n for name, (_, n) in self.kernels.items()
                   if not name.startswith(NOT_KERNEL))

    def top_ops(self, k: int = 10) -> list:
        items = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])
        return [[name[:120], sec] for name, (sec, _) in items[:k]]

    def idle_by_span(self, spans, k: int = 10) -> list:
        """Idle seconds summed by the harness span open on the host in
        the middle of each gap, the most idle first."""
        out: dict[str, float] = {}
        for t_ns, sec in self.gaps:
            name = spans.open_at(t_ns) or "no harness span"
            out[name] = out.get(name, 0.0) + sec
        return [[n, s] for n, s in sorted(out.items(), key=lambda kv: -kv[1])][:k]

"""Tracing for the per-layer metrics: spans around the program's layers,
kept by the benchmark's own wrappers, and the card's activity from
``torch.profiler``.

``Tracer.start`` replaces each function of ``SPANS`` by a wrapper that
records its start and end on the host clock (``time.time_ns``, the clock
the profiler stamps its events with) and starts a profile of CUDA
activity; every caller looks these functions up at call time, so every
call is caught. A span on a device layer ends in
``torch.cuda.synchronize()``, so that it holds the device work it
queued. ``Tracer.stop`` restores the functions and returns a ``Trace``:
the spans, the union of device activity inside the traced window, and
the breakdown of the result line.
"""

from __future__ import annotations

import importlib
import sys
import time

import numpy as np

# (module, function, depth, ends in a device synchronize): the byte API,
# the device pipeline and the encoders' distance miner
SPANS = (
    ("cblosc_tpu_torch.api", "compress_ctx", 0, False),
    ("cblosc_tpu_torch.api", "decompress_ctx", 0, False),
    ("cblosc_tpu_torch.api", "getitem", 0, False),
    ("cblosc_tpu_torch.gpu.pipeline", "compress_blocks", 1, True),
    ("cblosc_tpu_torch.gpu.pipeline", "decompress_blocks", 1, True),
    ("cblosc_tpu_torch.gpu.codec", "mine_group", 2, True),
)
OUTSIDE = "harness, between calls"


class Tracer:
    def __init__(self, device):
        self.device = device
        self.records: list = []
        self.paused: list = []      # (start ns, end ns) the window leaves out
        self._saved: list = []
        self._prof = None

    def _wrap(self, module, attr: str, sync: bool):
        import torch

        orig = getattr(module, attr)
        records, device = self.records, self.device
        sync = sync and device.type == "cuda"

        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                if sync:
                    torch.cuda.synchronize(device)
                records.append((attr, t0, time.time_ns()))
        return orig, wrapper

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        for mod_name, attr, _, sync in SPANS:
            module = importlib.import_module(mod_name)
            orig, wrapper = self._wrap(module, attr, sync)
            self._saved.append((module, attr, orig))
            setattr(module, attr, wrapper)
        self._prof = profile(activities=[
            ProfilerActivity.CUDA if self.device.type == "cuda"
            else ProfilerActivity.CPU])
        self._prof.start()
        self.clock_check = self._clock_check()
        self.t0 = time.time_ns()

    def _clock_check(self):
        """(host ns before, host ns after) one small device op that the
        host waits for; its device event must lie between them."""
        import torch

        h0 = time.time_ns()
        torch.ones(1 << 16, device=self.device).sum()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return h0, time.time_ns()

    def stop(self, log=sys.stderr) -> "Trace":
        import torch

        t1 = time.time_ns()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        c0 = time.perf_counter()
        self._prof.stop()
        for module, attr, orig in self._saved:
            setattr(module, attr, orig)
        c1 = time.perf_counter()
        events = device_events(self._prof)
        c2 = time.perf_counter()
        h0, h1 = self.clock_check
        first = sorted(e for e in events if h0 - 10**9 <= e[0] and e[1] <= h1)
        prof = self._prof
        trace = Trace(self.records, events, self.t0, t1,
                      torch.cuda.get_device_name(self.device)
                      if self.device.type == "cuda" else "cpu", self.paused,
                      lambda: launch_times(prof))
        print(f"portbench: profiler: {len(events)} device events; clock "
              f"check: the probe op's device event at "
              f"{(first[0][0] - h0) / 1e3 if first else None} us of a "
              f"{(h1 - h0) / 1e3} us host bracket; s to stop the profile "
              f"{c1 - c0}, to read its events {c2 - c1}, to reduce them "
              f"{time.perf_counter() - c2}", file=log)
        return trace


def device_events(prof) -> list:
    """(start ns, end ns, name, correlation id) of every kernel, copy and
    set the profile holds, in the host clock."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            out.append((start, start + e.duration_ns(), e.name(),
                        e.correlation_id()))
    return out


def launch_times(prof) -> dict:
    """correlation id -> host ns of the CUDA API call
    (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ``cuLaunchKernel``, ...)
    that queued the device event of that id."""
    from torch.autograd import DeviceType

    return {e.correlation_id(): e.start_ns()
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != DeviceType.CUDA
            and e.name().startswith("cu") and e.correlation_id()}


def _merge(starts: np.ndarray, ends: np.ndarray):
    """The union of intervals as sorted, disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(reach[idx[1:] - 1], reach[-1])


def _covered(starts: np.ndarray, ends: np.ndarray, t) -> np.ndarray:
    """ns of the sorted, disjoint intervals (starts, ends) before each
    time of ``t``."""
    t = np.asarray(t, dtype=np.int64)
    if starts.size == 0:
        return np.zeros(t.shape, dtype=np.int64)
    cum = np.concatenate(([0], np.cumsum(ends - starts)))
    i = np.searchsorted(starts, t, side="right") - 1
    j = np.maximum(i, 0)
    inside = np.clip(t - starts[j], 0, ends[j] - starts[j])
    return np.where(i >= 0, cum[j] + inside, 0)


class Trace:
    """Spans and device activity of one traced window, all in ns of the
    host clock; readers take seconds from its methods. The window leaves
    out ``paused`` intervals, the check's comparisons between calls.
    ``launches()`` gives each device event's correlation id the host ns
    of the call that launched it; it is read only where a reader asks."""

    def __init__(self, records, events, t0: int, t1: int, device_kind: str,
                 paused=(), launches=dict):
        self.t0, self.t1, self.device_kind = t0, t1, device_kind
        self._launches = launches
        ps = np.array([a for a, _ in paused], dtype=np.int64)
        pe = np.array([b for _, b in paused], dtype=np.int64)
        self.paused_starts, self.paused_ends = _merge(ps, pe)
        self.window_s = (t1 - t0 - float(
            (self.paused_ends - self.paused_starts).sum())) / 1e9
        self.spans = {}
        for name, a, b in records:
            self.spans.setdefault(name, []).append((a, b))
        self.spans = {k: np.array(sorted(v), dtype=np.int64).reshape(-1, 2)
                      for k, v in self.spans.items()}
        ev = [(max(a, t0), min(b, t1), n, c) for a, b, n, c in events
              if b > t0 and a < t1]
        self.ops = ev
        s = np.array([a for a, _, _, _ in ev], dtype=np.int64)
        e = np.array([b for _, b, _, _ in ev], dtype=np.int64)
        self.busy_starts, self.busy_ends = _merge(s, e)
        self.busy_s = float((self.busy_ends - self.busy_starts).sum()) / 1e9
        self.breakdown = {"device_ops": self._top_ops(),
                          "idle_gaps": self._idle_by_span()}

    def span_s(self, name: str) -> float:
        """Total seconds inside the spans of ``name``."""
        sp = self.spans.get(name)
        return 0.0 if sp is None else float((sp[:, 1] - sp[:, 0]).sum()) / 1e9

    def device_s_in(self, name: str) -> float:
        """Seconds of device activity (the union) inside the spans of
        ``name``."""
        sp = self.spans.get(name)
        if sp is None:
            return 0.0
        bs, be = self.busy_starts, self.busy_ends
        return float((_covered(bs, be, sp[:, 1])
                      - _covered(bs, be, sp[:, 0])).sum()) / 1e9

    def device_s_launched_in(self, starts, ends):
        """Seconds of device activity (the union) whose launch on the
        host lies inside one of the disjoint intervals (starts, ends),
        wherever on the device it ran in the window; None where the
        trace ties no device event to a launch inside them."""
        launch = self._launches()
        if not self.ops or not launch:
            return None
        order = np.argsort(np.asarray(starts, dtype=np.int64))
        st = np.asarray(starts, dtype=np.int64)[order]
        en = np.asarray(ends, dtype=np.int64)[order]
        at = np.array([launch.get(c, -1) for _, _, _, c in self.ops],
                      dtype=np.int64)
        i = np.searchsorted(st, at, side="right") - 1
        take = (i >= 0) & (at >= 0) & (at <= en[np.maximum(i, 0)])
        if not take.any():
            return None
        a = np.array([o[0] for o in self.ops], dtype=np.int64)[take]
        b = np.array([o[1] for o in self.ops], dtype=np.int64)[take]
        a, b = _merge(a, b)
        return float((b - a).sum()) / 1e9

    def _top_ops(self, k: int = 10) -> list:
        tot: dict = {}
        for a, b, n, _ in self.ops:
            tot[n] = tot.get(n, 0) + (b - a)
        top = sorted(tot.items(), key=lambda x: -x[1])[:k]
        return [[n[:160], ns / 1e9] for n, ns in top]

    def _idle_by_span(self, k: int = 10) -> list:
        """Idle device time in the window, less the paused intervals,
        summed by the innermost span open on the host at each gap's
        midpoint."""
        bs, be = self.busy_starts, self.busy_ends
        gap_s = np.concatenate(([self.t0], be))
        gap_e = np.concatenate((bs, [self.t1]))
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        mid = (gap_s + gap_e) // 2
        label = np.full(mid.size, -1)
        depth = np.full(mid.size, -1)
        names = []
        for mod_name, attr, d, _ in SPANS:
            sp = self.spans.get(attr)
            if sp is None:
                continue
            i = np.searchsorted(sp[:, 0], mid, side="right") - 1
            inside = (i >= 0) & (mid < sp[np.maximum(i, 0), 1])
            take = inside & (d > depth)
            label[take] = len(names)
            depth[take] = d
            names.append(f"{mod_name.split('.')[-1]}.{attr}")
        tot: dict = {}
        ps, pe = self.paused_starts, self.paused_ends
        idle = (gap_e - gap_s) - (_covered(ps, pe, gap_e)
                                  - _covered(ps, pe, gap_s))
        for lab, ns in zip(label, idle):
            key = names[lab] if lab >= 0 else OUTSIDE
            tot[key] = tot.get(key, 0) + int(ns)
        top = sorted(tot.items(), key=lambda x: -x[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]

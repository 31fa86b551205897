"""Host spans and the device trace of a traced run (``--trace 1``).

Spans are taken here, in the benchmark's own code, around the calls into
the program's layers (:class:`Spans` wraps them for the window and puts
them back after it); the program itself carries no instrumentation.  The
device side is ``torch.profiler`` with CUDA activity only: every kernel,
copy and set on the card, with its start and length.

Kineto stamps events with the wall clock in nanoseconds; spans are taken
with ``perf_counter_ns`` and moved onto that clock by one offset read when
the profiler starts.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class Spans:
    """Host intervals by label, plus counts that belong to them."""

    def __init__(self):
        self.intervals: dict[str, list] = defaultdict(list)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def wrapped(self, targets):
        """Wrap ``(owner, attribute, label, counter)`` targets for the
        duration of the block; ``counter(args, kwargs)`` adds to
        ``counts[label]`` (or None)."""
        saved = []
        try:
            for owner, attr, label, counter in targets:
                saved.append((owner, attr, vars(owner).get(attr)))
                setattr(owner, attr,
                        self._timed(getattr(owner, attr), label, counter))
            yield self
        finally:
            for owner, attr, own in reversed(saved):
                if own is None:          # an instance's method: unshadow it
                    delattr(owner, attr)
                else:
                    setattr(owner, attr, own)

    def _timed(self, fn, label, counter):
        out = self.intervals[label]

        def call(*args, **kwargs):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                out.append((t0, time.perf_counter_ns()))
                if counter is not None:
                    self.counts[label] += counter(args, kwargs)
        return call

    def seconds(self, label: str) -> float:
        return sum(b - a for a, b in self.intervals.get(label, ())) * 1e-9


class DeviceTrace:
    """``torch.profiler`` over the window, CUDA activity only."""

    def __init__(self):
        import torch.profiler as tp
        self._prof = tp.profile(activities=[tp.ProfilerActivity.CUDA])
        self.offset_ns = 0
        self.events = None

    def __enter__(self):
        self._prof.__enter__()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = device_events(self._prof)
        return False


def device_events(prof):
    """(names, start_ns, end_ns) of every device event of a finished
    profile, start-ordered (read from the Kineto results directly: the
    profiler's own event list costs seconds at 10^5 events)."""
    rows = [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type().name == "CUDA"]
    start = np.array([r[1] for r in rows], np.int64)
    end = start + np.array([r[2] for r in rows], np.int64)
    order = np.argsort(start, kind="stable")
    return [rows[i][0] for i in order], start[order], end[order]


def union(start: np.ndarray, end: np.ndarray, lo: int, hi: int):
    """Merged intervals of [start, end) clipped to [lo, hi)."""
    s, e = np.clip(start, lo, hi), np.clip(end, lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if s.size == 0:
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.r_[True, s[1:] > e[:-1]]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, s.size - 1]
    return s[first], e[last]


def busy_ns(start, end, lo: int, hi: int) -> int:
    s, e = union(start, end, lo, hi)
    return int((e - s).sum())


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters: ``void at::native::f<long>(long*)`` -> ``at::native::f``."""
    name = name.removeprefix("void ")
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut].strip()


def top_ops(names, start, end, lo: int, hi: int, n: int = 10) -> list:
    """The n device operations with the most time in [lo, hi), by
    :func:`short_name`."""
    dur = np.clip(end, lo, hi) - np.clip(start, lo, hi)
    total = defaultdict(int)
    for name, d in zip(names, dur.tolist()):
        if d > 0:
            total[short_name(name)] += d
    best = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns * 1e-9] for name, ns in best]


def idle_by_host(start, end, lo: int, hi: int, spans: dict,
                 rounds: list, n: int = 10) -> list:
    """Seconds the card sat idle in [lo, hi), by what the host was doing
    meanwhile: each labelled span, ``"engine"`` for the rest of a round,
    ``"between_rounds"`` outside them (all on the device clock)."""
    bs, be = union(start, end, lo, hi)
    gs, ge = np.r_[lo, be], np.r_[bs, hi]
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]

    def overlap(ivs):
        if not len(ivs):
            return np.zeros(gs.size, np.int64)
        iv = np.asarray(ivs, np.int64)
        s, e = union(iv[:, 0], iv[:, 1], lo, hi)
        cum = np.r_[0, np.cumsum(e - s)]
        return _covered(s, e, cum, ge) - _covered(s, e, cum, gs)

    totals = {}
    labelled = np.zeros(gs.size, np.int64)
    for label, ivs in spans.items():
        part = overlap(ivs)
        totals[label] = int(part.sum())
        labelled += part
    in_rounds = overlap(rounds)
    totals["engine"] = int(np.clip(in_rounds - labelled, 0, None).sum())
    totals["between_rounds"] = int(np.clip(ge - gs - in_rounds, 0,
                                           None).sum())
    best = sorted(((k, v) for k, v in totals.items() if v > 0),
                  key=lambda kv: -kv[1])[:n]
    return [[k, v * 1e-9] for k, v in best]


def _covered(s, e, cum, t):
    """Length of the union [s, e) that lies below each time in ``t``."""
    k = np.searchsorted(s, t, side="right")
    prev = np.maximum(k - 1, 0)
    part = np.clip(np.minimum(t, e[prev]) - s[prev], 0, None)
    return np.where(k > 0, cum[prev] + part, 0)

"""The device's idle time split by the program's own spans.

While a `torch.profiler` session records, every span of the port
(`ray_tpu_torch/util/tracing.py`) is also a profiler range of its name: a
`user_annotation` event on the thread that ran it, on the clock of the
device's kernels. `Trace.host` keeps the launching thread's events.

`idle_by_span` walks the trace's idle gaps (`Trace.gaps()`) and gives each
idle microsecond to the innermost of the program's spans that covers it,
the span's self idle time; what no span covers goes to `OUTSIDE`. Every
idle microsecond goes to exactly one entry, so the entries sum to the
idle time of the trace. The program's spans are those whose name starts
with one of `PREFIXES`; other ranges (PyTorch's own) are passed over.

A trace of a program without these spans has none: the readers then
return None. The session `profiler.record` opens records the host ranges
of the thread that started it alone, so it holds the train runner's
spans (the runner runs on that thread) and not those of the LLM engine's
pump thread (PERF.md, Open questions).
"""

from __future__ import annotations

import statistics
from collections import defaultdict

OUTSIDE = "outside"
PREFIXES = ("llm.", "compiled_step.", "train.")


def ranges(trace, prefixes=PREFIXES) -> list:
    """(start, end, name) in microseconds of each of the program's spans
    on the launching thread, in the order they opened."""
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                  for e in trace.host
                  if e.get("cat") == "user_annotation"
                  and e["name"].startswith(prefixes))


def count(trace, name: str) -> int:
    return sum(1 for _, _, n in ranges(trace, (name,)) if n == name)


def _innermost(spans: list) -> list:
    """The timeline cut where any span opens or closes: (start, end,
    name of the innermost span open there), only where one is open. Of
    the spans open at a point, the innermost is the one opened last."""
    marks = []
    for i, (s, e, _) in enumerate(spans):
        marks.append((s, 1, i))
        marks.append((e, 0, i))
    marks.sort()  # at one instant, closes before opens
    out, open_, prev = [], {}, None
    for t, opens, i in marks:
        if open_ and t > prev:
            inner = max(open_, key=lambda j: (spans[j][0], -spans[j][1]))
            out.append((prev, t, spans[inner][2]))
        if opens:
            open_[i] = True
        else:
            open_.pop(i, None)
        prev = t
    return out


def idle_by_span(trace, prefixes=PREFIXES) -> dict:
    """{name of the innermost span, or OUTSIDE: idle microseconds}."""
    segs = _innermost(ranges(trace, prefixes))
    out = defaultdict(float)
    k = 0
    for g0, length in trace.gaps():
        g1 = g0 + length
        covered = 0.0
        while k < len(segs) and segs[k][1] <= g0:
            k += 1
        j = k
        while j < len(segs) and segs[j][0] < g1:
            lap = min(g1, segs[j][1]) - max(g0, segs[j][0])
            if lap > 0:
                out[segs[j][2]] += lap
                covered += lap
            j += 1
        out[OUTSIDE] += length - covered
    return dict(out)


def train_idle_ms(trace, inside: bool):
    """Idle ms a training step (`train.step` spans in the trace) under a
    `train.step` span and its children (`inside`), or outside them;
    None without runner steps."""
    if trace is None:
        return None
    steps = count(trace, "train.step")
    if not steps:
        return None
    by = idle_by_span(trace, ("train.step",))
    us = sum(v for name, v in by.items() if (name != OUTSIDE) == inside)
    return us / 1e3 / steps


def span_ms_median(trace, name: str):
    """The median duration of the trace's `name` spans, ms."""
    if trace is None:
        return None
    durs = [e - s for s, e, n in ranges(trace, (name,)) if n == name]
    return statistics.median(durs) / 1e3 if durs else None

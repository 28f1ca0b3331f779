"""Device ms of one decode graph replay at the commonest decode batch:
among the traced graph replays that run no prefill attention kernel,
those with the commonest launch pattern (kernel names and grids; the
gather over the pages scales with the batch, so each batch bucket has its
own), the median span from the first kernel's start to the last one's
end."""

import statistics
from collections import Counter

from portbench import profiler


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    plain = [r for r in t.replays
             if not any(profiler.is_flash_fwd(e["name"]) for e in r)]
    if not plain:
        return None

    def pattern(r):
        return tuple((e["name"], tuple(e.get("args", {}).get("grid", ())))
                     for e in r)
    common, _ = Counter(pattern(r) for r in plain).most_common(1)[0]
    spans = [r[-1]["ts"] + r[-1]["dur"] - r[0]["ts"] for r in plain
             if pattern(r) == common]
    return statistics.median(spans) / 1e3

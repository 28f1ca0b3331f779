"""95th percentile over the window's requests of their wait from submit
to admission (the request recorder's queue and admission phases, every
request recorded)."""

import numpy as np


def read(ctx):
    waits = [r["queue_ms"] + r["admission_ms"] for r in ctx["recorder"]]
    return float(np.percentile(waits, 95)) if waits else None

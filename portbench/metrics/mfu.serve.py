"""Serving's share of the bf16 peak over the window: the algorithmic
FLOPs (`peaks.serve_flops`: prefilled prompt tokens past a cached prefix
and generated tokens, each attending to its real context) of the work
whose token reached its client inside the window, over the window's
seconds and 989 TFLOP/s."""

from portbench import peaks


def read(ctx):
    t0, t1 = ctx["t0"], ctx["t1"]
    total = 0.0
    for r in ctx["sent"]:
        stamps = r.get("stamps") or []
        if not stamps or stamps[-1] < t0 or stamps[0] >= t1:
            continue
        pf, steps = peaks.serve_flops(ctx["shape"], len(r["spec"]["tokens"]),
                                      r["cached"], len(stamps))
        total += pf if t0 <= stamps[0] < t1 else 0.0
        total += sum(f for f, s in zip(steps, stamps[1:]) if t0 <= s < t1)
    return 100.0 * total / (t1 - t0) / peaks.PEAK_BF16_FLOPS

"""The forward attention kernel's share of its roofline in a training
step: the least time of a step's forward calls (`peaks.attention_bound`
at the step's batch and length, once a layer) over their device time,
by kernel name."""

from portbench import peaks, profiler


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    secs = t.seconds_where(profiler.is_flash_fwd) / ctx["profile_steps"]
    if secs <= 0:
        return None
    s, tr = ctx["shape"], ctx["traffic"]
    bound, _ = peaks.attention_bound(
        tr["batch"], tr["seq"], s["n_head"], s["n_head"],
        s["d_model"] // s["n_head"], "bfloat16", ctx["causal"])
    return 100.0 * s["n_layer"] * bound / secs

"""The prefill attention kernel's share of its roofline while serving:
the traced prefill graph replays (those that run the forward attention
kernel) against as many requests prefilled whole (no cached prefix), in
the order their first tokens reached the client, from the first one after
the trace opened; the bound is over each prompt's real tokens
(`peaks.attention_bound`, once a layer), not the padded bucket."""

from portbench import peaks, profiler


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    n = sum(1 for r in t.replays
            if any(profiler.is_flash_fwd(e["name"]) for e in r))
    secs = t.seconds_where(profiler.is_flash_fwd)
    whole = sorted((r for r in ctx["sent"]
                    if not r["cached"] and r.get("stamps")),
                   key=lambda r: r["stamps"][0])
    if not n or secs <= 0 or len(whole) < n:
        return None
    first = next((i for i, r in enumerate(whole)
                  if r["stamps"][0] >= ctx["trace_t0"]), len(whole))
    first = min(first, len(whole) - n)
    oneshot = whole[first:first + n]
    s = ctx["shape"]
    hd = s["d_model"] // s["n_head"]
    bound = sum(peaks.attention_bound(1, len(r["spec"]["tokens"]),
                                      s["n_head"], s["n_head"], hd,
                                      "bfloat16", True)[0]
                for r in oneshot)
    return 100.0 * s["n_layer"] * bound / secs

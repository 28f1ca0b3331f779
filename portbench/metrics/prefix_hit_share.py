"""Share of the prompt tokens admitted in the window that the prefix cache
served (`PrefixCache` counters through the engine's metrics: hit tokens
over hit and miss tokens)."""


def read(ctx):
    m0, m1 = ctx["m0"], ctx["m1"]
    if "prefix_cache_hit_tokens" not in m1:
        return None
    hit = m1["prefix_cache_hit_tokens"] - m0["prefix_cache_hit_tokens"]
    miss = m1["prefix_cache_miss_tokens"] - m0["prefix_cache_miss_tokens"]
    return 100.0 * hit / (hit + miss) if hit + miss else None

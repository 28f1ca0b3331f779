"""Tokens a decode step over the window, from the engine's counters
(`tokens_generated` over `decode_steps`)."""


def read(ctx):
    steps = ctx["m1"]["decode_steps"] - ctx["m0"]["decode_steps"]
    if steps <= 0:
        return None
    return (ctx["m1"]["tokens_generated"]
            - ctx["m0"]["tokens_generated"]) / steps

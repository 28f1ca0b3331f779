"""The one generator of every traffic mix: it reads a mix's parameters
(`workloads/<traffic>.json`) and the run's `--seed`.

Training mixes (`objective`): `causal_lm` draws token rows; `mlm` draws
rows and corrupts 15 % of positions as BERT does (80 % the mask token,
10 % a random token, 10 % kept), with segment A then B.

Serving mixes: each request belongs to one of the mix's `classes`
(chosen by `weight`), with a prompt length, an output length and, for a
class with a `prefix`, one of `count` shared system prompts of `len`
tokens before its own turn. Lengths are `lognormal` (a median, a sigma,
clipped to [min, max]) or `uniform` over [min, max]. The SET of shapes
(classes, lengths, system-prompt choice, and the open loop's gaps between
arrivals) is drawn from the mix's own `shape_seed`, so every run seed
serves the same work; the run seed permutes their order and draws every
token id.
"""

from __future__ import annotations

import math

import numpy as np


def subseed(seed: int, tag: int) -> int:
    """A 63-bit seed for one purpose (`tag`) of a run seed (any integer)."""
    state = np.random.SeedSequence([seed % 2**64, tag]).generate_state(
        1, np.uint64)
    return int(state[0] >> np.uint64(1))


def _torch_gen(seed: int, tag: int, device):
    import torch

    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


# -- training -------------------------------------------------------------


def train_batches(tr: dict, cfg: dict, seed: int, device, n=None) -> list:
    """`n` (default the mix's `batches`) distinct batches, made on
    `device` from the seed in a few large calls."""
    import torch

    n = n or tr["batches"]
    b, t = tr["batch"], tr["seq"]
    vocab = cfg["traffic_vocab"]
    g = _torch_gen(seed, 1, device)
    if tr["objective"] == "causal_lm":
        toks = torch.randint(0, vocab, (n, b, t + 1), generator=g,
                             device=device)
        return [{"x": toks[i, :, :-1].contiguous(),
                 "y": toks[i, :, 1:].contiguous()} for i in range(n)]
    if tr["objective"] == "mlm":
        toks = torch.randint(0, vocab, (n, b, t), generator=g, device=device)
        sel = torch.rand(toks.shape, generator=g, device=device) \
            < tr["mask_prob"]
        kind = torch.rand(toks.shape, generator=g, device=device)
        rand = torch.randint(0, vocab, toks.shape, generator=g,
                             device=device)
        keep_mask, keep_rand = tr["mask_split"][0], 1.0 - tr["mask_split"][1]
        x = torch.where(sel & (kind < keep_mask),
                        torch.full_like(toks, cfg["mask_token_id"]),
                        torch.where(sel & (kind >= keep_rand), rand, toks))
        y = torch.where(sel, toks, torch.full_like(toks, -1))
        types = (torch.arange(t, device=device) >= t // 2).long()
        types = types.expand(b, t).contiguous()
        return [{"x": x[i], "y": y[i], "t": types} for i in range(n)]
    raise ValueError(f"unknown objective {tr['objective']!r}")


# -- serving --------------------------------------------------------------


def _length(rng, spec: dict) -> int:
    if spec["dist"] == "uniform":
        return int(rng.integers(spec["min"], spec["max"] + 1))
    if spec["dist"] == "lognormal":
        x = math.exp(math.log(spec["median"]) + spec["sigma"]
                     * rng.standard_normal())
        return int(min(max(round(x), spec["min"]), spec["max"]))
    raise ValueError(f"unknown length distribution {spec['dist']!r}")


def shapes(tr: dict, n: int) -> list:
    """`n` request shapes from the mix's `shape_seed`: dicts of `cls`,
    `prompt` (the whole prompt's length), `output` and `prefix` (the
    shared system prompt's index, or None)."""
    rng = np.random.default_rng(tr["shape_seed"])
    weights = np.array([c["weight"] for c in tr["classes"]], float)
    out = []
    for _ in range(n):
        ci = int(rng.choice(len(weights), p=weights / weights.sum()))
        c = tr["classes"][ci]
        turn = _length(rng, c["prompt"])
        prefix = None
        if "prefix" in c:
            prefix = int(rng.integers(c["prefix"]["count"]))
            turn += c["prefix"]["len"]
        out.append({"cls": ci, "prompt": turn,
                    "output": _length(rng, c["output"]), "prefix": prefix})
        if turn + out[-1]["output"] > tr["max_total"]:
            raise ValueError(f"a request of {turn} + {out[-1]['output']} "
                             f"tokens exceeds max_total {tr['max_total']}")
    return out


def requests(tr: dict, cfg: dict, seed: int, n: int) -> list:
    """`n` requests in the run's order (a closed loop's shapes permuted by
    the seed), each with its token ids (dicts of `shapes` plus
    `tokens`)."""
    rng = np.random.default_rng(subseed(seed, 2))
    vocab = cfg["traffic_vocab"]
    base = shapes(tr, n)
    systems = {ci: rng.integers(0, vocab, (c["prefix"]["count"],
                                           c["prefix"]["len"])).tolist()
               for ci, c in enumerate(tr["classes"]) if "prefix" in c}
    order = rng.permutation(n) if tr["loop"] == "closed" else range(n)
    out = []
    for i in order:
        s = dict(base[i])
        own = s["prompt"]
        head = []
        if s["prefix"] is not None:
            head = systems[s["cls"]][s["prefix"]]
            own -= len(head)
        s["tokens"] = head + rng.integers(0, vocab, own).tolist()
        out.append(s)
    return out


def arrivals(tr: dict, seconds: float) -> list:
    """Open loop: the due times (seconds from the window's start) of the
    requests, Poisson at the mix's `rate` from its `shape_seed`."""
    n = int(math.ceil(tr["rate"] * seconds * 1.2)) + 16
    gaps = np.random.default_rng(tr["shape_seed"] + 1).exponential(
        1.0 / tr["rate"], n)
    due = np.concatenate([[0.0], np.cumsum(gaps[1:])])
    return [float(t) for t in due if t < seconds]

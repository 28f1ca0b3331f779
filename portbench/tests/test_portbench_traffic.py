"""The traffic generator: the same seed gives the same inputs, every
seed serves the same set of shapes, and no request exceeds the context."""

import collections

import pytest
import torch

from portbench import spec, traffic
from portbench.tests.tiny import BENCH_ALL as BENCH, ROOT

SERVE = [w for w in BENCH["workloads"]
         if spec.traffic(w["traffic"])["driver"] == "serve"]
TRAIN = [w for w in BENCH["workloads"]
         if spec.traffic(w["traffic"])["driver"] == "train"]


def _cfg(w):
    return spec.config(BENCH, ROOT, w["config"])


@pytest.mark.parametrize("w", SERVE, ids=lambda w: w["name"])
def test_same_seed_same_requests(w):
    tr = spec.traffic(w["traffic"])
    a = traffic.requests(tr, _cfg(w), 2**31 + 5, 300)
    b = traffic.requests(tr, _cfg(w), 2**31 + 5, 300)
    c = traffic.requests(tr, _cfg(w), 7, 300)
    assert a == b
    assert [r["tokens"] for r in a] != [r["tokens"] for r in c]

    def shape_set(rs):
        return collections.Counter((r["cls"], r["prompt"], r["output"],
                                    r["prefix"]) for r in rs)
    assert shape_set(a) == shape_set(c)


@pytest.mark.parametrize("w", SERVE, ids=lambda w: w["name"])
def test_requests_fit_the_context(w):
    tr, cfg = spec.traffic(w["traffic"]), _cfg(w)
    reqs = traffic.requests(tr, cfg, 11, 4096)
    assert max(len(r["tokens"]) + r["output"] for r in reqs) <= 1000
    assert all(len(r["tokens"]) == r["prompt"] for r in reqs)
    assert all(0 <= t < cfg["traffic_vocab"] for r in reqs[:200]
               for t in r["tokens"])
    longest = max(tr["engine"]["prefill_buckets"])
    assert max(len(r["tokens"]) for r in reqs) <= longest


def test_shared_prefixes_are_shared():
    tr = spec.traffic("chat_open_shared")
    w = {"config": "gpt2_124m"}
    reqs = traffic.requests(tr, _cfg(w), 3, 400)
    shared = [r for r in reqs if r["prefix"] is not None]
    assert 0.35 < len(shared) / len(reqs) < 0.65
    heads = {tuple(r["tokens"][:256]) for r in shared}
    assert len(heads) == tr["classes"][0]["prefix"]["count"]


def test_open_loop_replays_fixed_arrivals_and_shapes():
    tr = spec.traffic("chat_open_shared")
    a = traffic.arrivals(tr, 30.0)
    assert a[0] == 0.0 and all(x < y for x, y in zip(a, a[1:]))
    assert abs(len(a) / 30.0 - tr["rate"]) < 0.25 * tr["rate"]
    cfg = spec.config(BENCH, ROOT, "gpt2_124m")
    x, y = (traffic.requests(tr, cfg, seed, 50) for seed in (1, 2))
    assert [r["prompt"] for r in x] == [r["prompt"] for r in y]
    assert [r["tokens"] for r in x] != [r["tokens"] for r in y]


@pytest.mark.parametrize("w", TRAIN, ids=lambda w: w["name"])
def test_train_batches_from_seed(w):
    tr = dict(spec.traffic(w["traffic"]), batch=4, seq=64)
    cfg = _cfg(w)
    a = traffic.train_batches(tr, cfg, 2**32 + 3, "cpu", n=3)
    b = traffic.train_batches(tr, cfg, 2**32 + 3, "cpu", n=3)
    for x, y in zip(a, b):
        assert all(torch.equal(x[k], y[k]) for k in x)
    rows = torch.cat([x["x"] for x in a])
    assert len({tuple(r.tolist()) for r in rows}) == rows.shape[0]
    if tr["objective"] == "mlm":
        big = traffic.train_batches(dict(tr, batch=64, seq=512), cfg, 1,
                                    "cpu", n=1)[0]
        share = float((big["y"] != -1).float().mean())
        assert abs(share - tr["mask_prob"]) < 0.01
        masked = big["x"][big["y"] != -1]
        assert abs(float((masked == cfg["mask_token_id"]).float().mean())
                   - 0.8) < 0.02

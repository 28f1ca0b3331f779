"""Serving cells: `LLMEngine.submit` with the engine's pump running.

Set-up makes the weights in the type they are served in, builds the
engine with the mix's `engine` settings and captures every bucket
(`warmup()`), then starts the pump. Clients submit in-process. Each
request's events reach one reader thread through the request's `sink`
(the hook Serve's native dispatch feeds its response ring through),
which stamps every token as it reaches the client side; one thread rather
than one per request, so that the clients take as little of the
interpreter from the engine's pump as they can:

- closed loop: `clients` requests in flight, the reader sending the next
  one as each finishes. They start `ramp_s` before the window, so that
  the window opens on a full, desynchronized batch; a request is timed
  when it was sent inside the window, and its clock starts when it was
  sent;
- open loop: a sender thread submits at fixed due times
  (`traffic.arrivals`); a request is timed when it was due inside the
  window, and its clock starts when it was due, so a late send counts
  against it.

After the window no timed request is sent; every timed request is waited
for (at most `DRAIN_S` past the close) and one that never finishes, or
ends in an error or short, is failed. With `--trace 1` the load goes on
for `trace_s` more seconds under the profiler, untimed; the pump is
stopped and started again around the profiler's start and stop, which
can deadlock against a thread that launches CUDA work meanwhile.
"""

from __future__ import annotations

import contextlib
import gc
import queue
import threading
import time

import numpy as np

from portbench import profiler, spec, traffic
from portbench.trail import say
from portbench.reference.precision import PRECISIONS, no_tf32

DRAIN_S = 60.0      # how long past the close a timed request is waited for


class Load:
    """The clients of one run: a reader thread (and, for an open loop, a
    sender thread) over the engine's public `submit` and `Request.sink`."""

    def __init__(self, engine, tr: dict, specs: list):
        from ray_tpu_torch.serve.llm.engine import RequestRejected

        self.engine, self.tr = engine, tr
        self.specs = iter(specs)
        self.rejected = RequestRejected
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.idle = threading.Condition(self.lock)
        self.sent = []          # every record, in send order
        self.open = 0           # sent and not finished
        self.seen_prefix = set()
        self.events = queue.SimpleQueue()
        self.threads = []

    def _send(self, spec, due):
        rec = {"spec": spec, "due": due, "sent": time.perf_counter(),
               "cached": 0, "got": {}}
        key = (spec["cls"], spec["prefix"])
        if spec["prefix"] is not None:
            # the prefix cache holds a system prompt once its first
            # request has been prefilled
            if key in self.seen_prefix:
                cls = self.tr["classes"][spec["cls"]]
                rec["cached"] = cls["prefix"]["len"]
            self.seen_prefix.add(key)
        with self.lock:
            self.sent.append(rec)
            self.open += 1
        try:
            req = self.engine.submit(spec["tokens"], spec["output"])
        except self.rejected as e:
            self.events.put((rec, "error", (repr(e),)))
            return
        rec["req"] = req
        req.sink = lambda kind, *rest: self.events.put((rec, kind, rest))
        # what the engine emitted before the sink was set went to out_q
        self._take_queued(rec, self.events.put)

    @staticmethod
    def _take_queued(rec, put):
        while True:
            try:
                kind, *rest = rec["req"].out_q.get_nowait()
            except queue.Empty:
                return
            put((rec, kind, tuple(rest)))

    @staticmethod
    def _late(item, now):
        rec, kind, rest = item
        if kind == "token":
            rec["got"].setdefault(rest[0], (rest[1], now))

    def _next(self):
        return next(self.specs, None)

    def _finish(self, rec, now):
        """A request ended: its tokens in order, or an error."""
        if "req" in rec:    # events that raced past the sink
            self._take_queued(rec, lambda item: self._late(item, now))
        got = rec.pop("got")
        n = len(got)
        if set(got) != set(range(n)):
            rec.setdefault("error", f"tokens missing of {n}")
        rec["tokens"] = [got[i][0] for i in sorted(got)]
        rec["stamps"] = [got[i][1] for i in sorted(got)]
        with self.lock:
            self.open -= 1
            self.idle.notify_all()

    def _reader(self, closed: bool):
        if closed:
            for _ in range(self.tr["clients"]):
                self._send_next()
        while True:
            item = self.events.get()
            if item is None:
                return
            rec, kind, rest = item
            now = time.perf_counter()
            if kind == "token":
                rec["got"][rest[0]] = (rest[1], now)
                continue
            if kind == "error":
                rec["error"] = rest[0]
            self._finish(rec, now)
            if closed:
                self._send_next()

    def _send_next(self):
        if not self.stop.is_set():
            spec = self._next()
            if spec is not None:
                self._send(spec, time.perf_counter())

    def _dispatch(self, t0: float, dues: list):
        for due in dues:
            if self.stop.is_set():
                return
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            spec = self._next()
            if spec is None:
                return
            self._send(spec, t0 + due)

    def _spawn(self, target, *args):
        t = threading.Thread(target=target, args=args, daemon=True)
        t.start()
        self.threads.append(t)

    def start_closed(self):
        self._spawn(self._reader, True)

    def start_open(self, t0: float, dues: list):
        self._spawn(self._reader, False)
        self._spawn(self._dispatch, t0, dues)

    def finish(self, deadline: float):
        """Stops sending and waits (until `deadline`) for every request
        sent to end."""
        self.stop.set()
        for t in self.threads[1:]:
            t.join(max(0.0, deadline - time.perf_counter()))
        with self.lock:
            while self.open and time.perf_counter() < deadline:
                self.idle.wait(max(0.0, deadline - time.perf_counter()))
        self.events.put(None)
        self.threads[0].join(max(0.0, deadline - time.perf_counter()))


@contextlib.contextmanager
def paused(engine):
    """The pump stopped (its current step finished) for the duration."""
    engine.stop()
    try:
        yield
    finally:
        engine.start()


def _p95(values):
    return float(np.percentile(values, 95)) if values else float("nan")


def _sleep_until(t):
    wait = t - time.perf_counter()
    if wait > 0:
        time.sleep(wait)


def run(job) -> dict:
    import torch

    from ray_tpu_torch.parallel.compile_cache import global_cache
    from ray_tpu_torch.util import request_recorder

    cfg, tr, dev = job.cfg, job.tr, job.device
    params = job.fam.make_params(cfg, job.seed, dev, train=False)
    engine = job.fam.engine(cfg, params, tr["engine"], dev)
    engine.warmup()
    engine.start()
    say(job, "engine warmed up and started")
    extra = tr["trace_s"] if job.trace else 0.0
    if tr["loop"] == "closed":
        specs = traffic.requests(tr, cfg, job.seed, tr["pool"])
        load = Load(engine, tr, specs)
        load.start_closed()
        time.sleep(tr["ramp_s"])
        t0 = time.perf_counter()
    else:
        dues = traffic.arrivals(tr, job.seconds + extra)
        specs = traffic.requests(tr, cfg, job.seed, len(dues))
        load = Load(engine, tr, specs)
        t0 = time.perf_counter() + 0.01
        load.start_open(t0, dues)
        _sleep_until(t0)
    setup_s = time.time() - job.t_start
    t0_wall = time.time()
    m0 = engine.metrics()
    t1 = t0 + job.seconds
    _sleep_until(t1)
    m1 = engine.metrics()
    t1_wall = time.time()
    say(job, f"window closed: {len(load.sent)} requests sent so far")
    tr_obj, trace_t0 = None, None
    if job.trace:
        marks = {}

        def body():
            marks["t0"] = time.perf_counter()
            time.sleep(tr["trace_s"])
        tr_obj = profiler.record(body, quiet=lambda: paused(engine))
        trace_t0 = marks["t0"]
        say(job, f"traced: {len(tr_obj.ops)} device ops")
    load.finish(t1 + extra + DRAIN_S)
    say(job, "load drained")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    records = [r.as_dict() for r in request_recorder.ring().recent()
               if r.role == "engine" and t0_wall <= r.ts < t1_wall]
    engine.shutdown()
    del engine
    global_cache().clear()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with load.lock:
        sent = list(load.sent)
    timed = [r for r in sent if t0 <= r["due"] < t1]
    ok = [r for r in timed if "stamps" in r and "error" not in r
          and len(r["tokens"]) == r["spec"]["output"]]
    for r in sent:
        r.pop("req", None)
    tokens = sum(sum(1 for s in r.get("stamps", ()) if t0 <= s < t1)
                 for r in sent)
    ttft = [r["stamps"][0] - r["due"] for r in ok]
    tpot = [(r["stamps"][-1] - r["stamps"][0]) / (len(r["stamps"]) - 1)
            for r in ok if len(r["stamps"]) > 1]
    say(job, f"engine shut down; reference over {job.tr['sample']} requests")
    picked = sample(job, ok)
    readings = {"logit_gap": logit_gap(job, params, picked)}
    ctx = {"t0": t0, "t1": t1, "sent": sent, "m0": m0, "m1": m1,
           "recorder": records, "trace": tr_obj, "trace_t0": trace_t0,
           "shape": job.fam.shape(cfg)}
    return {"e2e": {"serve_tokens_per_s": tokens / job.seconds,
                    "ttft_p95_ms": _p95(ttft) * 1e3,
                    "tpot_p95_ms": _p95(tpot) * 1e3,
                    "setup_s": setup_s},
            "attempted": len(timed), "failed": len(timed) - len(ok),
            "readings": readings, "ctx": ctx, "memory_peak_bytes": peak,
            "trace": tr_obj, "params": params, "sampled": picked,
            "notes": {"requests_timed": len(timed),
                      "late_send_p95_ms": _p95(
                          [r["sent"] - r["due"] for r in timed]) * 1e3}}


def sample(job, done: list) -> list:
    """The requests the check reads: the longest finished one (prompt and
    served tokens) and others drawn from the seed, `sample` in all."""
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i]["spec"]
                                                     ["tokens"])
                  + len(done[i]["tokens"]))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng(traffic.subseed(job.seed, 4))
    k = min(job.tr["sample"] - 1, len(rest))
    picked = rng.choice(len(rest), size=k, replace=False) if k else []
    return [done[longest]] + [done[rest[i]] for i in picked]


def served_positions(job, params: dict, rec: dict, precision="float32"):
    """The reference's logits [N, V] at the positions of a request's N
    served tokens (teacher forced over its prompt and served tokens)."""
    import torch

    ref = spec.reference(job.fam.REFERENCE)
    prompt, out = rec["spec"]["tokens"], rec["tokens"]
    seq = torch.tensor([prompt + out[:-1]], device=job.device)
    with torch.no_grad():
        lg = ref.logits(params, seq, job.cfg, PRECISIONS[precision])[0]
    return lg[len(prompt) - 1:]


def logit_gap(job, params: dict, recs: list, control=None) -> float:
    """The widest gap, over the sampled requests' served tokens, between
    the reference's best logit and the served token's. With `control`
    (a precision), the token judged at each position is the one that
    precision's reference puts first instead of the served one."""
    import torch

    if not recs:
        return float("nan")
    no_tf32()
    ref_p = {n: t.to(torch.float32) for n, t in params.items()}
    worst = 0.0
    for rec in recs:
        lg = served_positions(job, ref_p, rec)
        if control is None:
            toks = torch.tensor(rec["tokens"], device=lg.device)
        else:
            toks = served_positions(job, ref_p, rec, control).argmax(-1)
        gap = lg.max(-1).values - lg.gather(-1, toks[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst

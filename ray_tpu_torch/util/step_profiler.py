"""Flight recorder: bounded, always-on per-step telemetry.

The port's own copy of `ray_tpu/util/step_profiler.py`. Two bounded ring
buffers live in every process:

``StepStats`` ring
    One record per step: the LLM engine records each `step()` (wall ms,
    tokens, prefill and decode ms, running sequences); a train-step
    runner (with the port of the train plane) records host-dispatch ms,
    device-execute ms, data-wait, collective and checkpoint time,
    tokens/flops and the derived MFU. Bounded (``RAY_TPU_STEP_RING``,
    default 1024 records): the oldest record is evicted.

dispatch ring
    Sampled host times of `parallel.compiled_step` calls (one in
    ``RAY_TPU_DISPATCH_SAMPLE`` calls, default 16; the unsampled cost
    is one integer increment). On the card such a call is a CUDA graph
    replay with its input copies.

Export surfaces, as in the JAX package: ``metrics_text()`` is a
scrape-time callback on the port's ``DEFAULT_REGISTRY``
(``train_step_*`` and ``compiled_dispatch_*`` families); with
``RAY_TPU_TRACE=1`` each record is also appended to a
``steps-<pid>.jsonl`` shard beside the span shards, which ``collect()``
merges and ``to_chrome()`` renders as a per-process "train-step" row;
``format_table()`` prints the last-N table (the CLI's ``profile``).

MFU divides by the card's peak: ``_detect_peak_flops`` asks
``torch.cuda`` for the device and knows the H100's dense bf16 peak.

Recording never raises and never blocks: ring appends are GIL-atomic
``deque.append`` calls, shard writes are line-buffered and swallow
OSError.
"""

from __future__ import annotations

import collections
import glob
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.util import tracing as _tracing

# -- knobs (cached at import; refresh() re-reads, tests/bench may call
# set_enabled() to toggle in-process without an env round trip) ----------

_TRUTHY = ("1", "true", "on", "yes")


def _env_enabled() -> bool:
    return os.environ.get("RAY_TPU_STEP_PROFILER", "1").lower() \
        not in ("0", "false", "off", "no")


def _env_capacity() -> int:
    try:
        return max(1, int(os.environ.get("RAY_TPU_STEP_RING", "1024")))
    except ValueError:
        return 1024


def _env_sample() -> int:
    try:
        return max(1, int(os.environ.get("RAY_TPU_DISPATCH_SAMPLE", "16")))
    except ValueError:
        return 16


_ENABLED = _env_enabled()
_DISPATCH_SAMPLE = _env_sample()


def enabled() -> bool:
    """Cached on/off switch — an attribute read, not an environ probe
    (the compiled_step hot path checks this per call)."""
    return _ENABLED


def set_enabled(value: bool) -> None:
    global _ENABLED
    _ENABLED = bool(value)


def sync_mode() -> bool:
    """Whether a train-step runner fences each step with
    ``torch.cuda.synchronize()`` to split host dispatch from device
    execution (default on; ``RAY_TPU_PROFILE_SYNC=0`` keeps dispatch
    fully asynchronous)."""
    return os.environ.get("RAY_TPU_PROFILE_SYNC", "1").lower() in _TRUTHY


def refresh() -> None:
    """Re-read every env knob (tests flip env vars mid-process)."""
    global _ENABLED, _DISPATCH_SAMPLE
    _ENABLED = _env_enabled()
    _DISPATCH_SAMPLE = _env_sample()
    _RING.resize(_env_capacity())


# -- the per-step record -------------------------------------------------

_PHASES = ("host_dispatch_ms", "device_execute_ms", "data_wait_ms",
           "collective_ms", "checkpoint_ms")


@dataclass
class StepStats:
    step: int
    ts: float                         # wall-clock start (unix seconds)
    total_ms: float = 0.0
    host_dispatch_ms: float = 0.0
    device_execute_ms: float = 0.0
    data_wait_ms: float = 0.0
    collective_ms: float = 0.0
    checkpoint_ms: float = 0.0
    tokens: int = 0
    flops: float = 0.0                # model flops for this record
    mfu: Optional[float] = None
    steps_per_call: int = 1
    attrs: Dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        d = {
            "step": self.step, "ts": self.ts,
            "total_ms": round(self.total_ms, 3),
            "tokens": self.tokens, "flops": self.flops,
            "mfu": None if self.mfu is None else round(self.mfu, 4),
            "steps_per_call": self.steps_per_call,
        }
        for ph in _PHASES:
            d[ph] = round(getattr(self, ph), 3)
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d


class StepRing:
    """Bounded ring of StepStats. Appends are deque.append (GIL-atomic);
    eviction is the deque's maxlen — sustained stepping holds steady
    memory and keeps the newest N records."""

    def __init__(self, capacity: Optional[int] = None):
        self._ring: collections.deque = collections.deque(
            maxlen=capacity or _env_capacity())
        self.total_recorded = 0  # monotonic, survives eviction

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def resize(self, capacity: int) -> None:
        if capacity != self._ring.maxlen:
            self._ring = collections.deque(self._ring, maxlen=capacity)

    def append(self, rec: StepStats) -> None:
        self._ring.append(rec)
        self.total_recorded += 1

    def recent(self, n: Optional[int] = None) -> List[StepStats]:
        items = list(self._ring)
        return items if n is None else items[-n:]

    def clear(self) -> None:
        self._ring.clear()
        self.total_recorded = 0

    def __len__(self) -> int:
        return len(self._ring)


_RING = StepRing()

# sampled compiled_step dispatch timings: (name, host_ms) pairs
_DISPATCH_RING: collections.deque = collections.deque(maxlen=256)
_dispatch_calls = 0           # every call (unsampled cost: one += )
_dispatch_sampled = 0

# per-thread pending phase accumulators folded into the next record_step
# (collectives/checkpoint code paths call add_phase_ms without having
# the step context in hand)
_pending = threading.local()


def ring() -> StepRing:
    return _RING


# -- device peak flops (for the MFU column) ------------------------------

_peak_flops: Optional[float] = None
_detected_peak: Any = "unset"  # memo: device detection costs ~µs


def set_peak_flops(value: Optional[float]) -> None:
    global _peak_flops, _detected_peak
    _peak_flops = value
    _detected_peak = "unset"


def peak_flops() -> Optional[float]:
    """Per-device dense bf16 peak for MFU: explicit set_peak_flops()
    wins, else detected once from the local CUDA device (None on the
    CPU or on another card: MFU is then only
    computed for records that carry their own peak)."""
    global _detected_peak
    if _peak_flops is not None:
        return _peak_flops
    if _detected_peak != "unset":
        return _detected_peak
    _detected_peak = _detect_peak_flops()
    return _detected_peak


# the H100 SXM's dense bf16 tensor-core peak (NVIDIA data sheet, at the
# full 700 W power limit)
H100_PEAK_BF16_FLOPS = 989e12


def _detect_peak_flops() -> Optional[float]:
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(torch.cuda.current_device())
        return H100_PEAK_BF16_FLOPS if "H100" in name else None
    except Exception:  # noqa: BLE001 — recorder must never raise
        return None


# -- recording -----------------------------------------------------------

def add_phase_ms(phase: str, ms: float) -> None:
    """Accumulate time into the NEXT record_step() on this thread
    (e.g. the checkpoint persist in the train session, or a host-side
    collective barrier). Unknown phases land in attrs."""
    if not _ENABLED:
        return
    acc = getattr(_pending, "acc", None)
    if acc is None:
        acc = _pending.acc = {}
    acc[phase] = acc.get(phase, 0.0) + ms


_EMPTY: Dict[str, float] = {}


def take_pending() -> Dict[str, float]:
    acc = getattr(_pending, "acc", None)
    if not acc:
        return _EMPTY
    _pending.acc = {}
    return acc


def record_step(step: int, total_ms: float, *,
                host_dispatch_ms: float = 0.0,
                device_execute_ms: float = 0.0,
                data_wait_ms: float = 0.0,
                collective_ms: float = 0.0,
                checkpoint_ms: float = 0.0,
                tokens: int = 0, flops: float = 0.0,
                steps_per_call: int = 1,
                peak: Optional[float] = None,
                **attrs) -> Optional[StepStats]:
    """Record one step (or one K-step dispatch). Returns the record, or
    None when the recorder is disabled."""
    if not _ENABLED:
        return None
    pending = take_pending()
    rec = StepStats(
        step=step, ts=time.time(), total_ms=total_ms,
        host_dispatch_ms=host_dispatch_ms + pending.pop(
            "host_dispatch_ms", 0.0),
        device_execute_ms=device_execute_ms + pending.pop(
            "device_execute_ms", 0.0),
        data_wait_ms=data_wait_ms + pending.pop("data_wait_ms", 0.0),
        collective_ms=collective_ms + pending.pop("collective_ms", 0.0)
        + pending.pop("collective", 0.0),
        checkpoint_ms=checkpoint_ms + pending.pop("checkpoint_ms", 0.0)
        + pending.pop("checkpoint", 0.0),
        tokens=tokens, flops=flops, steps_per_call=steps_per_call,
        attrs=attrs,
    )
    for k, v in pending.items():  # leftover custom phases
        rec.attrs[k] = v
    if flops and total_ms > 0:
        p = peak if peak is not None else peak_flops()
        if p:
            rec.mfu = flops / (total_ms / 1e3) / p
    _RING.append(rec)
    _write_shard(rec)
    return rec


def record_dispatch(name: str, host_ms: float) -> None:
    """Sampled compiled_step dispatch sample: called by the AOT cache
    wrapper once per RAY_TPU_DISPATCH_SAMPLE calls."""
    global _dispatch_sampled
    _dispatch_sampled += 1
    _DISPATCH_RING.append((name, host_ms))


def count_dispatch() -> bool:
    """Hot-path gate for compiled_step: one increment + mask test per
    call; True on the calls that should be timed (sampled)."""
    global _dispatch_calls
    _dispatch_calls += 1
    return _dispatch_calls % _DISPATCH_SAMPLE == 0


def dispatch_stats() -> Dict[str, Any]:
    samples = [ms for _n, ms in _DISPATCH_RING]
    out: Dict[str, Any] = {
        "calls": _dispatch_calls,
        "sampled": _dispatch_sampled,
        "sample_interval": _DISPATCH_SAMPLE,
    }
    if samples:
        ordered = sorted(samples)
        out["p50_ms"] = round(ordered[len(ordered) // 2], 4)
        out["max_ms"] = round(ordered[-1], 4)
    return out


def clear() -> None:
    global _dispatch_calls, _dispatch_sampled
    _RING.clear()
    _DISPATCH_RING.clear()
    _dispatch_calls = _dispatch_sampled = 0
    _pending.acc = {}


# -- summaries (CLI/dashboard) -------------------------------------------

def recent(n: Optional[int] = None) -> List[Dict[str, Any]]:
    return [r.as_dict() for r in _RING.recent(n)]


def attribution(records: Optional[List[Dict[str, Any]]] = None
                ) -> Dict[str, float]:
    """Where the wall time of the recorded steps went: fraction of the
    summed step time per phase, plus 'other' (un-attributed)."""
    recs = recent() if records is None else records
    total = sum(r.get("total_ms", 0.0) for r in recs)
    if total <= 0:
        return {}
    out = {}
    accounted = 0.0
    for ph in _PHASES:
        ms = sum(r.get(ph, 0.0) for r in recs)
        accounted += ms
        out[ph[:-3]] = round(ms / total, 4)
    out["other"] = round(max(0.0, 1.0 - accounted / total), 4)
    return out


def summary() -> Dict[str, Any]:
    recs = recent()
    out: Dict[str, Any] = {
        "recorded": _RING.total_recorded,
        "in_ring": len(recs),
        "ring_capacity": _RING.capacity,
        "dispatch": dispatch_stats(),
    }
    if recs:
        totals = sorted(r["total_ms"] for r in recs)
        out["step_ms_p50"] = round(totals[len(totals) // 2], 3)
        out["step_ms_max"] = round(totals[-1], 3)
        mfus = [r["mfu"] for r in recs if r.get("mfu") is not None]
        if mfus:
            out["mfu_last"] = mfus[-1]
            out["mfu_mean"] = round(sum(mfus) / len(mfus), 4)
        out["attribution"] = attribution(recs)
    return out


# -- metrics export ------------------------------------------------------

def metrics_text() -> str:
    """Prometheus exposition chunk, computed at scrape time (registered
    as a DEFAULT_REGISTRY callback below — no per-step metric objects,
    which is exactly what raylint's metric-in-hot-loop check exists to
    keep out of the hot path)."""
    recs = _RING.recent()
    lines = [
        "# TYPE train_steps_recorded_total counter",
        f"train_steps_recorded_total {_RING.total_recorded}",
        "# TYPE train_step_ring_size gauge",
        f"train_step_ring_size {len(recs)}",
        "# TYPE compiled_dispatch_calls_total counter",
        f"compiled_dispatch_calls_total {_dispatch_calls}",
    ]
    if recs:
        last = recs[-1]
        lines.append("# TYPE train_step_time_ms gauge")
        lines.append(f'train_step_time_ms{{phase="total"}} '
                     f'{round(last.total_ms, 3)}')
        for ph in _PHASES:
            lines.append(
                f'train_step_time_ms{{phase="{ph[:-3]}"}} '
                f'{round(getattr(last, ph), 3)}')
        if last.mfu is not None:
            lines.append("# TYPE train_step_mfu gauge")
            lines.append(f"train_step_mfu {round(last.mfu, 4)}")
        if last.tokens:
            lines.append("# TYPE train_step_tokens gauge")
            lines.append(f"train_step_tokens {last.tokens}")
    disp = dispatch_stats()
    if "p50_ms" in disp:
        lines.append("# TYPE compiled_dispatch_ms gauge")
        lines.append(f'compiled_dispatch_ms{{quantile="0.5"}} '
                     f'{disp["p50_ms"]}')
    return "\n".join(lines) + "\n"


# -- tracing-shard persistence (for the unified timeline) ----------------

_shard_lock = threading.Lock()
_shard_file = None


def _reset_shard_writer() -> None:
    # fork safety: a child inheriting the parent's handle would append
    # to the parent's pid-named shard. Runs in the just-forked child
    # (single-threaded); taking the fork-inherited lock could deadlock
    # on a holder that no longer exists.
    global _shard_file
    _shard_file = None


def _write_shard(rec: StepStats) -> None:
    if not _tracing.enabled():
        return
    global _shard_file
    if _shard_file is None:
        with _shard_lock:
            if _shard_file is None:
                try:
                    os.makedirs(_tracing.trace_dir(), exist_ok=True)
                    _shard_file = open(
                        os.path.join(_tracing.trace_dir(),
                                     f"steps-{os.getpid()}.jsonl"),
                        "a", buffering=1)
                except OSError:
                    return
    try:
        d = rec.as_dict()
        d["pid"] = os.getpid()
        _shard_file.write(json.dumps(d) + "\n")
    except (OSError, TypeError, ValueError):
        pass


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reset_shard_writer)


def collect(path: Optional[str] = None) -> List[Dict[str, Any]]:
    """Merge every process's step-record shard (sorted by ts)."""
    records = []
    for fn in sorted(glob.glob(os.path.join(
            path or _tracing.trace_dir(), "steps-*.jsonl"))):
        try:
            with open(fn) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        records.append(json.loads(line))
        except (OSError, json.JSONDecodeError):
            continue
    records.sort(key=lambda r: r.get("ts", 0))
    return records


def to_chrome(records: List[Dict[str, Any]]) -> List[dict]:
    """Chrome-trace view of step records: one complete event per step on
    the owning process's "train-step" row, plus an MFU counter track."""
    events = []
    for r in records:
        pid = r.get("pid", 0)
        start = r.get("ts", 0.0)
        dur = max(1.0, r.get("total_ms", 0.0) * 1e3)  # ms -> us
        args = {k: r[k] for k in
                ("step", "tokens", "steps_per_call") if k in r}
        for ph in _PHASES:
            if r.get(ph):
                args[ph] = r[ph]
        if r.get("mfu") is not None:
            args["mfu"] = r["mfu"]
        events.append({
            "name": f"step {r.get('step', '?')}", "cat": "train_step",
            "ph": "X", "ts": start * 1e6, "dur": dur,
            "pid": pid, "tid": "train-step", "args": args,
        })
        if r.get("mfu") is not None:
            events.append({
                "name": "MFU", "ph": "C", "ts": start * 1e6,
                "pid": pid, "args": {"mfu": r["mfu"]},
            })
    return events


def format_table(records: List[Dict[str, Any]],
                 last: int = 20) -> str:
    """The last-N step table with MFU and a time-attribution footer."""
    recs = records[-last:]
    if not recs:
        return "no step records (is the training process running with " \
               "the step profiler enabled?)"
    header = (f"{'step':>8} {'total ms':>10} {'dispatch':>9} "
              f"{'device':>9} {'data':>8} {'coll':>8} {'ckpt':>8} "
              f"{'tokens':>9} {'MFU':>7}")
    rows = [header, "-" * len(header)]
    for r in recs:
        mfu = "-" if r.get("mfu") is None else f"{r['mfu']:.4f}"
        rows.append(
            f"{r.get('step', 0):>8} {r.get('total_ms', 0.0):>10.2f} "
            f"{r.get('host_dispatch_ms', 0.0):>9.2f} "
            f"{r.get('device_execute_ms', 0.0):>9.2f} "
            f"{r.get('data_wait_ms', 0.0):>8.2f} "
            f"{r.get('collective_ms', 0.0):>8.2f} "
            f"{r.get('checkpoint_ms', 0.0):>8.2f} "
            f"{r.get('tokens', 0):>9} {mfu:>7}")
    attr = attribution(recs)
    if attr:
        rows.append("")
        rows.append("time attribution: " + "  ".join(
            f"{k}={100 * v:.1f}%" for k, v in attr.items() if v > 0))
    return "\n".join(rows)


# register the scrape-time callback once per process (idempotent: the
# registry keys callbacks by name)
from ray_tpu_torch.util import metrics as _metrics  # noqa: E402

_metrics.DEFAULT_REGISTRY.register_callback("step_profiler", metrics_text)

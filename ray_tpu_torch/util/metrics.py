"""Metrics: Counter/Gauge/Histogram + Prometheus-text export.

The port's own copy of `ray_tpu/util/metrics.py` (the port imports
nothing of the JAX package): one process-local registry backs the metric
objects and scrape-time callbacks (`register_callback`), and renders the
same Prometheus text. `DEFAULT_REGISTRY` here is the port's, separate
from the JAX package's: the port's engine and compile cache register
their callbacks on it. The `/metrics` HTTP endpoint (`serve_metrics`)
comes with the port of the runtime's daemons.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple


class _Registry:
    def __init__(self):
        self._metrics: List["Metric"] = []
        self._callbacks: Dict[str, Any] = {}
        self._lock = threading.Lock()

    def register(self, metric: "Metric"):
        with self._lock:
            self._metrics.append(metric)

    def register_callback(self, name: str, fn) -> None:
        """Scrape-time exposition source: `fn()` returns a chunk of
        Prometheus text (with its own # TYPE lines), computed fresh per
        scrape. Keyed by name so re-registration (module reload, test
        setup) replaces instead of duplicating. This is how subsystems
        with their own cheap counters (compile cache, channel frame
        plane, step profiler) join the registry without constructing
        metric objects on their hot paths."""
        with self._lock:
            self._callbacks[name] = fn

    def prometheus_text(self) -> str:
        # Assembly is all-or-nothing PER SOURCE: a metric or callback
        # that raises mid-render contributes a `# scrape_error` comment
        # instead of a torn chunk (e.g. histogram `_bucket` rows with no
        # `_sum`/`_count`), so one bad source can neither take down the
        # scrape nor corrupt the body for every other source.
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
            callbacks = list(self._callbacks.items())
        for m in metrics:
            try:
                chunk = list(m.samples())
            except Exception as e:  # noqa: BLE001
                lines.append(
                    f'# scrape_error source="{m.name}" '
                    f'error="{type(e).__name__}"')
                continue
            lines.append(f"# HELP {m.name} {m.description}")
            lines.append(f"# TYPE {m.name} {m.prom_type}")
            lines.extend(chunk)
        for name, fn in callbacks:
            try:
                chunk = fn()
            except Exception as e:  # noqa: BLE001
                lines.append(
                    f'# scrape_error source="{name}" '
                    f'error="{type(e).__name__}"')
                continue
            if chunk:
                lines.append(chunk.rstrip("\n"))
        return "\n".join(lines) + "\n"


DEFAULT_REGISTRY = _Registry()


def _escape_label_value(v: str) -> str:
    """Prometheus text-format escaping for label values: backslash,
    double-quote and newline (the spec's three escapes — scrapers break
    on e.g. task names containing quotes otherwise)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(keys: Sequence[str], values: Tuple) -> str:
    if not keys:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"'
        for k, v in zip(keys, values))
    return "{" + inner + "}"


class Metric:
    prom_type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = (),
                 registry: Optional[_Registry] = None):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._values: Dict[Tuple, float] = {}
        self._lock = threading.Lock()
        (registry or DEFAULT_REGISTRY).register(self)

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        tags = tags or {}
        return tuple(str(tags.get(k, "")) for k in self.tag_keys)

    def samples(self) -> List[str]:
        with self._lock:
            items = list(self._values.items())
        return [
            f"{self.name}{_label_str(self.tag_keys, key)} {value}"
            for key, value in items
        ]


class Counter(Metric):
    """Monotonic counter (reference `metrics.py:137`)."""

    prom_type = "counter"

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    """Point-in-time value (reference `metrics.py:262`)."""

    prom_type = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._key(tags)] = float(value)


class Histogram(Metric):
    """Bucketed distribution (reference `metrics.py:187`)."""

    prom_type = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (0.01, 0.1, 1, 10),
                 tag_keys: Sequence[str] = (),
                 registry: Optional[_Registry] = None):
        # Bucket state must exist BEFORE super().__init__ registers this
        # metric: registration publishes the object to the registry, and
        # a concurrent /metrics scrape calls samples() on it immediately.
        self.boundaries = sorted(boundaries)
        self._buckets: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._counts: Dict[Tuple, int] = {}
        super().__init__(name, description, tag_keys, registry)

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            buckets = self._buckets.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            for i, bound in enumerate(self.boundaries):
                if value <= bound:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0) + 1

    def samples(self) -> List[str]:
        out: List[str] = []
        with self._lock:
            items = list(self._buckets.items())
            sums = dict(self._sums)
            counts = dict(self._counts)
        for key, buckets in items:
            cumulative = 0
            for i, bound in enumerate(self.boundaries):
                cumulative += buckets[i]
                labels = dict(zip(self.tag_keys, key))
                labels["le"] = str(bound)
                keys = list(self.tag_keys) + ["le"]
                vals = tuple(labels[k] for k in keys)
                out.append(
                    f"{self.name}_bucket{_label_str(keys, vals)} "
                    f"{cumulative}")
            keys = list(self.tag_keys) + ["le"]
            vals = tuple(list(key) + ["+Inf"])
            out.append(f"{self.name}_bucket{_label_str(keys, vals)} "
                       f"{cumulative + buckets[-1]}")
            out.append(f"{self.name}_sum{_label_str(self.tag_keys, key)} "
                       f"{sums[key]}")
            out.append(
                f"{self.name}_count{_label_str(self.tag_keys, key)} "
                f"{counts[key]}")
        return out

"""Dashboard: REST API + minimal HTML overview of the cluster.

Reference: `dashboard/` (aiohttp head process with pluggable modules;
`state_aggregator.py` backing the state API, `dashboard/client/` React
SPA). The port's copy of `ray_tpu/dashboard.py`: the same 17 routes
(`/` and `/api/{nodes,actors,tasks,objects,task_summary,timeline,
cluster_resources,cluster_load,jobs,events,steps,serve_llm,timeseries,
alerts,requests,recovery}`) with the same JSON and the same HTML page,
served by the port's HTTP server (`_private/http.py`) where the JAX
package runs aiohttp. Heavyweight SPA tooling is out of scope.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Optional

from ray_tpu_torch._private import http

_INDEX_HTML = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title>
<style>
 body { font-family: monospace; margin: 2em; }
 h2 { border-bottom: 1px solid #999; }
 table { border-collapse: collapse; margin-bottom: 1.5em; }
 td, th { border: 1px solid #ccc; padding: 4px 8px; text-align: left; }
</style></head>
<body>
<h1>ray_tpu_torch</h1>
<div id="out">loading…</div>
<script>
// every GCS-sourced string is attacker-influenced (actor/task names
// come from arbitrary cluster clients) — escape before any innerHTML
function esc(v) {
  return String(v).replace(/[&<>"']/g, c => ({'&':'&amp;','<':'&lt;',
    '>':'&gt;','"':'&quot;',"'":'&#39;'}[c]));
}
async function refresh() {
  const [nodes, actors, summary, jobs, res, events, steps, reqs, tsdb] =
    await Promise.all([
    fetch('/api/nodes').then(r => r.json()),
    fetch('/api/actors').then(r => r.json()),
    fetch('/api/task_summary').then(r => r.json()),
    fetch('/api/jobs').then(r => r.json()),
    fetch('/api/cluster_resources').then(r => r.json()),
    fetch('/api/events').then(r => r.json()),
    fetch('/api/steps').then(r => r.json()),
    fetch('/api/requests').then(r => r.json()),
    fetch('/api/timeseries').then(r => r.json()),
  ]);
  let html = '<h2>Cluster</h2><table><tr><th>total</th>' +
             '<th>available</th></tr>' +
             `<tr><td>${esc(JSON.stringify(res.total))}</td>` +
             `<td>${esc(JSON.stringify(res.available))}</td></tr>` +
             '</table>';
  html += '<h2>Nodes</h2><table><tr><th>id</th><th>alive</th>' +
             '<th>resources</th><th>available</th></tr>';
  for (const n of nodes) {
    html += `<tr><td>${esc(n.NodeID.slice(0,12))}</td>` +
            `<td>${esc(n.Alive)}</td>` +
            `<td>${esc(JSON.stringify(n.Resources))}</td>` +
            `<td>${esc(JSON.stringify(n.Available))}</td></tr>`;
  }
  html += '</table><h2>Actors</h2><table><tr><th>id</th><th>name</th>' +
          '<th>class</th><th>state</th><th>restarts</th></tr>';
  for (const a of actors) {
    html += `<tr><td>${esc(a.actor_id.slice(0,12))}</td>` +
            `<td>${esc(a.name||'')}</td>` +
            `<td>${esc(a.class_name)}</td><td>${esc(a.state)}</td>` +
            `<td>${esc(a.num_restarts)}</td></tr>`;
  }
  html += '</table><h2>Tasks</h2><table><tr><th>name</th>' +
          '<th>states</th></tr>';
  for (const [name, states] of Object.entries(summary)) {
    html += `<tr><td>${esc(name)}</td>` +
            `<td>${esc(JSON.stringify(states))}</td></tr>`;
  }
  html += '</table><h2>Jobs</h2><table><tr><th>id</th>' +
          '<th>driver</th><th>state</th><th>runtime</th></tr>';
  for (const jb of jobs) {
    html += `<tr><td>${esc(jb.job_id.slice(0,12))}</td>` +
            `<td>${esc(jb.driver_addr)}</td>` +
            `<td>${jb.finished ? 'FINISHED' : 'RUNNING'}</td>` +
            `<td>${esc(jb.runtime_s ?? '?')}s</td></tr>`;
  }
  html += '</table><h2>Training steps</h2>';
  if (steps.records && steps.records.length) {
    html += '<table><tr><th>step</th><th>total ms</th>' +
            '<th>dispatch</th><th>device</th><th>data</th>' +
            '<th>coll</th><th>ckpt</th><th>MFU</th></tr>';
    for (const s of steps.records.slice(-15).reverse()) {
      const mfu = (s.mfu == null) ? '-' : s.mfu.toFixed(4);
      html += `<tr><td>${esc(s.step)}</td>` +
              `<td>${esc((s.total_ms||0).toFixed(2))}</td>` +
              `<td>${esc((s.host_dispatch_ms||0).toFixed(2))}</td>` +
              `<td>${esc((s.device_execute_ms||0).toFixed(2))}</td>` +
              `<td>${esc((s.data_wait_ms||0).toFixed(2))}</td>` +
              `<td>${esc((s.collective_ms||0).toFixed(2))}</td>` +
              `<td>${esc((s.checkpoint_ms||0).toFixed(2))}</td>` +
              `<td>${esc(mfu)}</td></tr>`;
    }
    html += '</table>';
    const attr = steps.attribution || {};
    const parts = Object.entries(attr).filter(([k, v]) => v > 0)
      .map(([k, v]) => `${esc(k)}=${(100 * v).toFixed(1)}%`);
    if (parts.length) html += `<p>time attribution: ${parts.join('  ')}</p>`;
  } else {
    html += '<p>no step records (train with the step profiler on)</p>';
  }
  html += '<h2>Serve requests</h2>';
  if (reqs.records && reqs.records.length) {
    const s = reqs.summary || {};
    html += `<p>n=${esc(s.n||0)}  total p50/p99=` +
            `${esc(s.total_ms_p50??'-')} / ${esc(s.total_ms_p99??'-')} ms` +
            `  ttft p50=${esc(s.ttft_ms_p50??'-')} ms` +
            `  tpot p50=${esc(s.tpot_ms_p50??'-')} ms</p>`;
    html += '<table><tr><th>req</th><th>deploy</th><th>job</th>' +
            '<th>total ms</th><th>queue</th><th>admit</th>' +
            '<th>prefill</th><th>decode</th><th>ttft</th><th>tpot</th>' +
            '<th>tok</th><th>outcome</th></tr>';
    for (const r of (reqs.slowest || []).slice(0, 10)) {
      const f = v => (v == null) ? '-' : Number(v).toFixed(2);
      html += `<tr><td>${esc((r.req_id||'?').slice(0,8))}</td>` +
              `<td>${esc(r.deployment||'')}</td><td>${esc(r.job||'')}</td>` +
              `<td>${f(r.total_ms)}</td><td>${f(r.queue_ms)}</td>` +
              `<td>${f(r.admission_ms)}</td><td>${f(r.prefill_ms)}</td>` +
              `<td>${f(r.decode_ms)}</td><td>${f(r.ttft_ms)}</td>` +
              `<td>${f(r.tpot_ms)}</td><td>${esc(r.tokens_out||0)}</td>` +
              `<td>${esc(r.outcome||'ok')}</td></tr>`;
    }
    html += '</table>';
  } else {
    html += '<p>no request records (serve traffic with the request ' +
            'recorder on)</p>';
  }
  html += '<h2>Time series</h2>';
  function spark(points) {
    // inline SVG polyline over the series' own min/max
    if (!points || points.length < 2) return '(gathering)';
    const vs = points.map(p => p[1]);
    const lo = Math.min(...vs), hi = Math.max(...vs);
    const w = 160, h = 24, span = (hi - lo) || 1;
    const pts = points.map((p, i) =>
      `${(i / (points.length - 1) * w).toFixed(1)},` +
      `${(h - (p[1] - lo) / span * h).toFixed(1)}`).join(' ');
    return `<svg width="${w}" height="${h}">` +
           `<polyline points="${pts}" fill="none" stroke="#36c" ` +
           `stroke-width="1.5"/></svg>`;
  }
  const sparkRows = (tsdb.series || [])
    .filter(s => !s.name.endsWith('_bucket')).slice(0, 30);
  if (sparkRows.length) {
    html += '<table><tr><th>series</th><th>source</th>' +
            '<th>latest</th><th>trend</th></tr>';
    for (const s of sparkRows) {
      const last = s.points.length ?
        s.points[s.points.length - 1][1] : '-';
      const lbl = Object.entries(s.labels || {})
        .map(([k, v]) => `${k}=${v}`).join(',');
      html += `<tr><td>${esc(s.name)}${lbl ? esc('{'+lbl+'}') : ''}</td>` +
              `<td>${esc(s.source)}</td><td>${esc(last)}</td>` +
              `<td>${spark(s.points)}</td></tr>`;
    }
    html += '</table>';
  } else {
    html += '<p>no series yet (sampler warming up)</p>';
  }
  html += '<h2>Recent events</h2><table><tr><th>time</th>' +
          '<th>severity</th><th>source</th><th>label</th>' +
          '<th>message</th></tr>';
  for (const ev of events.slice(-25).reverse()) {
    const ts = new Date(ev.ts * 1000).toLocaleTimeString();
    html += `<tr><td>${esc(ts)}</td><td>${esc(ev.severity)}</td>` +
            `<td>${esc(ev.source)}</td><td>${esc(ev.label)}</td>` +
            `<td>${esc(ev.message)}</td></tr>`;
  }
  html += '</table>';
  document.getElementById('out').innerHTML = html;
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


class Dashboard:
    """Serves the REST/HTML surface from the connected driver's state
    APIs; runs its HTTP server's loop on a thread (same pattern as the
    Serve proxy)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self._host = host
        self._port = port
        self._started = threading.Event()
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._serve_guarded,
                                        daemon=True, name="dashboard")
        self._thread.start()
        if not self._started.wait(timeout=30):
            raise RuntimeError(
                f"dashboard failed to start on {host}:{port}"
                + (f": {self._error!r}" if self._error else ""))

    def _serve_guarded(self):
        try:
            self._serve()
        except BaseException as e:  # noqa: BLE001 — surfaced in __init__
            self._error = e

    def ready(self):
        return {"host": self._host, "port": self._port}

    def _serve(self):
        import ray_tpu_torch
        from ray_tpu_torch.util import state as state_api
        from ray_tpu_torch.util.timeline import timeline

        def j(fn):
            async def handler(request):
                loop = asyncio.get_event_loop()
                try:
                    data = await loop.run_in_executor(None, fn)
                except Exception as e:  # noqa: BLE001
                    return http.json_response({"error": str(e)},
                                              status=500)
                return http.json_response(data)

            return handler

        def cluster_load():
            from ray_tpu_torch._private.worker_api import _require_state

            cw = _require_state().core_worker
            load = cw._run_sync(cw.gcs.call("get_cluster_load", {}))
            return json.loads(json.dumps(load, default=lambda o: (
                o.hex() if isinstance(o, bytes) else str(o))))

        async def index(request):
            return http.text_response(_INDEX_HTML, content_type="text/html")

        routes = {"/": index}
        routes["/api/nodes"] = j(state_api.list_nodes)
        routes["/api/actors"] = j(state_api.list_actors)
        routes["/api/tasks"] = j(state_api.list_tasks)
        routes["/api/objects"] = j(state_api.list_objects)
        routes["/api/task_summary"] = j(state_api.summarize_tasks)
        routes["/api/timeline"] = j(timeline)
        routes["/api/cluster_resources"] = j(
            lambda: {"total": ray_tpu_torch.cluster_resources(),
                     "available": ray_tpu_torch.available_resources()})
        routes["/api/cluster_load"] = j(cluster_load)

        def jobs_with_runtime():
            # duration computed server-side so browser clock skew can't
            # produce negative runtimes
            now = time.time()
            out = state_api.list_jobs()
            # node-local per-job shm-store accounting (this process is
            # attached to the head node's arena; remote nodes' usage
            # shows on their raylet /metrics)
            try:
                from ray_tpu_torch._private.worker_api import _require_state

                store = _require_state().core_worker.store
            except Exception:  # noqa: BLE001 — no store in this process
                store = None
            live_weights = sum(
                float((jb.get("quotas") or {}).get("weight", 1.0) or 1.0)
                for jb in out if not jb.get("finished"))
            for jb in out:
                start = jb.get("start_time")
                end = jb["end_time"] if jb.get("finished") else now
                jb["runtime_s"] = (round(end - start, 1)
                                   if start is not None else None)
                q = jb.get("quotas") or {}
                w = float(q.get("weight", 1.0) or 1.0)
                jb["weight"] = w
                jb["fair_share"] = (round(w / live_weights, 4)
                                    if live_weights and
                                    not jb.get("finished") else 0.0)
                st = None
                if store is not None:
                    try:
                        st = store.job_stats(bytes.fromhex(jb["job_id"]))
                    except Exception:  # noqa: BLE001 — store detached
                        st = None
                jb["object_store"] = st
            return out

        routes["/api/jobs"] = j(jobs_with_runtime)
        routes["/api/events"] = j(
            lambda: state_api.list_cluster_events()[-200:])

        def steps_panel():
            # flight-recorder plane: merged cross-process step shards
            # (when tracing is on), else this process's in-memory ring
            from ray_tpu_torch.util import step_profiler

            records = step_profiler.collect()
            if not records:
                records = step_profiler.recent()
            records = records[-100:]
            return {"records": records,
                    "attribution": step_profiler.attribution(records),
                    "summary": step_profiler.summary()}

        routes["/api/steps"] = j(steps_panel)

        def serve_llm_panel():
            # inference plane: per-replica queue depth + KV-page
            # occupancy for every serve.llm deployment (empty when no
            # serve controller is running)
            try:
                ctrl = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
                deployments = ray_tpu_torch.get(
                    ctrl.list_deployments.remote(), timeout=10)
            except Exception:  # noqa: BLE001 — serve not started
                return {"deployments": []}
            out = []
            for name in deployments:
                try:
                    info = ray_tpu_torch.get(
                        ctrl.get_replicas.remote(name), timeout=10)
                    rows = [ray_tpu_torch.get(r.get_metrics.remote(),
                                              timeout=10)
                            for r in info["replicas"]]
                except Exception:  # noqa: BLE001 — replica churn
                    continue
                rows = [r for r in rows if "kv_pages_total" in r]
                if rows:
                    entry = {"deployment": name, "replicas": rows}
                    # perf rollups across replicas: prefix-cache hit
                    # rate and mean speculative accept length (absent
                    # unless the engines run with those knobs on)
                    hit_rates = [r["prefix_cache_hit_rate"]
                                 for r in rows
                                 if "prefix_cache_hit_rate" in r]
                    if hit_rates:
                        entry["prefix_cache_hit_rate"] = (
                            sum(hit_rates) / len(hit_rates))
                    accepts = [r["spec_mean_accept"] for r in rows
                               if "spec_mean_accept" in r]
                    if accepts:
                        entry["spec_mean_accept"] = (
                            sum(accepts) / len(accepts))
                    out.append(entry)
            return {"deployments": out}

        routes["/api/serve_llm"] = j(serve_llm_panel)

        # metrics time-series plane: a Sampler owned by the dashboard
        # snapshots the local registry + every reachable daemon's
        # metrics_text on a cadence; /api/timeseries powers the
        # sparkline panels
        from ray_tpu_torch.util import request_recorder
        from ray_tpu_torch.util import tsdb as tsdb_mod

        sampler = tsdb_mod.Sampler().start()
        routes["/api/timeseries"] = j(lambda: sampler.db.snapshot())

        # SLO alert plane: the evaluator rides the sampler's scrape
        # tick (Monarch-style pull evaluation — rules never touch a
        # request path); /api/alerts serves its live snapshot
        from ray_tpu_torch.util import slo as slo_mod

        evaluator = slo_mod.AlertEvaluator(sampler.db).attach(sampler)
        routes["/api/alerts"] = j(evaluator.snapshot)

        def requests_panel():
            # request-path flight recorder: merged cross-process shards
            # (when tracing is on), else this process's in-memory ring
            records = request_recorder.collect()
            if records:
                records = request_recorder.merge_by_request(records)
            else:
                records = [r.as_dict()
                           for r in request_recorder.ring().recent()]
            records = records[-100:]
            return {"records": records,
                    "summary": request_recorder.summary(records),
                    "slowest": request_recorder.slowest(records, 10)}

        routes["/api/requests"] = j(requests_panel)

        def recovery_panel():
            # ownership/recovery plane: this driver's ref-table and
            # reconstruction counters (empty when not connected)
            from ray_tpu_torch._private.object_ref import get_core_worker

            cw = get_core_worker()
            if cw is None or cw.memory_store is None:
                return {"connected": False}
            with cw._ref_lock:
                return {
                    "connected": True,
                    "owned_refs": len(cw._local_refs),
                    "borrowed_refs": len(cw._borrowed_refs),
                    "task_arg_refs": len(cw._task_arg_refs),
                    "borrower_edges": sum(
                        len(v) for v in cw._borrowers.values()),
                    "lineage_bytes": cw._lineage_bytes,
                    "lineage_tasks": len(cw._lineage),
                    "lineage_evictions": cw._stats_lineage_evictions,
                    "reconstructions": cw._stats_reconstructions,
                    "reconstruction_failures":
                        cw._stats_reconstruction_failures,
                    "reconstruction_depth_max":
                        cw._stats_reconstruction_depth_max,
                    "objects_freed": cw._stats_objects_freed,
                }

        routes["/api/recovery"] = j(recovery_panel)

        async def handler(request):
            route = routes.get(request.path)
            if route is None:
                return http.text_response("404: Not Found", status=404)
            if request.method not in ("GET", "HEAD"):
                return http.text_response("405: Method Not Allowed",
                                          status=405)
            return await route(request)

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        loop.run_until_complete(
            http.start_server(handler, self._host, self._port))
        self._started.set()
        loop.run_forever()


def start_dashboard(host: str = "127.0.0.1",
                    port: int = 8265) -> Dashboard:
    """Start the dashboard in this (driver) process. For a long-lived
    cluster service, run `python -m ray_tpu_torch dashboard --address ...` on
    any machine that can reach the GCS."""
    return Dashboard(host, port)

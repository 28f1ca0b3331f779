"""Operator CLI: form real multi-machine clusters and inspect them.

Reference: `python/ray/scripts/scripts.py` (`ray start/stop/status/...`)
and the state-API CLI (`ray list tasks/actors/objects`). Invoked as
`python -m ray_tpu_torch <command>`. The port's copy of
`ray_tpu/scripts/cli.py`, with every verb; its daemons are the port's
(`ray_tpu_torch._private.{gcs,raylet}`), its drivers find the cluster
through `RAY_TPU_TORCH_ADDRESS`, and its sessions and state file live
under `$TMPDIR/ray_tpu_torch` (`/tmp/ray_tpu_torch` by default). A head
started without `--resources` detects its GPUs (`GPU` in its resources).

A head start spawns the GCS + a raylet detached (surviving this CLI);
worker machines join with `start --address`. Daemon pids land in a
state file under the session dir so `stop` can tear the node down.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import uuid

_SESSION_ROOT = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
_DEFAULT_STATE_FILE = os.path.join(_SESSION_ROOT, "cli_node.json")


def _state_file() -> str:
    """Node-state file path. `RAY_TPU_TORCH_CLI_STATE_FILE` overrides the
    machine-global default so concurrent clusters (test isolation, two
    operators on one box) track their own daemons instead of refusing
    to start over each other's state."""
    return os.environ.get("RAY_TPU_TORCH_CLI_STATE_FILE", _DEFAULT_STATE_FILE)


def _spawn_daemon(args, log_path: str, ready_prefix: str) -> tuple:
    """Detached daemon spawn; returns (pid, ready_line). Shares
    node._spawn's env hygiene + ready-wait machinery."""
    from ray_tpu_torch._private.node import _spawn

    try:
        handle = _spawn(args, log_path, ready_prefix, timeout=60.0,
                        detach=True)
    except RuntimeError as e:
        raise SystemExit(str(e))
    return handle.proc.pid, handle.ready_line


def _save_state(state: dict):
    os.makedirs(os.path.dirname(_state_file()), exist_ok=True)
    with open(_state_file(), "w") as f:
        json.dump(state, f)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, PermissionError):
        return False


def _load_state() -> dict | None:
    try:
        with open(_state_file()) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def cmd_start(args):
    prior = _load_state()
    if prior:
        # refuse to orphan a tracked node: overwriting the state file
        # would leave the previous daemons (no parent watch) running
        # with no way to stop them
        alive = [p for p in prior["pids"] if _pid_alive(p)]
        if alive:
            raise SystemExit(
                f"node already running (pids {alive}); "
                "run `ray_tpu_torch stop` first")
    # pid+nonce in the session name: two `start`s in the same second
    # (e.g. parallel test runs) must never share a session dir
    session = (f"{_SESSION_ROOT}/cli_{int(time.time())}_{os.getpid()}_"
               f"{uuid.uuid4().hex[:6]}")
    os.makedirs(os.path.join(session, "logs"), exist_ok=True)
    pids = []
    if args.head:
        gcs_args = [sys.executable, "-m", "ray_tpu_torch._private.gcs",
                    "--host", args.host, "--port", str(args.port),
                    "--daemonize",
                    "--log-file", f"{session}/logs/gcs.log"]
        if args.metrics_port:
            gcs_args += ["--metrics-port", str(args.metrics_port)]
        pid, ready = _spawn_daemon(gcs_args, f"{session}/logs/gcs.out",
                                   "GCS_READY")
        gcs_addr = ready.split()[1]
        pids.append(pid)
        print(f"GCS started at {gcs_addr}")
    else:
        if not args.address:
            raise SystemExit("--address required unless --head")
        gcs_addr = args.address

    raylet_args = [sys.executable, "-m", "ray_tpu_torch._private.raylet",
                   "--gcs-addr", gcs_addr,
                   "--session-dir", session,
                   "--daemonize",
                   "--log-file", f"{session}/logs/raylet.log"]
    if args.resources:
        raylet_args += ["--resources", args.resources]
    if getattr(args, "labels", None):
        raylet_args += ["--labels", args.labels]
    if args.object_store_memory:
        raylet_args += ["--object-store-memory",
                        str(args.object_store_memory)]
    if args.metrics_port and not args.head:
        raylet_args += ["--metrics-port", str(args.metrics_port)]
    pid, ready = _spawn_daemon(raylet_args, f"{session}/logs/raylet.out",
                               "RAYLET_READY")
    pids.append(pid)
    print(f"raylet started: {ready.split()[1]}")
    _save_state({"gcs_addr": gcs_addr, "pids": pids, "session": session})
    print(f"\nTo connect: ray_tpu_torch.init(address={gcs_addr!r})")
    print(f"Or: export RAY_TPU_TORCH_ADDRESS={gcs_addr}")


def cmd_stop(args):
    state = _load_state()
    if state is None:
        print("no tracked node on this machine")
        return
    import signal

    for pid in state["pids"]:
        try:
            os.kill(pid, signal.SIGTERM)
            print(f"stopped pid {pid}")
        except ProcessLookupError:
            pass
    try:
        os.unlink(_state_file())
    except OSError:
        pass


def _connect(args):
    import ray_tpu_torch

    address = args.address or (_load_state() or {}).get("gcs_addr") \
        or os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if not address:
        raise SystemExit("--address required (or run `start --head`)")
    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


def cmd_status(args):
    ray_tpu_torch = _connect(args)
    try:
        nodes = ray_tpu_torch.nodes()
        print(f"{len([n for n in nodes if n['Alive']])} alive node(s)")
        for n in nodes:
            mark = "+" if n["Alive"] else "-"
            print(f" {mark} {n['NodeID'][:12]} {n['RayletAddr']} "
                  f"total={n['Resources']} avail={n['Available']}")
        total = ray_tpu_torch.cluster_resources()
        avail = ray_tpu_torch.available_resources()
        print(f"resources: total={total} available={avail}")
    finally:
        ray_tpu_torch.shutdown()


def cmd_list(args):
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.util import state as state_api

    try:
        fn = {
            "tasks": state_api.list_tasks,
            "actors": state_api.list_actors,
            "objects": state_api.list_objects,
            "nodes": state_api.list_nodes,
        }[args.entity]
        for rec in fn():
            print(json.dumps(rec, default=str))
    finally:
        ray_tpu_torch.shutdown()


def cmd_memory(args):
    """Object-store usage per node + largest objects (reference
    `ray memory`: per-process ref table; here the primary-copy view —
    what each raylet pins in shm and has spilled to disk)."""
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.util import state as state_api

    try:
        objs = state_api.list_objects(limit=args.limit)
        by_node = {}
        for o in objs:
            agg = by_node.setdefault(
                o["node_id"], {"shm": 0, "spilled": 0, "count": 0})
            agg[o["where"]] += o["size"]
            agg["count"] += 1
        for node_id, agg in sorted(by_node.items()):
            print(f"node {node_id[:12]}: {agg['count']} objects, "
                  f"{agg['shm'] / 1e6:.1f} MB shm, "
                  f"{agg['spilled'] / 1e6:.1f} MB spilled")
        print()
        for o in sorted(objs, key=lambda o: -o["size"])[:args.top]:
            print(f"{o['object_id'][:16]} {o['size']:>12} B "
                  f"{o['where']:8} node {o['node_id'][:12]}")
        total = sum(o["size"] for o in objs)
        print(f"\n{len(objs)} primary copies, {total / 1e6:.1f} MB total")
        for s in state_api.store_stats():
            print(f"store {s['node_id'][:12]}: "
                  f"{s.get('allocated', 0) / 1e6:.1f}"
                  f"/{s.get('capacity', 0) / 1e6:.1f} MB shm allocated, "
                  f"{s.get('num_objects', 0)} live objects")
        if len(objs) >= args.limit:
            print(f"WARNING: listing truncated at --limit {args.limit}; "
                  f"totals and top-N understate actual usage")
    finally:
        ray_tpu_torch.shutdown()


def cmd_serve(args):
    """Operator view of a running Serve instance (reference `serve
    status` / `serve shutdown`). Pure observer: connects to the existing
    controller actor by name and never starts one."""
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.serve.controller import CONTROLLER_NAME

    try:
        try:
            ctrl = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        except ValueError:  # actor-not-found; real RPC errors propagate
            print("no serve instance running")
            return
        if args.action == "status":
            deployments = ray_tpu_torch.get(ctrl.list_deployments.remote(),
                                      timeout=30)
            print(json.dumps(deployments, indent=2, default=str))
        elif args.action == "shutdown":
            # direct call so a wedged controller FAILS loudly instead of
            # being swallowed by serve.shutdown()'s best-effort cleanup
            ray_tpu_torch.get(ctrl.shutdown.remote(), timeout=60)
            ray_tpu_torch.kill(ctrl)
            print("serve instance shut down")
    finally:
        ray_tpu_torch.shutdown()


def cmd_serve_deploy(args):
    """Deploy applications from a YAML config (reference `serve deploy`
    + `serve/schema.py`). Unlike cmd_serve this may START the
    controller: deploying a config is a mutating operation."""
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch import serve

    try:
        handles = serve.deploy_config(args.config_file)
        print(f"deployed applications: {', '.join(handles)}")
    finally:
        ray_tpu_torch.shutdown()


def cmd_summary(args):
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.util import state as state_api

    try:
        for name, states in state_api.summarize_tasks().items():
            print(f"{name}: " + ", ".join(
                f"{s}={c}" for s, c in sorted(states.items())))
    finally:
        ray_tpu_torch.shutdown()


def cmd_timeline(args):
    if getattr(args, "unified", False):
        from ray_tpu_torch.util.timeline import unified_timeline

        # --unified without a reachable cluster still merges spans +
        # step records (offline flight-recorder view)
        include_tasks = True
        ray_tpu_torch = None
        try:
            ray_tpu_torch = _connect(args)
        except SystemExit:
            include_tasks = False
        try:
            events = unified_timeline(args.output,
                                      trace_dir=args.trace_dir,
                                      include_tasks=include_tasks)
            kinds = {}
            for e in events:
                k = e.get("cat") or e.get("ph")
                kinds[k] = kinds.get(k, 0) + 1
            print(f"wrote {len(events)} events to {args.output} "
                  "(tasks + spans + step records; open in "
                  "chrome://tracing or ui.perfetto.dev)")
            if kinds:
                print("  " + ", ".join(f"{k}={n}"
                                       for k, n in sorted(kinds.items())))
        finally:
            if ray_tpu_torch is not None:
                ray_tpu_torch.shutdown()
        return
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.util.timeline import timeline

    try:
        events = timeline(args.output)
        print(f"wrote {len(events)} events to {args.output} "
              "(open in chrome://tracing or ui.perfetto.dev)")
    finally:
        ray_tpu_torch.shutdown()


def cmd_profile(args):
    """Flight-recorder view: the last-N step table (per-step MFU +
    time-attribution breakdown). Offline: reads the step-record shards
    the training processes wrote beside the tracing shards — no cluster
    connection needed."""
    from ray_tpu_torch.util import step_profiler

    records = step_profiler.collect(args.trace_dir)
    if not records and step_profiler.recent():
        records = step_profiler.recent()  # in-process fallback
    if getattr(args, "json", False):
        for rec in records[-args.last:]:
            print(json.dumps(rec))
        return
    print(step_profiler.format_table(records, last=args.last))
    if records:
        attribution = step_profiler.attribution(records)
        total_steps = records[-1].get("step", len(records))
        print(f"\n{len(records)} records "
              f"(through step {total_steps}); "
              f"dominant phase: "
              f"{max(attribution, key=attribution.get) if attribution else '?'}")


def cmd_requests(args):
    """Request-path flight recorder, offline: merged client+engine
    records from the `requests-*.jsonl` shards the serving processes
    wrote beside the tracing shards (falls back to this process's
    in-memory ring). `--slow N` keeps the N worst by total latency."""
    from ray_tpu_torch.util import request_recorder

    records = request_recorder.collect(args.trace_dir)
    if records:
        records = request_recorder.merge_by_request(records)
    elif request_recorder.ring().recent():
        records = [r.as_dict()
                   for r in request_recorder.ring().recent()]
    if getattr(args, "slow", 0):
        records = request_recorder.slowest(records, args.slow)
    if getattr(args, "json", False):
        for rec in records:
            print(json.dumps(rec))
        return
    print(request_recorder.format_table(records, last=args.last))


def cmd_top(args):
    """Live serving view: each tick polls the serve controller's
    replicas, folds their counters into a `util.tsdb.TSDB` (alongside a
    local+daemon metrics_text scrape), and renders req/s, TTFT/TPOT
    p50/p99, KV occupancy, and per-job token shares from the stored
    series — counter rates and quantiles come from the time-series
    plane, not from one-shot gauges."""
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.util import tsdb as tsdb_mod

    db = tsdb_mod.TSDB()

    def poll() -> dict:
        """One tick: controller poll -> exposition text -> db.ingest."""
        view = {"deployments": []}
        try:
            ctrl = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
            names = ray_tpu_torch.get(ctrl.list_deployments.remote(),
                                timeout=10)
        except Exception:  # noqa: BLE001 — serve not running
            return view
        lines = []
        for name in names:
            try:
                info = ray_tpu_torch.get(ctrl.get_replicas.remote(name),
                                   timeout=10)
                rows = [ray_tpu_torch.get(r.get_metrics.remote(), timeout=10)
                        for r in info["replicas"]]
            except Exception:  # noqa: BLE001 — replica churn mid-poll
                continue
            dep = {"deployment": name, "replicas": rows}
            view["deployments"].append(dep)
            done = sum(r.get("requests_completed", 0) for r in rows)
            toks = sum(r.get("tokens_generated", 0) for r in rows)
            live = sum(r.get("kv_pages_live", 0) for r in rows)
            total = sum(r.get("kv_pages_total", 0) for r in rows)
            lines.append(f'serve_top_requests_completed_total'
                         f'{{deployment="{name}"}} {done}')
            lines.append(f'serve_top_tokens_generated_total'
                         f'{{deployment="{name}"}} {toks}')
            lines.append(f'serve_top_kv_pages_live'
                         f'{{deployment="{name}"}} {live}')
            lines.append(f'serve_top_kv_pages_total'
                         f'{{deployment="{name}"}} {total}')
            jobs: dict = {}
            for r in rows:
                for job, row in (r.get("tenants") or {}).items():
                    jobs[job] = jobs.get(job, 0) + row.get(
                        "tokens_generated", 0)
            for job, n in jobs.items():
                lines.append(f'serve_top_tokens_generated_total'
                             f'{{deployment="{name}",job="{job}"}} {n}')
        if lines:
            db.ingest("\n".join(lines) + "\n", source="serve")
        tsdb_mod.scrape_once(db)
        return view

    def render(view: dict) -> str:
        out = []
        if db.scrape_errors:
            # a metrics callback somewhere is throwing — the table below
            # is missing that source's series, say so up front
            out.append("DEGRADED (source="
                       + ", ".join(sorted(db.scrape_errors)) + "): "
                       + " | ".join(db.scrape_errors[s]
                                    for s in sorted(db.scrape_errors)))
        for dep in view["deployments"]:
            name = dep["deployment"]
            rows = dep["replicas"]
            # counter rates from the series plane (deltas over the
            # trailing window, robust to replica restarts)
            req_s = db.rate("serve_top_requests_completed_total",
                            {"deployment": name}, source="serve")
            tok_s = db.rate("serve_top_tokens_generated_total",
                            {"deployment": name}, source="serve")
            live = db.latest("serve_top_kv_pages_live",
                             {"deployment": name}, source="serve") or 0
            total = db.latest("serve_top_kv_pages_total",
                              {"deployment": name}, source="serve") or 0
            out.append(f"deployment {name}: {len(rows)} replicas   "
                       f"req/s={req_s if req_s is None else round(req_s, 2)}"
                       f"   tok/s={tok_s if tok_s is None else round(tok_s, 1)}"
                       f"   kv={int(live)}/{int(total)} pages"
                       + (f" ({100 * live / total:.0f}%)"
                          if total else ""))
            # latency: per-replica request-recorder summaries (avg p50,
            # worst p99 — quantiles don't merge exactly across rings)
            sums = [r["request_summary"] for r in rows
                    if r.get("request_summary")]
            for key, label in (("ttft_ms", "ttft"), ("tpot_ms", "tpot"),
                               ("total_ms", "total")):
                p50s = [s[f"{key}_p50"] for s in sums
                        if s.get(f"{key}_p50") is not None]
                p99s = [s[f"{key}_p99"] for s in sums
                        if s.get(f"{key}_p99") is not None]
                if p50s:
                    out.append(
                        f"  {label:6} p50={sum(p50s) / len(p50s):8.2f} ms"
                        f"   p99<={max(p99s):8.2f} ms")
            queue = sum(r.get("queue_depth", 0) for r in rows)
            running = sum(r.get("running", 0) for r in rows)
            out.append(f"  queue={int(queue)}  running={int(running)}")
            # per-job shares of generated tokens (multi-tenant view)
            shares = {}
            for key in db.series():
                n, litems, src = key
                ld = dict(litems)
                if (n == "serve_top_tokens_generated_total"
                        and src == "serve" and "job" in ld
                        and ld.get("deployment") == name):
                    r = db.rate(n, ld, source="serve")
                    if r:
                        shares[ld["job"]] = r
            tot = sum(shares.values())
            if tot > 0:
                out.append("  job shares: " + "  ".join(
                    f"{job}={100 * r / tot:.0f}%"
                    for job, r in sorted(shares.items())))
        if not view["deployments"]:
            out.append("no serve deployments (serve.run something)")
        out.append(f"[series={len(db.series())} "
                   f"scrapes={db.scrapes}]")
        return "\n".join(out)

    import time as time_mod
    try:
        i = 0
        while args.iterations is None or i < args.iterations:
            view = poll()
            if args.iterations is None \
                    and not getattr(args, "no_clear", False):
                print("\x1b[2J\x1b[H", end="")  # refresh in place
            print(render(view))
            i += 1
            if args.iterations is None or i < args.iterations:
                time_mod.sleep(args.interval)
    except KeyboardInterrupt:
        print()  # drop the shell prompt below the ^C echo
    finally:
        try:
            ray_tpu_torch.shutdown()
        except KeyboardInterrupt:
            pass  # second ^C mid-teardown: exit quietly anyway


def cmd_alerts(args):
    """Evaluate the SLO alert pack against a short live scrape window
    and print every rule's state (the CLI face of `util.slo`; the
    dashboard serves the same snapshot at /api/alerts). Scrapes a few
    ticks so windowed measurements (rates, quantiles) have deltas to
    work with, then lists recent alert/health transitions from the
    structured event log."""
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.util import slo as slo_mod
    from ray_tpu_torch.util import tsdb as tsdb_mod

    try:
        db = tsdb_mod.TSDB()
        evaluator = slo_mod.AlertEvaluator(db, register_metrics=False)
        ticks = max(2, args.scrapes)
        for i in range(ticks):
            tsdb_mod.scrape_once(db)
            evaluator.evaluate()
            if i + 1 < ticks:
                time.sleep(args.interval)
        snap = evaluator.snapshot()
        if args.json:
            print(json.dumps(snap, indent=2))
            return
        if db.scrape_errors:
            print("DEGRADED (source="
                  + ", ".join(sorted(db.scrape_errors)) + ")")
        for a in snap["alerts"]:
            mark = {"firing": "!", "pending": "~"}.get(a["state"], " ")
            fast = ("-" if a["fast_value"] is None
                    else f"{a['fast_value']:.4g}")
            slow = ("-" if a["slow_value"] is None
                    else f"{a['slow_value']:.4g}")
            print(f" {mark} {a['rule']:24} {a['state']:7} "
                  f"{a['metric']} {a['op']} {a['threshold']:g}   "
                  f"fast={fast} slow={slow}")
        firing = snap["firing"]
        print(f"{len(firing)} firing"
              + (": " + ", ".join(firing) if firing else "")
              + f"   ({len(snap['alerts'])} rules, "
                f"{snap['evaluations']} evaluations)")
        if args.history:
            from ray_tpu_torch.util.events import list_events

            import datetime

            wanted = ("ALERT_FIRING", "ALERT_RESOLVED",
                      "health.stalled", "health.recovered")
            evs = [e for e in list_events()
                   if e.get("label") in wanted][-args.history:]
            for ev in evs:
                ts = datetime.datetime.fromtimestamp(
                    ev["ts"]).strftime("%H:%M:%S")
                print(f"  {ts} [{ev['severity']:7}] "
                      f"{ev['label']:15} {ev['message']}")
    finally:
        ray_tpu_torch.shutdown()


def cmd_stack(args):
    """Cluster-wide hang diagnosis (reference: `ray stack`): pull the
    `dump_stacks` RPC from the GCS and every raylet — fanned out to
    each node's workers with --all — plus this CLI process, and render
    one annotated report: per-thread stacks, held tracked locks when
    lockdep is armed, and [STALLED] marks on threads the deadman
    watchdog has flagged."""
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch._private import health as health_mod
    from ray_tpu_torch._private import worker_api

    try:
        cw = worker_api._global_state.core_worker
        nodes = [n for n in ray_tpu_torch.nodes() if n["Alive"]]
        if args.node:
            nodes = [n for n in nodes
                     if n["NodeID"].startswith(args.node)]
            if not nodes:
                raise SystemExit(f"no alive node matching {args.node!r}")

        async def collect():
            reports = []
            if not args.node:
                try:
                    reports.append(await cw.gcs.call(
                        "dump_stacks", {}, timeout=10.0))
                except Exception as e:  # noqa: BLE001 — partial report
                    reports.append({"role": "gcs", "error":
                                    f"{type(e).__name__}: {e}"})
            for n in nodes:
                try:
                    raylet = await cw._clients.get(n["RayletAddr"])
                    reports.append(await raylet.call(
                        "dump_stacks", {"workers": bool(args.all)},
                        timeout=15.0))
                except Exception as e:  # noqa: BLE001
                    reports.append({"role": "raylet",
                                    "node_id": n["NodeID"], "error":
                                    f"{type(e).__name__}: {e}"})
            return reports

        reports = cw._run_sync(collect())
        # this process too — a hang report that can't see the observer
        # is one process short of the truth
        reports.append({"pid": os.getpid(), "role": "cli",
                        "threads": health_mod.dump_stacks()})
        flat = []
        for rep in reports:
            workers = rep.pop("workers", None) if isinstance(rep, dict) \
                else None
            flat.append(rep)
            flat.extend(workers or [])
        if args.json:
            print(json.dumps(flat, indent=2))
            return
        stalled = 0
        for rep in flat:
            who = rep.get("role", "?")
            if rep.get("node_id"):
                who += f" node={rep['node_id'][:12]}"
            if rep.get("worker_id"):
                who += f" worker={rep['worker_id'][:12]}"
            if rep.get("error"):
                print(f"==== {who} pid={rep.get('pid', '?')} "
                      f"UNREACHABLE: {rep['error']} ====")
                continue
            threads = rep.get("threads", [])
            print(f"==== {who} pid={rep['pid']} "
                  f"({len(threads)} threads) ====")
            for t in threads:
                marks = ""
                if t.get("loop"):
                    marks += f" [loop={t['loop']}]"
                if t.get("stalled"):
                    marks += " [STALLED]"
                    stalled += 1
                if t.get("held_locks"):
                    marks += " [holds: " + ", ".join(
                        t["held_locks"]) + "]"
                print(f"-- {t['name']} (ident={t['ident']}, "
                      f"daemon={t['daemon']}){marks}")
                print("  " + t["stack"].rstrip().replace("\n", "\n  "))
        procs = len([r for r in flat if not r.get("error")])
        print(f"[{procs} processes, "
              f"{sum(len(r.get('threads', [])) for r in flat)} threads"
              + (f", {stalled} STALLED" if stalled else "") + "]")
    finally:
        ray_tpu_torch.shutdown()


def cmd_client_server(args):
    import sys as _sys

    _sys.argv = ["client-server", "--address", args.address,
                 "--host", args.host, "--port", str(args.port)]
    from ray_tpu_torch.util.client.server import main as server_main

    server_main()


def cmd_events(args):
    # offline read of the structured event shards — no cluster needed
    from ray_tpu_torch.util.events import export_otlp, list_events

    if getattr(args, "otlp", None):
        n = export_otlp(args.otlp, source=args.source,
                        severity=args.severity, label=args.label)
        print(f"wrote {n} OTLP log records to {args.otlp}")
        return
    evs = list_events(source=args.source, severity=args.severity,
                      label=args.label)
    for ev in evs[-args.limit:]:
        import datetime

        ts = datetime.datetime.fromtimestamp(ev["ts"]).strftime(
            "%H:%M:%S")
        print(f"{ts} [{ev['severity']:7}] {ev['source']:11} "
              f"{ev['label']:18} {ev['message']}")
    print(f"({len(evs)} events total)")


def cmd_trace(args):
    # offline merge of per-process span shards — no cluster needed
    from ray_tpu_torch.util import tracing

    spans = tracing.collect(args.trace_dir)
    tracing.to_chrome(spans, args.output)
    print(f"merged {len(spans)} spans from {args.trace_dir or tracing.trace_dir()} "
          f"-> {args.output} (open in chrome://tracing)")


def cmd_dashboard(args):
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.dashboard import start_dashboard

    try:
        start_dashboard(port=args.port)
        # flushed: a service manager or a script waits for this line on
        # a pipe while the verb runs on
        print(f"dashboard at http://127.0.0.1:{args.port} (ctrl-c to stop)",
              flush=True)
        import signal

        signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        ray_tpu_torch.shutdown()


def cmd_job(args):
    """`ray_tpu_torch job submit|status|logs|stop|list` (reference:
    dashboard/modules/job/cli.py)."""
    ray_tpu_torch = _connect(args)
    from ray_tpu_torch.job_submission import JobSubmissionClient

    try:
        client = JobSubmissionClient()
        if args.job_command == "submit":
            job_id = client.submit_job(
                entrypoint=" ".join(args.entrypoint))
            print(job_id)
            if args.wait:
                print(client.wait_until_finished(job_id))
                print(client.get_job_logs(job_id), end="")
        elif args.job_command == "status":
            print(client.get_job_status(args.job_id))
        elif args.job_command == "logs":
            print(client.get_job_logs(args.job_id), end="")
        elif args.job_command == "stop":
            print("stopped" if client.stop_job(args.job_id)
                  else "already finished")
        elif args.job_command == "list":
            for rec in client.list_jobs():
                print(json.dumps(rec))
    finally:
        ray_tpu_torch.shutdown()


def cmd_submit(args):
    address = args.address or (_load_state() or {}).get("gcs_addr") \
        or os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if not address:
        raise SystemExit("--address required")
    env = dict(os.environ)
    env["RAY_TPU_TORCH_ADDRESS"] = address
    cmd = [sys.executable, args.script] + args.script_args
    raise SystemExit(subprocess.call(cmd, env=env))


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch cluster operator CLI")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("start", help="start node daemons")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", help="GCS address to join (worker node)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=6379)
    p.add_argument("--resources", help="JSON resources override")
    p.add_argument("--labels", help="JSON node labels (e.g. the "
                   "autoscaler's instance label at a host's bootstrap)")
    p.add_argument("--object-store-memory", type=int, default=0)
    p.add_argument("--metrics-port", type=int, default=0)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop this machine's daemons")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser("status", help="cluster nodes + resources")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("list", help="list cluster entities")
    p.add_argument("entity",
                   choices=["tasks", "actors", "objects", "nodes"])
    p.add_argument("--address")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("memory",
                       help="object-store usage per node + largest objects")
    p.add_argument("--address")
    p.add_argument("--limit", type=int, default=10000)
    p.add_argument("--top", type=int, default=10)
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("serve", help="observe/stop a Serve instance")
    p.add_argument("action", choices=["status", "shutdown"])
    p.add_argument("--address")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("serve-deploy",
                       help="deploy applications from a YAML config")
    p.add_argument("config_file")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_serve_deploy)

    p = sub.add_parser("summary", help="task summary by name/state")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("submit", help="run a driver script locally")
    p.add_argument("--address")
    p.add_argument("script")
    p.add_argument("script_args", nargs="*")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser("timeline", help="dump a Chrome trace of tasks")
    p.add_argument("--address")
    p.add_argument("--output", default="timeline.json")
    p.add_argument("--unified", action="store_true",
                   help="merge task events + tracing spans + per-step "
                        "records into one trace")
    p.add_argument("--trace-dir", default=None,
                   help="span/step shard dir (default: "
                        "RAY_TPU_TRACE_DIR)")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser(
        "profile",
        help="per-step training telemetry: MFU + time attribution")
    p.add_argument("--trace-dir", default=None,
                   help="step-record shard dir (default: "
                        "RAY_TPU_TRACE_DIR)")
    p.add_argument("--last", type=int, default=20,
                   help="rows to print (default 20)")
    p.add_argument("--json", action="store_true",
                   help="raw JSONL records instead of the table")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser(
        "requests",
        help="per-request serving telemetry: phase split + TTFT/TPOT")
    p.add_argument("--trace-dir", default=None,
                   help="request-record shard dir (default: "
                        "RAY_TPU_TRACE_DIR)")
    p.add_argument("--slow", type=int, default=0, metavar="N",
                   help="only the N slowest requests by total latency")
    p.add_argument("--last", type=int, default=20,
                   help="rows to print (default 20)")
    p.add_argument("--json", action="store_true",
                   help="raw JSONL records instead of the table")
    p.set_defaults(fn=cmd_requests)

    p = sub.add_parser(
        "top",
        help="live serving table: req/s, TTFT/TPOT, KV occupancy, "
             "per-job shares")
    p.add_argument("--address")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between refreshes (default 2)")
    p.add_argument("--iterations", type=int, default=None,
                   help="stop after N refreshes (default: until ^C)")
    p.add_argument("--no-clear", action="store_true",
                   help="append output instead of redrawing the screen")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser(
        "alerts",
        help="evaluate the SLO alert rules over a live scrape window")
    p.add_argument("--address")
    p.add_argument("--scrapes", type=int, default=3,
                   help="scrape ticks to evaluate over (default 3)")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between scrape ticks (default 2)")
    p.add_argument("--history", type=int, default=10,
                   help="recent alert/health events to list (0=none)")
    p.add_argument("--json", action="store_true",
                   help="raw evaluator snapshot instead of the table")
    p.set_defaults(fn=cmd_alerts)

    p = sub.add_parser(
        "stack",
        help="cluster-wide Python stack dump (hang diagnosis)")
    p.add_argument("--address")
    p.add_argument("--node", metavar="N",
                   help="only the node whose NodeID starts with N")
    p.add_argument("--all", action="store_true",
                   help="also fan out to every worker process per node")
    p.add_argument("--json", action="store_true",
                   help="raw per-process reports instead of the report")
    p.set_defaults(fn=cmd_stack)

    p = sub.add_parser(
        "client-server",
        help="serve remote 'client://' drivers against this cluster")
    p.add_argument("--address", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10001)
    p.set_defaults(fn=cmd_client_server)

    p = sub.add_parser("events", help="list structured cluster events")
    p.add_argument("--source")
    p.add_argument("--severity")
    p.add_argument("--label")
    p.add_argument("--limit", type=int, default=100)
    p.add_argument("--otlp", metavar="FILE",
                   help="export as an OTLP/JSON Logs payload instead")
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser("trace",
                       help="merge tracing spans into a Chrome trace")
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--output", default="trace.json")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser("dashboard", help="serve the web dashboard")
    p.add_argument("--address")
    p.add_argument("--port", type=int, default=8265)
    p.set_defaults(fn=cmd_dashboard)

    p = sub.add_parser("job", help="cluster-hosted jobs")
    p.add_argument("job_command",
                   choices=["submit", "status", "logs", "stop", "list"])
    p.add_argument("--address")
    p.add_argument("--job-id", default=None)
    p.add_argument("--wait", action="store_true")
    p.add_argument("entrypoint", nargs="*",
                   help="entrypoint command (submit)")
    p.set_defaults(fn=cmd_job)

    args = parser.parse_args(argv)
    try:
        args.fn(args)
    except KeyboardInterrupt:
        # operator ^C is a normal way to leave any live view — exit
        # with the conventional 130, never a traceback
        raise SystemExit(130)


if __name__ == "__main__":
    main()

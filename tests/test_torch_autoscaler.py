"""The port's autoscaler (`ray_tpu_torch.autoscaler`) held to the JAX
package's: the scenarios of `tests/test_autoscaler.py`, each run as one
script against both packages in two subprocesses at once (each with its
own cluster), whose decisions must be equal — scale up for pending tasks
and for an infeasible placement group, a whole slice for a topology
group, scale down when idle, the `max_workers` cap, the boot timeout, a
broken slice replaced, no double launch from concurrent updates, and
the queued-resource provider against a fake API. Then, in this process,
both reconcilers are fed the same synthetic `get_cluster_load`
snapshots and must plan the same launches and terminations, and the
staleness re-check before provisioning is pinned on both.

A slice is the port's GPU slice: where the JAX script asks for `"TPU"`
chips the port's asks for `"GPU"`s, and the fake queued-resource API
boots hosts through each package's `Cluster.add_slice`.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("ray_tpu", "ray_tpu_torch")

SCENARIO_SCRIPT = r'''
import importlib, json, re, sys, threading, time
pkg, scenario = sys.argv[1], sys.argv[2]
rt = importlib.import_module(pkg)
Cluster = importlib.import_module(pkg + "._private.node").Cluster
asc = importlib.import_module(pkg + ".autoscaler")
Autoscaler, NodeType = asc.Autoscaler, asc.NodeType
ACC = "GPU" if pkg == "ray_tpu_torch" else "TPU"
PER_HOST = "gpus_per_host" if pkg == "ray_tpu_torch" else "chips_per_host"


class FakeQueuedResourceAPI:
    """The recorded queued-resources API of tests/test_autoscaler.py:
    `tick()` turns ACCEPTED slices ACTIVE and boots their hosts as local
    raylets carrying the bootstrap script's instance label."""

    def __init__(self, cluster):
        self._cluster = cluster
        self._qrs = {}
        self._handles = {}

    def request(self, method, url, body=None):
        if method == "POST":
            name = re.search(r"queuedResourceId=([\w-]+)", url).group(1)
            script = body["tpu"]["nodeSpec"][0]["node"]["metadata"][
                "startup-script"]
            assert "autoscaler_instance" in script
            assert self._cluster.gcs_addr in script
            assert f"python -m {pkg}.scripts.cli start" in script
            self._qrs[name] = {"state": "ACCEPTED", "body": body}
            return {"name": name}
        if method == "GET":
            return {"queuedResources": [
                {"name": f"projects/p/locations/z/queuedResources/{n}",
                 "state": {"state": qr["state"]},
                 "tpu": qr["body"]["tpu"]}
                for n, qr in self._qrs.items()
                if qr["state"] != "DELETED"]}
        if method == "DELETE":
            name = url.rsplit("/", 1)[-1].split("?")[0]
            qr = self._qrs.get(name)
            if qr:
                qr["state"] = "DELETED"
                for h in self._handles.pop(name, []):
                    if h in self._cluster.nodes:
                        self._cluster.remove_node(h)
            return {}
        raise AssertionError(f"unexpected {method} {url}")

    def tick(self):
        for name, qr in self._qrs.items():
            if qr["state"] != "ACCEPTED":
                continue
            node = qr["body"]["tpu"]["nodeSpec"][0]["node"]
            accel = node["acceleratorType"]
            hosts = max(1, int(accel.rsplit("-", 1)[1]) // 4)
            self._handles[name] = self._cluster.add_slice(
                accel, hosts, cpus_per_host=4.0, name=name,
                extra_labels={"autoscaler_instance": name},
                **{PER_HOST: 4})
            qr["state"] = "ACTIVE"


def drain(seconds=1.5):
    time.sleep(seconds)


def slice_type():
    return NodeType("v5e16", {"CPU": 4.0, ACC: 4.0},
                    slice_type="v5e-16", num_hosts=4)


def infeasible_pg(cluster, provider, out):
    a = Autoscaler(cluster.gcs_addr, provider,
                   [NodeType("cpu4", {"CPU": 4.0})],
                   max_workers=4, idle_timeout_s=9999)
    pg = rt.placement_group([{"CPU": 4.0}], strategy="PACK")
    out["ready_before"] = pg.ready(timeout=2.0)
    drain()
    out["update"] = a.update()
    out["ready_after"] = pg.ready(timeout=30.0)
    rt.remove_placement_group(pg)


def pending_tasks(cluster, provider, out):
    a = Autoscaler(cluster.gcs_addr, provider,
                   [NodeType("cpu2", {"CPU": 2.0}),
                    NodeType("cpu8", {"CPU": 8.0})],
                   max_workers=4, idle_timeout_s=9999)

    @rt.remote(num_cpus=2)
    def work(i):
        return i * 2

    refs = [work.remote(i) for i in range(3)]
    drain()
    a.update()
    out["types"] = sorted({i.node_type
                           for i in provider.non_terminated_nodes()})
    out["values"] = sorted(rt.get(refs, timeout=60))


def slice_for_topology_pg(cluster, provider, out):
    a = Autoscaler(cluster.gcs_addr, provider,
                   [NodeType("v2-8", {"CPU": 2.0, ACC: 4.0},
                             slice_type="v2-8", num_hosts=2)],
                   max_workers=8, idle_timeout_s=9999)
    pg = rt.placement_group([{"CPU": 1.0, ACC: 4.0}] * 2,
                            topology="v2-8")
    out["ready_before"] = pg.ready(timeout=2.0)
    drain()
    out["update"] = a.update()
    out["ready_after"] = pg.ready(timeout=30.0)
    rt.remove_placement_group(pg)


def scale_down_idle(cluster, provider, out):
    a = Autoscaler(cluster.gcs_addr, provider,
                   [NodeType("cpu4", {"CPU": 4.0})],
                   max_workers=4, idle_timeout_s=2.0)

    @rt.remote(num_cpus=4)
    def burst():
        return "done"

    ref = burst.remote()
    drain()
    a.update()
    out["launched_nodes"] = len(provider.non_terminated_nodes())
    out["value"] = rt.get(ref, timeout=60)
    deadline = time.monotonic() + 30
    out["terminated"] = 0
    while time.monotonic() < deadline:
        time.sleep(1.0)
        result = a.update()
        if result["terminated"] and not provider.non_terminated_nodes():
            out["terminated"] = result["terminated"]
            break
    out["left"] = len(provider.non_terminated_nodes())


def max_workers_cap(cluster, provider, out):
    a = Autoscaler(cluster.gcs_addr, provider,
                   [NodeType("cpu2", {"CPU": 2.0})],
                   max_workers=2, idle_timeout_s=9999)

    @rt.remote(num_cpus=2)
    def work(i):
        time.sleep(0.2)
        return i

    refs = [work.remote(i) for i in range(8)]
    drain()
    a.update()
    a.update()
    out["nodes"] = len(provider.non_terminated_nodes())
    out["values"] = sorted(rt.get(refs, timeout=120))


def queued_slice_up_and_down(cluster, provider, out):
    api = FakeQueuedResourceAPI(cluster)
    qp = asc.TPUQueuedResourceProvider(
        "proj", "us-central2-b", cluster.gcs_addr, transport=api)
    a = Autoscaler(cluster.gcs_addr, qp, [slice_type()],
                   max_workers=8, idle_timeout_s=2.0)
    pg = rt.placement_group([{ACC: 4.0}] * 4, strategy="STRICT_SPREAD",
                            topology="v5e-16")
    out["ready_before"] = pg.ready(timeout=2.0)
    drain()
    out["first"] = a.update()
    drain()
    out["while_booting"] = a.update()
    api.tick()
    out["ready_after"] = pg.ready(timeout=30.0)
    rt.remove_placement_group(pg)
    deadline = time.monotonic() + 40
    out["terminated"] = 0
    while time.monotonic() < deadline:
        drain()
        out["terminated"] = a.update()["terminated"]
        if out["terminated"]:
            break
    out["left"] = len(qp.non_terminated_nodes())


def queued_recovers_type_mapping(cluster, provider, out):
    api = FakeQueuedResourceAPI(cluster)
    p1 = asc.TPUQueuedResourceProvider("proj", "z", cluster.gcs_addr,
                                       transport=api)
    inst = p1.create_node(slice_type())
    p2 = asc.TPUQueuedResourceProvider("proj", "z", cluster.gcs_addr,
                                       transport=api)
    found = p2.non_terminated_nodes()
    out["same_instance"] = [i.instance_id for i in found] == \
        [inst.instance_id]
    out["types"] = [i.node_type for i in found]
    p2.terminate_node(found[0])
    out["left"] = len(p2.non_terminated_nodes())


def replaces_broken_slice(cluster, provider, out):
    api = FakeQueuedResourceAPI(cluster)
    qp = asc.TPUQueuedResourceProvider("proj", "z", cluster.gcs_addr,
                                       transport=api)
    a = Autoscaler(cluster.gcs_addr, qp, [slice_type()],
                   max_workers=16, idle_timeout_s=9999)
    inst = qp.create_node(a.node_types["v5e16"])
    api.tick()
    drain()
    a.update()
    name = inst.instance_id
    victim = api._handles[name][0]
    cluster.remove_node(victim)
    api._handles[name] = api._handles[name][1:]
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        drain()
        a.update()
        if not qp.non_terminated_nodes():
            break
    out["left"] = len(qp.non_terminated_nodes())
    out["state"] = api._qrs[name]["state"]


def boot_timeout(cluster, provider, out):
    api = FakeQueuedResourceAPI(cluster)
    qp = asc.TPUQueuedResourceProvider("proj", "z", cluster.gcs_addr,
                                       transport=api)
    a = Autoscaler(cluster.gcs_addr, qp, [slice_type()],
                   max_workers=16, idle_timeout_s=9999, boot_timeout_s=1.0)
    inst = qp.create_node(a.node_types["v5e16"])
    drain()
    a.update()
    time.sleep(1.2)
    a.update()
    out["left"] = len(qp.non_terminated_nodes())
    out["state"] = api._qrs[inst.instance_id]["state"]


def concurrent_updates(cluster, provider, out):
    a = Autoscaler(cluster.gcs_addr, provider,
                   [NodeType("cpu4", {"CPU": 4.0})],
                   max_workers=4, idle_timeout_s=9999)
    pg = rt.placement_group([{"CPU": 4.0}], strategy="PACK")
    out["ready_before"] = pg.ready(timeout=2.0)
    drain()
    results = []
    threads = [threading.Thread(target=lambda: results.append(a.update()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    out["launched"] = sum(r["launched"] for r in results)
    out["nodes"] = len(provider.non_terminated_nodes())
    out["ready_after"] = pg.ready(timeout=30.0)
    rt.remove_placement_group(pg)


cluster = Cluster(head_resources={"CPU": 1.0},
                  object_store_memory=64 * 1024 * 1024)
out = {}
try:
    rt.init(address=cluster.gcs_addr)
    provider = asc.FakeMultiNodeProvider(cluster)
    globals()[scenario](cluster, provider, out)
finally:
    rt.shutdown()
    cluster.shutdown()
print(json.dumps(out, sort_keys=True))
'''

# scenario -> what the JAX package decides (the port must decide the same)
EXPECTED = {
    "infeasible_pg": {"ready_before": False, "ready_after": True,
                      "update": {"launched": 1, "terminated": 0}},
    "pending_tasks": {"types": ["cpu2"], "values": [0, 2, 4]},
    "slice_for_topology_pg": {"ready_before": False, "ready_after": True,
                              "update": {"launched": 2, "terminated": 0}},
    "scale_down_idle": {"launched_nodes": 1, "value": "done",
                        "terminated": 1, "left": 0},
    "max_workers_cap": {"nodes": 2, "values": list(range(8))},
    "queued_slice_up_and_down": {
        "ready_before": False, "ready_after": True,
        "first": {"launched": 4, "terminated": 0},
        "while_booting": {"launched": 0, "terminated": 0},
        "terminated": 4, "left": 0},
    "queued_recovers_type_mapping": {"same_instance": True,
                                     "types": ["v5e16"], "left": 0},
    "replaces_broken_slice": {"left": 0, "state": "DELETED"},
    "boot_timeout": {"left": 0, "state": "DELETED"},
    "concurrent_updates": {"ready_before": False, "launched": 1,
                           "nodes": 1, "ready_after": True},
}


def _run_on_both(scenario: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", SCENARIO_SCRIPT, pkg, scenario], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg in PACKAGES}
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    return results


@pytest.mark.parametrize("scenario", sorted(EXPECTED))
def test_scenario_decides_as_the_jax_package(scenario):
    results = _run_on_both(scenario)
    assert results["ray_tpu"] == EXPECTED[scenario]
    assert results["ray_tpu_torch"] == results["ray_tpu"]


# ---------------------------------------------------------------------------
# the reconcilers on the same synthetic snapshot, in this process
# ---------------------------------------------------------------------------


class _StubProvider:
    """In-memory NodeProvider of `pkg` that records every call."""

    def __init__(self, pkg: str, instances=()):
        self._Instance = importlib.import_module(
            pkg + ".autoscaler.node_provider").Instance
        self._instances = {}
        self._n = 0
        self.created, self.terminated = [], []
        for iid, ntype, node_ids in instances:
            self._instances[iid] = self._Instance(iid, ntype, list(node_ids))

    def create_node(self, node_type):
        self._n += 1
        inst = self._Instance(f"stub-{self._n}", node_type.name, [])
        self._instances[inst.instance_id] = inst
        self.created.append(node_type.name)
        return inst

    def terminate_node(self, instance):
        self._instances.pop(instance.instance_id, None)
        self.terminated.append(instance.instance_id)

    def non_terminated_nodes(self):
        return list(self._instances.values())


def _node(nid: str, avail: dict, idle_s: float = 0.0, labels=None):
    return {"node_id": bytes.fromhex(nid), "total": dict(avail),
            "available": dict(avail), "labels": labels or {},
            "idle_duration_s": idle_s}


GPU_SLICE = {"CPU": 2.0, "GPU": 4.0}

# (node types, provider instances, load snapshot): the same snapshot goes
# to both reconcilers
SNAPSHOTS = {
    "pending_tasks_bin_pack": (
        [("cpu2", {"CPU": 2.0}, None, 1), ("cpu8", {"CPU": 8.0}, None, 1)],
        [],
        {"nodes": [_node("aa", {"CPU": 1.0})],
         "pending": [{"CPU": 2.0}, {"CPU": 2.0}, {"CPU": 6.0},
                     {"CPU": 1.0}, {"CPU": 0.5}],
         "pending_pgs": []}),
    "gpu_demand_launches_a_gpu_node": (
        [("cpu", {"CPU": 2.0}, None, 1), ("gpu", {"CPU": 2.0, "GPU": 1.0},
                                          None, 1)],
        [],
        {"nodes": [_node("aa", {"CPU": 2.0})],
         "pending": [{"CPU": 1.0, "GPU": 1.0}], "pending_pgs": []}),
    "topology_pg_launches_a_slice": (
        [("v2-8", GPU_SLICE, "v2-8", 2), ("cpu4", {"CPU": 4.0}, None, 1)],
        [],
        {"nodes": [_node("aa", {"CPU": 1.0})], "pending": [],
         "pending_pgs": [
             {"bundles": [{"CPU": 1.0, "GPU": 4.0}] * 2,
              "strategy": "PACK", "topology": "v2-8"},
             {"bundles": [{"CPU": 3.0}], "strategy": "PACK",
              "topology": None}]}),
    "booting_capacity_absorbs_demand": (
        [("cpu4", {"CPU": 4.0}, None, 1)],
        [("fake-1", "cpu4", ["bb"])],
        {"nodes": [_node("aa", {"CPU": 1.0})],
         "pending": [{"CPU": 3.0}, {"CPU": 3.0}], "pending_pgs": []}),
    "max_workers_caps_the_plan": (
        [("cpu2", {"CPU": 2.0}, None, 1)],
        [("fake-1", "cpu2", ["bb"])],
        {"nodes": [_node("aa", {"CPU": 1.0}), _node("bb", {"CPU": 0.0})],
         "pending": [{"CPU": 2.0}] * 6, "pending_pgs": []}),
    "idle_nodes_retire": (
        [("cpu4", {"CPU": 4.0}, None, 1), ("v2-8", GPU_SLICE, "v2-8", 2)],
        [("fake-1", "cpu4", ["bb"]), ("fake-2", "cpu4", ["cc"]),
         ("fake-3", "v2-8", ["dd", "ee"])],
        {"nodes": [_node("aa", {"CPU": 1.0}, idle_s=99.0),
                   _node("bb", {"CPU": 4.0}, idle_s=99.0),
                   _node("cc", {"CPU": 4.0}, idle_s=1.0),
                   _node("dd", GPU_SLICE, idle_s=99.0),
                   _node("ee", GPU_SLICE, idle_s=99.0)],
         "pending": [], "pending_pgs": []}),
    "pending_work_keeps_idle_nodes": (
        [("cpu4", {"CPU": 4.0}, None, 1)],
        [("fake-1", "cpu4", ["bb"])],
        {"nodes": [_node("bb", {"CPU": 4.0}, idle_s=99.0)],
         "pending": [{"CPU": 8.0}], "pending_pgs": []}),
    "lost_host_breaks_the_slice": (
        [("v2-8", GPU_SLICE, "v2-8", 2)],
        [("fake-1", "v2-8", ["dd", "ee"])],
        # seeded below with both hosts seen up; "ee" is gone now
        {"nodes": [_node("dd", GPU_SLICE)], "pending": [],
         "pending_pgs": [{"bundles": [{"GPU": 4.0}] * 2,
                          "strategy": "PACK", "topology": "v2-8"}]}),
}


def _plan(pkg: str, name: str) -> dict:
    asc = importlib.import_module(pkg + ".autoscaler")
    types, instances, load = SNAPSHOTS[name]
    provider = _StubProvider(pkg, instances)
    node_types = [asc.NodeType(n, dict(r), slice_type=s, num_hosts=h)
                  for n, r, s, h in types]
    a = asc.Autoscaler("127.0.0.1:1", provider, node_types, max_workers=3,
                       idle_timeout_s=10.0)
    if name == "lost_host_breaks_the_slice":
        a._seen_up["fake-1"] = 2
    launched = a._scale_up(load)
    terminated = a._scale_down(load)
    return {"launched": launched, "terminated": terminated,
            "created": provider.created,
            "terminated_ids": provider.terminated,
            "left": sorted(i.instance_id
                           for i in provider.non_terminated_nodes())}


@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_same_snapshot_gives_the_same_plan(name):
    want = _plan("ray_tpu", name)
    assert want["launched"] or want["terminated"] or \
        name == "pending_work_keeps_idle_nodes"
    assert _plan("ray_tpu_torch", name) == want


@pytest.mark.parametrize("pkg", PACKAGES)
def test_provision_absorbs_node_launched_after_snapshot(pkg):
    """The staleness re-check of `_provision` on both packages: a node of
    the planned type that appeared since the snapshot absorbs one
    planned launch; a node already in the snapshot absorbs none."""
    asc = importlib.import_module(pkg + ".autoscaler")
    provider = _StubProvider(pkg)
    nt = asc.NodeType("cpu4", {"CPU": 4.0})
    a = asc.Autoscaler("127.0.0.1:1", provider, [nt], max_workers=4,
                       idle_timeout_s=9999)
    stale = {i.instance_id for i in provider.non_terminated_nodes()}
    provider.create_node(nt)
    assert a._provision([nt], stale) == 0
    assert len(provider.non_terminated_nodes()) == 1
    current = {i.instance_id for i in provider.non_terminated_nodes()}
    assert a._provision([nt], current) == 1
    assert len(provider.non_terminated_nodes()) == 2
    snapshot2 = {i.instance_id for i in provider.non_terminated_nodes()}
    provider.create_node(nt)
    assert a._provision([nt, nt], snapshot2) == 1
    assert len(provider.non_terminated_nodes()) == 4

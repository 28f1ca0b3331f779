"""The port's job submission and durable workflows
(`ray_tpu_torch.job_submission`, `ray_tpu_torch.workflow`): the job and
workflow cases of `tests/test_jobs_workflow_dag.py` on one module-scoped
port cluster — a job's lifecycle and its stop, a checkpointed resume, a
dynamic continuation, recovery across a continuation, events and
metadata, and a deep continuation chain. Then one script runs a job and
the same workflows against both packages in two subprocesses at once:
their results, statuses, metadata and every stored step output (read
back from the step checkpoints) must be equal, file for file.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

import ray_tpu_torch
from ray_tpu_torch import dag as dag_api
from ray_tpu_torch import workflow

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def cluster():
    ray_tpu_torch.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    yield
    ray_tpu_torch.shutdown()


# -- job submission ---------------------------------------------------------

def test_job_submission_lifecycle(tmp_path):
    from ray_tpu_torch.job_submission import SUCCEEDED, JobSubmissionClient

    script = tmp_path / "driver.py"
    script.write_text(
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init()\n"
        "@ray_tpu_torch.remote\n"
        "def f(x):\n"
        "    return x + 1\n"
        "print('RESULT', ray_tpu_torch.get(f.remote(41)))\n"
        "ray_tpu_torch.shutdown()\n")

    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"python {script}")
    status = client.wait_until_finished(job_id, timeout=180)
    assert status == SUCCEEDED, client.get_job_logs(job_id)
    logs = client.get_job_logs(job_id)
    assert "RESULT 42" in logs
    jobs = client.list_jobs()
    assert any(j["job_id"] == job_id and j["status"] == SUCCEEDED
               for j in jobs)


def test_job_stop(tmp_path):
    from ray_tpu_torch.job_submission import STOPPED, JobSubmissionClient

    script = tmp_path / "sleeper.py"
    script.write_text("import time\ntime.sleep(300)\n")
    client = JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"python {script}")
    time.sleep(1.0)
    assert client.stop_job(job_id)
    assert client.wait_until_finished(job_id, timeout=60) == STOPPED


# -- workflows --------------------------------------------------------------

def test_workflow_checkpointed_resume(tmp_path):
    workflow.init(storage=str(tmp_path / "wf"))

    marker = tmp_path / "mode"
    marker.write_text("fail")

    @ray_tpu_torch.remote
    def step_a(x):
        return x + 1

    @ray_tpu_torch.remote
    def flaky(x):
        with open(marker) as f:
            if f.read() == "fail":
                raise RuntimeError("injected failure")
        return x * 10

    graph = dag_api.bind(flaky, dag_api.bind(step_a, dag_api.InputNode()))

    with pytest.raises(ray_tpu_torch.RayTaskError):
        workflow.run(graph, 4, workflow_id="wf1")
    assert workflow.status("wf1") == "FAILED"

    marker.write_text("ok")
    out = workflow.resume("wf1")
    assert out == 50
    assert workflow.status("wf1") == "SUCCEEDED"
    from ray_tpu_torch.workflow.execution import get_output

    assert get_output("wf1") == 50
    assert {"workflow_id": "wf1", "status": "SUCCEEDED"} in \
        workflow.list_all()


def test_workflow_continuation_dynamic(tmp_path):
    """A step returning `workflow.continuation` grows the DAG at run
    time: a recursive factorial through continuations."""
    workflow.init(storage=str(tmp_path / "wfc"))

    @ray_tpu_torch.remote
    def fact(n, acc):
        if n <= 1:
            return acc
        return workflow.continuation(dag_api.bind(fact, n - 1, acc * n))

    out = workflow.run(dag_api.bind(fact, 5, 1), workflow_id="wfc1")
    assert out == 120
    assert workflow.status("wfc1") == "SUCCEEDED"
    meta = workflow.get_metadata("wfc1")
    assert meta["steps_checkpointed"] >= 5
    assert meta["status"] == "SUCCEEDED"


def test_workflow_recovery_across_continuation(tmp_path):
    """A crash inside a continuation resumes into it: the parent runs
    once across the run and the resume."""
    workflow.init(storage=str(tmp_path / "wfr"))
    parent_runs = tmp_path / "parent_runs"
    parent_runs.write_text("0")
    marker = tmp_path / "mode"
    marker.write_text("fail")

    @ray_tpu_torch.remote
    def parent(x):
        with open(parent_runs) as f:
            n = int(f.read())
        with open(parent_runs, "w") as f:
            f.write(str(n + 1))
        return workflow.continuation(dag_api.bind(child, x + 100))

    @ray_tpu_torch.remote
    def child(x):
        with open(marker) as f:
            if f.read() == "fail":
                raise RuntimeError("child crashed")
        return x * 2

    with pytest.raises(ray_tpu_torch.RayTaskError):
        workflow.run(dag_api.bind(parent, 1), workflow_id="wfr1")
    assert workflow.status("wfr1") == "FAILED"

    marker.write_text("ok")
    assert workflow.resume("wfr1") == 202
    assert parent_runs.read_text() == "1"


def test_workflow_events_and_metadata(tmp_path):
    """`wait_for_event` blocks the workflow until `send_event`; the
    payload is durable; user metadata round-trips."""
    workflow.init(storage=str(tmp_path / "wfe"))

    @ray_tpu_torch.remote
    def combine(payload, x):
        return f"{payload}:{x}"

    graph = dag_api.bind(
        combine, workflow.wait_for_event("go"), dag_api.InputNode())
    workflow.run_async(graph, 7, workflow_id="wfe1",
                       metadata={"owner": "tests"})
    time.sleep(0.5)
    assert workflow.status("wfe1") == "RUNNING"
    workflow.send_event("wfe1", "go", "launch")
    deadline = time.monotonic() + 60
    while workflow.status("wfe1") == "RUNNING" \
            and time.monotonic() < deadline:
        time.sleep(0.1)
    assert workflow.status("wfe1") == "SUCCEEDED"
    assert workflow.get_output("wfe1") == "launch:7"
    meta = workflow.get_metadata("wfe1")
    assert meta["user_metadata"] == {"owner": "tests"}
    assert meta["end_time"] >= meta["start_time"]


def test_workflow_deep_continuation_chain(tmp_path):
    """Continuations unwind iteratively: a chain deeper than the
    recursion limit completes."""
    workflow.init(storage=str(tmp_path / "wfd"))

    @ray_tpu_torch.remote
    def countdown(n):
        if n == 0:
            return "done"
        return workflow.continuation(dag_api.bind(countdown, n - 1))

    limit = sys.getrecursionlimit()
    try:
        sys.setrecursionlimit(150)
        out = workflow.run(dag_api.bind(countdown, 300),
                           workflow_id="wfd1")
    finally:
        sys.setrecursionlimit(limit)
    assert out == "done"


def test_default_storage_is_the_ports_own(tmp_path):
    code = ("import json\n"
            "from ray_tpu.workflow import execution as j\n"
            "from ray_tpu_torch.workflow import execution as e\n"
            "print(json.dumps([e._storage_root, j._storage_root]))\n")
    env = dict(os.environ, HOME=str(tmp_path), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        str(tmp_path / ".ray_tpu_torch_workflows"),
        str(tmp_path / ".ray_tpu_workflows")]


# One script, run once against each package in its own process: a job,
# then the workflows above; every step checkpoint is read back.
TWO_PACKAGE_SCRIPT = r'''
import importlib, json, os, sys, time
pkg, workdir = sys.argv[1], sys.argv[2]
rt = importlib.import_module(pkg)
dag = importlib.import_module(pkg + ".dag")
workflow = importlib.import_module(pkg + ".workflow")
jobs = importlib.import_module(pkg + ".job_submission")
ser = importlib.import_module(pkg + "._private.serialization")
gpus = {"num_gpus": 0} if pkg == "ray_tpu_torch" else {"num_tpus": 0}
rt.init(num_cpus=4, object_store_memory=128 << 20, **gpus)
out = {}
try:
    script = os.path.join(workdir, "driver.py")
    with open(script, "w") as f:
        f.write(f"import {pkg} as rt\nrt.init()\n"
                "@rt.remote\ndef f(x):\n    return x + 1\n"
                "print('RESULT', rt.get(f.remote(41)))\nrt.shutdown()\n")
    client = jobs.JobSubmissionClient()
    job_id = client.submit_job(entrypoint=f"python {script}",
                               submission_id="job-same")
    out["job"] = [client.wait_until_finished(job_id, timeout=180),
                  "RESULT 42" in client.get_job_logs(job_id),
                  sorted(client.get_job_info(job_id))]
    try:
        client.submit_job(entrypoint="true", submission_id="job-same")
    except ValueError:
        out["duplicate"] = "ValueError"

    workflow.init(storage=os.path.join(workdir, "wf"))
    marker = os.path.join(workdir, "mode")
    with open(marker, "w") as f:
        f.write("fail")

    @rt.remote
    def step_a(x):
        return {"a": x + 1, "list": [x, x * 2]}

    @rt.remote
    def flaky(d):
        with open(marker) as f:
            if f.read() == "fail":
                raise RuntimeError("injected failure")
        return d["a"] * 10

    @rt.remote
    def fact(n, acc):
        if n <= 1:
            return acc
        return workflow.continuation(dag.bind(fact, n - 1, acc * n))

    @rt.remote
    def combine(payload, x):
        return f"{payload}:{x}"

    try:
        workflow.run(dag.bind(flaky, dag.bind(step_a, dag.InputNode())), 4,
                     workflow_id="wf1")
    except rt.RayTaskError:
        out["wf1_failed"] = workflow.status("wf1")
    with open(marker, "w") as f:
        f.write("ok")
    out["wf1"] = workflow.resume("wf1")
    out["wfc1"] = workflow.run(dag.bind(fact, 5, 1), workflow_id="wfc1",
                               metadata={"kind": "factorial"})
    workflow.send_event("wfe1", "go", "launch")
    out["wfe1"] = workflow.run(
        dag.bind(combine, workflow.wait_for_event("go"), dag.InputNode()),
        7, workflow_id="wfe1")
    out["list_all"] = sorted((w["workflow_id"], w["status"])
                             for w in workflow.list_all())
    meta = workflow.get_metadata("wfc1")
    out["meta"] = {k: meta[k] for k in ("workflow_id", "status",
                                        "user_metadata",
                                        "steps_checkpointed")}
    def describe(value):
        # a continuation checkpoint holds the sub-DAG's step and args
        if type(value).__name__ == "Continuation":
            return ["continuation", value.node._fn.__name__,
                    list(value.node._args)]
        return repr(value)

    stored = {}
    for wid in ("wf1", "wfc1", "wfe1"):
        d = os.path.join(workdir, "wf", wid)
        for name in sorted(os.listdir(d)):
            if name.startswith("step-"):
                with open(os.path.join(d, name), "rb") as f:
                    stored[f"{wid}/{name}"] = describe(ser.loads(f.read()))
    out["stored"] = stored
finally:
    rt.shutdown()
print(json.dumps(out, sort_keys=True))
'''


def test_one_script_gives_equal_results_on_both_packages(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = {}
    for pkg in ("ray_tpu", "ray_tpu_torch"):
        workdir = tmp_path / pkg
        workdir.mkdir()
        procs[pkg] = subprocess.Popen(
            [sys.executable, "-c", TWO_PACKAGE_SCRIPT, pkg, str(workdir)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    results = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg}: {err[-3000:]}"
        results[pkg] = json.loads(out.strip().splitlines()[-1])
    want = results["ray_tpu"]
    assert want["job"][:2] == ["SUCCEEDED", True]
    assert want["duplicate"] == "ValueError"
    assert [want["wf1_failed"], want["wf1"], want["wfc1"], want["wfe1"]] \
        == ["FAILED", 50, 120, "launch:7"]
    assert len(want["stored"]) >= 8
    assert results["ray_tpu_torch"] == want

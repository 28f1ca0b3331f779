"""The port stands alone: `ray_tpu_torch` and `chip_smoke.py` import
neither JAX/Flax nor anything of the JAX package `ray_tpu`.

Checked two ways: a fresh interpreter imports every module of the
package and chip_smoke's imports, then inspects `sys.modules`; and an
AST scan of every source file finds no such import statement (which
also catches imports inside functions that the first check never runs).
A third check keeps the runtime light: the package and its daemons' and
workers' modules import without torch. No module of the port imports
`aiohttp` (its HTTP servers are `_private/http.py`); the gRPC proxy's
`grpc` is the port's one optional web dependency.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "ray_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu", "aiohttp")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _modules():
    """Every module of the package but `__main__`, which runs the CLI
    when imported (the AST scan below still reads it)."""
    for path in sorted(PKG.rglob("*.py")):
        if path.name == "__main__.py":
            continue
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_leaves_no_jax_or_ray_tpu_in_sys_modules():
    mods = list(_modules())
    assert "ray_tpu_torch.serve.llm.engine" in mods
    assert {f"ray_tpu_torch.parallel.{m}" for m in (
        "mesh", "sharding", "collectives", "distributed", "pipeline", "moe",
        "ring_attention")} <= set(mods)
    assert {f"ray_tpu_torch.models.{m}" for m in (
        "moe_gpt", "bert", "vit", "resnet")} <= set(mods)
    assert set(_rllib_modules()) <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"the port imported {bad}"
    assert "ray_tpu_torch.serve.llm.engine" in loaded


def test_runtime_modules_leave_torch_unimported():
    runtime = ["ray_tpu_torch", "ray_tpu_torch._private.gcs",
               "ray_tpu_torch._private.raylet", "ray_tpu_torch._private.node",
               "ray_tpu_torch._private.worker_main",
               "ray_tpu_torch._private.serialization"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {runtime!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded
    assert not [m for m in loaded if _forbidden(m)]
    assert "ray_tpu_torch._private.core_worker" in loaded


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_no_forbidden_import_statements(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_serve_leaves_torch_unimported():
    """`import ray_tpu_torch.serve`, every Serve module, `serve.llm`'s
    deployment and the KV cache module (`reclaim_arena`) import no torch:
    the controller (which unpickles `LLMDeployment` and reclaims arenas),
    the proxies and plain replicas run without it; an LLM replica pays
    for it when it builds its engine."""
    serve = ["ray_tpu_torch.serve"] + [
        f"ray_tpu_torch.serve.{name}" for name in (
            "asgi", "batching", "controller", "deployment", "dispatch",
            "grpc_proxy", "handle", "multiplex", "proxy", "replica",
            "schema", "llm", "llm.deployment", "llm.kv_cache")]
    code = (
        "import importlib, json, sys\n"
        f"for m in {serve!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded
    assert "ray_tpu_torch.serve.llm.engine" not in loaded
    assert not [m for m in loaded if _forbidden(m)]
    assert set(serve) <= set(loaded)


# pickles a TorchTrainer, a DataParallelTrainer and the Tune trainable
# that `fit()` hands its trial actor; a fresh interpreter unpickles them
_PICKLE_TRAINERS = r'''
import sys
import cloudpickle
from ray_tpu_torch import train
from ray_tpu_torch.air import RunConfig, ScalingConfig


def loop(config):
    import torch
    train.report({"n": int(torch.ones(2).sum())})


run = RunConfig(storage_path=sys.argv[1], name="r1")
objs = [train.TorchTrainer(loop, backend_config=train.TorchConfig(
            distributed="on", platform="cpu"),
            scaling_config=ScalingConfig(num_workers=2), run_config=run),
        train.DataParallelTrainer(loop, run_config=run)]
objs.append(objs[0].as_trainable())
sys.stdout.buffer.write(cloudpickle.dumps(objs))
assert "torch" not in sys.modules
'''


def test_train_and_tune_leave_torch_unimported(tmp_path):
    """`import ray_tpu_torch.train`, `.air` and `.tune` (and their
    modules) import no torch, nor does unpickling a `TorchTrainer`, a
    `DataParallelTrainer` or the trainable `fit()` runs under Tune: the
    train controller and Tune's trial actor run without torch; the train
    workers pay for it when their loop imports it."""
    mods = sorted(m for m in _modules() if m.split(".")[:2] in (
        ["ray_tpu_torch", "train"], ["ray_tpu_torch", "air"],
        ["ray_tpu_torch", "tune"]))
    assert "ray_tpu_torch.tune" in mods and "ray_tpu_torch.air" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded
    assert not [m for m in loaded if _forbidden(m)]
    assert {"ray_tpu_torch.train._internal.backend_executor",
            "ray_tpu_torch.tune.tune_controller",
            "ray_tpu_torch.train.array_checkpoint"} <= set(loaded)

    blob = subprocess.run(
        [sys.executable, "-c", _PICKLE_TRAINERS, str(tmp_path)], cwd=ROOT,
        capture_output=True, timeout=120)
    assert blob.returncode == 0, blob.stderr.decode()[-3000:]
    code = (
        "import json, pickle, sys\n"
        "objs = pickle.loads(sys.stdin.buffer.read())\n"
        "print(json.dumps([sorted(sys.modules),\n"
        "                  [type(o).__name__ for o in objs]]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         input=blob.stdout, capture_output=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr.decode()[-3000:]
    loaded, names = json.loads(out.stdout.decode().strip().splitlines()[-1])
    assert names == ["TorchTrainer", "DataParallelTrainer", "type"]
    assert "torch" not in loaded
    assert "ray_tpu_torch.train.trainer" in loaded
    assert not [m for m in loaded if _forbidden(m)]


def test_data_dag_experimental_and_soak_leave_torch_unimported():
    """`import ray_tpu_torch.data`, `.dag`, `.experimental` and `.soak`
    (and their modules) import no torch, nor does unpickling a dataset:
    the split coordinator and the train controller unpickle datasets, and
    a CPU stage of a compiled graph reads frames, without torch. Only the
    code that touches tensors imports it: the fused DAG path, frames that
    hold tensors, the soak's train loop."""
    mods = sorted(m for m in _modules() if m.split(".")[:2] in (
        ["ray_tpu_torch", "data"], ["ray_tpu_torch", "dag"],
        ["ray_tpu_torch", "experimental"], ["ray_tpu_torch", "soak"]))
    assert {"ray_tpu_torch.data.iterator", "ray_tpu_torch.dag",
            "ray_tpu_torch.experimental.channel",
            "ray_tpu_torch.soak.driver"} <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import cloudpickle\n"
        "from ray_tpu_torch import data\n"
        "ds = data.range(8).map_batches(lambda b: {'x': b['id'] * 2})\n"
        "blob = cloudpickle.dumps(ds)\n"
        "import pickle\n"
        "pickle.loads(blob)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded
    assert not [m for m in loaded if _forbidden(m)]
    assert set(mods) <= set(loaded)


def test_autoscaler_util_jobs_and_workflow_leave_torch_unimported():
    """`import ray_tpu_torch.autoscaler`, `.util` (every module),
    `.job_submission` and `.workflow` (and their modules) import no
    torch: the cluster tooling runs in operators' drivers, the GCS's
    host and a job's supervisor, none of which needs the card. The
    15 modules of the cluster-tooling slice are all among them."""
    mods = sorted(m for m in _modules() if m.split(".")[:2] in (
        ["ray_tpu_torch", "autoscaler"], ["ray_tpu_torch", "util"],
        ["ray_tpu_torch", "job_submission"], ["ray_tpu_torch", "workflow"]))
    slice_mods = {f"ray_tpu_torch.util.{m}" for m in (
        "state", "timeline", "actor_pool", "queue", "multiprocessing",
        "tsdb", "slo")} | {
        "ray_tpu_torch.util", "ray_tpu_torch.autoscaler",
        "ray_tpu_torch.autoscaler.node_provider",
        "ray_tpu_torch.autoscaler.autoscaler",
        "ray_tpu_torch.autoscaler.gcp_tpu", "ray_tpu_torch.job_submission",
        "ray_tpu_torch.workflow", "ray_tpu_torch.workflow.execution"}
    assert len(slice_mods) == 15 and slice_mods <= set(mods)
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded
    assert not [m for m in loaded if _forbidden(m)]
    assert set(mods) <= set(loaded)


def test_operator_surface_leaves_torch_unimported():
    """`import ray_tpu_torch.dashboard`, `.util.client` (and its modules)
    and `.scripts.cli` import no torch: an operator's shell, the
    dashboard's process and the client server run without it."""
    mods = ["ray_tpu_torch.dashboard", "ray_tpu_torch.util.client",
            "ray_tpu_torch.util.client.common",
            "ray_tpu_torch.util.client.server", "ray_tpu_torch.scripts",
            "ray_tpu_torch.scripts.cli", "ray_tpu_torch._private.http"]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "torch" not in loaded
    assert not [m for m in loaded if _forbidden(m)]
    assert set(mods) <= set(loaded)


def test_cli_help_imports_neither_torch_nor_jax():
    """`python -m ray_tpu_torch status --help` (the module's `__main__`)
    prints the verb's usage and loads neither torch nor jax; the list of
    loaded modules is Python's own `-X importtime` report."""
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "ray_tpu_torch",
         "status", "--help"], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("usage: ray_tpu_torch status")
    loaded = {line.rsplit("|", 1)[1].strip()
              for line in out.stderr.splitlines()
              if line.startswith("import time:") and line.count("|") == 2}
    assert "ray_tpu_torch.scripts.cli" in loaded
    top = {m.split(".")[0] for m in loaded}
    assert not top & {"torch", "jax", "jaxlib", "aiohttp", "ray_tpu"}


def _rllib_modules():
    """The modules of the JAX package's `ray_tpu/rllib/` (23 files), named
    as the port's counterparts."""
    jax_root = ROOT / "ray_tpu" / "rllib"
    out = []
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(("ray_tpu_torch", "rllib", *parts)))
    return out


def test_rllib_has_every_module_and_imports_no_gymnasium():
    """`ray_tpu_torch/rllib/` has a counterpart of each of the 23 files of
    `ray_tpu/rllib/`; importing all of them imports neither gymnasium
    (only an env given by its gymnasium id does) nor JAX."""
    mods = _rllib_modules()
    assert len(mods) == 23
    jax_files = sorted(p.relative_to(ROOT / "ray_tpu").as_posix()
                       for p in (ROOT / "ray_tpu" / "rllib").rglob("*.py"))
    port_files = sorted(p.relative_to(PKG).as_posix()
                        for p in (PKG / "rllib").rglob("*.py"))
    assert port_files == jax_files
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert not [m for m in loaded
                if m == "gymnasium" or m.startswith("gymnasium.")]
    assert not [m for m in loaded if _forbidden(m)]


def test_rllib_exports_every_name_of_the_jax_rllib():
    """`ray_tpu_torch.rllib` and its `algorithms` and `offline` packages
    export every name their JAX counterparts do (read from the sources:
    this test imports no JAX)."""
    import importlib

    for sub in ("", ".algorithms", ".offline"):
        init = (ROOT / "ray_tpu" / "rllib" / sub.strip(".") / "__init__.py")
        tree = ast.parse(init.read_text())
        want = next(ast.literal_eval(node.value) for node in tree.body
                    if isinstance(node, ast.Assign)
                    and node.targets[0].id == "__all__")
        port = importlib.import_module(f"ray_tpu_torch.rllib{sub}")
        assert set(want) <= set(port.__all__), sub
        assert all(hasattr(port, name) for name in want), sub


def test_models_export_every_name_of_the_jax_zoo():
    """`from ray_tpu_torch.models import *` gives every name that
    `ray_tpu.models` exports (read from its source: this test imports no
    JAX)."""
    tree = ast.parse((ROOT / "ray_tpu" / "models" / "__init__.py")
                     .read_text())
    want = next(ast.literal_eval(node.value) for node in tree.body
                if isinstance(node, ast.Assign)
                and node.targets[0].id == "__all__")
    import ray_tpu_torch.models as port

    assert set(want) <= set(port.__all__)
    assert all(hasattr(port, name) for name in want)

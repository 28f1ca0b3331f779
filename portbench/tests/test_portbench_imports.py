"""Nothing the benchmark runs loads `jax` or the JAX package: top-level
module names compared whole (`ray_tpu_torch` begins with `ray_tpu` and is
allowed)."""

import json
import subprocess
import sys

from portbench import run
from portbench.tests.tiny import ROOT

SCRIPT = """
import json, sys
from portbench.tests.tiny import run_tiny
for cell in ("gpt2_train", "gpt2_serve_chat"):
    assert run_tiny(cell, seconds=0.5)["attempted"] > 0
print(json.dumps(sorted({m.split(".", 1)[0] for m in list(sys.modules)})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "ray_tpu_torch" in top and "portbench" in top
    assert not top.intersection(run.FORBIDDEN), top


def test_the_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch_probe", sys)
    assert "ray_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ray_tpu.serve", sys)
    assert "ray_tpu" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in run.forbidden_modules()


def test_no_card_no_result(capsys):
    rc = run.main(["--workload", "gpt2_train", "--seed", "1",
                   "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""

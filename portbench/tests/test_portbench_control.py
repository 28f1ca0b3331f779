"""The control of each output check comes out not correct: the plain
reference put in the program's place with its products in fp8, the step
below the configurations' bfloat16 (`calibrate`; on the card at the
cells' own sizes, PERF.md). Here at sizes a CPU test run holds."""

import copy
import time
from types import SimpleNamespace

import torch

from portbench import calibrate, checks, spec
from portbench.tests.tiny import BENCH, ROOT, gpt_cfg, traffic_for


def _job(cfg, tr, seconds=1.0):
    return SimpleNamespace(cfg=cfg, tr=tr, seed=11, seconds=seconds,
                           trace=False,
                           device=torch.device("cpu"),
                           fam=spec.family(cfg["family"]),
                           t_start=time.time())


def test_training_control_fails_the_check():
    out = calibrate._train(_job(gpt_cfg("bfloat16"),
                                traffic_for("gpt2_train")))
    judged = checks.judge(out["control"], spec.limits("gpt2_train"))
    assert not all(ok for _, _, ok in judged.values()), judged
    judged = checks.judge(out["half_batch"], spec.limits("gpt2_train"))
    assert not all(ok for _, _, ok in judged.values()), judged


def test_serving_control_fails_the_check():
    # GPT-2 at its published widths and depth (the control's gap grows
    # with them), a few short requests
    cfg = copy.deepcopy(spec.config(BENCH, ROOT, "gpt2_124m"))
    cfg["compute_dtype"] = "float32"
    tr = dict(traffic_for("gpt2_serve_chat"), rate=2.0)
    out = calibrate._serve(_job(cfg, tr, 2.0))
    assert out["attempted"] > 0 and out["failed"] == 0
    for cell in ("gpt2_serve_batch", "gpt2_serve_chat"):
        limit = spec.limits(cell)["logit_gap"]
        assert out["program"]["logit_gap"] <= limit
        assert out["control"]["logit_gap"] > limit, out

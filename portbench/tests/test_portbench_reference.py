"""The plain references against the port's CPU path at small sizes: the
test imports both, the references import nothing of the port."""

import time
from types import SimpleNamespace

import torch

from portbench import spec
from portbench.reference import bert as ref_bert
from portbench.reference import gpt as ref_gpt
from portbench.tests.tiny import bert_cfg, gpt_cfg, run_tiny


def test_gpt_logits_match_the_port():
    from ray_tpu_torch.models.gpt import GPT

    cfg = gpt_cfg()
    fam = spec.family("gpt")
    params = fam.make_params(cfg, 3, torch.device("cpu"), train=False)
    net = GPT.from_params(fam.port_config(cfg), params)
    toks = torch.randint(0, 500, (2, 40))
    with torch.no_grad():
        want = net(toks)
        got = ref_gpt.logits(params, toks, cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_bert_hidden_matches_the_port():
    from ray_tpu_torch.models.bert import BertEncoder

    cfg = bert_cfg()
    fam = spec.family("bert")
    params = fam.make_params(cfg, 4, torch.device("cpu"), train=False)
    net = BertEncoder.from_params(fam.port_config(cfg), params)
    toks = torch.randint(0, 500, (2, 48))
    types = (torch.arange(48) >= 24).long().expand(2, 48)
    with torch.no_grad():
        want, _ = net(toks, types)
        got = ref_bert.hidden(params, toks, types, cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_training_cell_agrees_in_float32():
    res = run_tiny("gpt2_train")
    assert res["correct"], res
    assert all(c["value"] < 1e-4 for c in res["checks"].values()), res


def test_bert_training_steps_agree_in_float32():
    # BERT's MLM step, kept for the cell that waits on the program (PERF.md)
    from portbench import checks
    from portbench.drivers import train as dt

    tr = dict(spec.traffic("mlm_b32_t512"), batch=4, seq=32, batches=4,
              reference_rows=2)
    job = SimpleNamespace(cfg=bert_cfg(), tr=tr, seed=9, seconds=0.0,
                          trace=False, device=torch.device("cpu"),
                          fam=spec.family("bert"), t_start=time.time())
    kept = dt.free(dt.setup(job))
    ref = dt.reference(job, kept["init"], kept["checked"])
    readings = checks.train_readings(kept["program"], ref)
    assert all(v < 1e-4 for v in readings.values()), readings


def test_serving_cells_agree_in_float32():
    for cell in ("gpt2_serve_batch", "gpt2_serve_chat"):
        res = run_tiny(cell)
        assert res["correct"] and res["attempted"] > 0, res
        assert res["checks"]["logit_gap"]["value"] < 1e-4, res

"""A run whose timed path is broken underneath comes out not correct:
one fault of each kind a cell can have (one chip, so no exchange between
chips to leave out)."""

import pytest
import torch

from portbench.tests.tiny import run_tiny

TRAIN = ("gpt2_train",)
SERVE = ("gpt2_serve_batch", "gpt2_serve_chat")


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_the_state_unchanged(cell, monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, closure=None: None)
    res = run_tiny(cell)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out(cell, monkeypatch):
    from ray_tpu_torch.ops import fused_ce

    whole = fused_ce.fused_cross_entropy

    def half(hidden, wte, targets, *a, **kw):
        n = hidden.shape[0] // 2
        return whole(hidden[:n], wte, targets[:n], *a, **kw)

    monkeypatch.setattr(fused_ce, "fused_cross_entropy", half)
    res = run_tiny(cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", SERVE)
def test_a_token_altered_where_it_is_produced(cell, monkeypatch):
    from ray_tpu_torch.serve.llm.engine import Request

    emit = Request._emit

    def altered(self, token):
        # every fifth token of a request is the next id's
        if len(self.tokens) % 5 == 4:
            token = (token + 1) % 500
        emit(self, token)

    monkeypatch.setattr(Request, "_emit", altered)
    res = run_tiny(cell)
    assert res["attempted"] > 0
    assert not res["correct"], res["checks"]

"""The frozen FLOP and byte counts against figures worked out by hand."""

import pytest

from portbench import peaks, spec


def _shape(name):
    cfg = spec.config_file(spec.HERE / "configs" / f"{name}.json")
    return spec.family(cfg["family"]).shape(cfg)


def test_gpt2_training_flops():
    # per token: 3 x (12 x (24 d^2 + 2 d (T + 1)) + 2 d V), V = 50257
    # = 3 x (12 x (14,155,776 + 1,574,400) + 77,194,752) = 797,870,592
    assert peaks.train_flops(_shape("gpt2_124m"), 16, 1024, True,
                             16 * 1024) == 16 * 1024 * 797_870_592


def test_bert_training_flops_count_the_masked_head_rows():
    # per token without the head: 3 x 12 x (24 d^2 + 4 d T) = 566,231,040;
    # the head, per masked position: 3 x 2 x 768 x 30522 = 140,645,376
    for masked in (0, 2458, 16384):
        assert peaks.train_flops(_shape("bert_base"), 32, 512, False,
                                 masked) == \
            16384 * 566_231_040 + masked * 140_645_376


def test_attention_bounds():
    t, bound = peaks.attention_bound(16, 1024, 12, 12, 64, "bfloat16", True)
    assert bound == "bytes"
    assert t == pytest.approx(101_449_728 / 3.35e12)
    t, bound = peaks.attention_bwd_bound(16, 1024, 12, 12, 64, "bfloat16",
                                         True)
    assert bound == "operations"
    assert t == pytest.approx(10 * 16 * 12 * 64 * 524_800 / 989e12)
    # non-causal: every pair
    t, _ = peaks.attention_bound(32, 512, 12, 12, 64, "bfloat16", False)
    assert t == pytest.approx(max(4 * 32 * 12 * 64 * 512 * 512 / 989e12,
                                  (4 * 32 * 512 * 768 * 2
                                   + 32 * 12 * 512 * 4) / 3.35e12))


def test_serve_flops():
    s = _shape("gpt2_124m")
    # per token through the blocks: 12 x 2 x 7,077,888 = 169,869,312;
    # attention 12 x 4 x 768 = 36,864 per key; head 77,194,752
    prefill, steps = peaks.serve_flops(s, 3, 0, 3)
    assert prefill == 3 * 169_869_312 + 36_864 * 6 + 77_194_752
    assert steps == [169_869_312 + 36_864 * 4 + 77_194_752,
                     169_869_312 + 36_864 * 5 + 77_194_752]
    prefill, steps = peaks.serve_flops(s, 3, 2, 1)
    assert prefill == 169_869_312 + 36_864 * 3 + 77_194_752
    assert steps == []

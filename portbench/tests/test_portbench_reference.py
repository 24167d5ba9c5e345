"""The plain reference against the port's smoke-size dense and MoE models
on the CPU, both on the same seed's weights in float32: the port's
prefill, then its decode steps through the cache, give the reference's
logits at every position."""

import pytest
import torch

from portbench import weights
from portbench.model import model_config
from portbench.reference import lm as ref_lm
from portbench.tests.tiny import CONFIGS

SEED = 2 ** 32 + 17


@pytest.mark.parametrize("name", ["tiny_dense", "tiny_moe"])
def test_prefill_then_decode_match_the_reference(name):
    from repro_torch.models import get_model
    from repro_torch.models.registry import empty_model

    conf = dict(CONFIGS[name], name=name)
    cfg = model_config(conf)
    bundle = get_model(cfg)
    model = weights.fill_module(empty_model(cfg, "meta"), conf, SEED, "cpu")
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab - 1, (1, 24), generator=gen)
    steps = 5
    with torch.no_grad():
        logits, cache = bundle.prefill(model, {"tokens": prompt},
                                       cache_len=64)
        got, seq = [logits[0, :cfg.vocab]], prompt[0].tolist()
        for i in range(steps):
            tok = int(got[-1].argmax())
            seq.append(tok)
            logits, cache = bundle.decode(
                model, cache, torch.tensor([[tok]]),
                torch.tensor([len(seq) - 1], dtype=torch.int32))
            got.append(logits[0, :cfg.vocab])
    want = ref_lm.logits_at(conf, SEED, [torch.tensor(seq)], [23], "cpu")[0]
    got = torch.stack(got)
    assert want.shape == got.shape == (steps + 1, cfg.vocab)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale


def test_fp8_control_is_coarser_than_float32():
    conf = dict(CONFIGS["tiny_dense"], name="tiny_dense")
    seq = [torch.arange(40) % 500]
    exact = ref_lm.logits_at(conf, SEED, seq, [0], "cpu")[0]
    low = ref_lm.logits_at(conf, SEED, seq, [0], "cpu", lowp="fp8")[0]
    err = (low - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.5


def test_published_deepseek_routing_is_refused_and_the_reference_follows_it():
    """DeepSeek-MoE-16B publishes ``norm_topk_prob: false``; the port
    renormalizes the top k, so the harness refuses to run that
    configuration, and the reference, which follows the flag, gives other
    logits without the renormalization."""
    import json

    from portbench.spec import HERE

    published = json.loads((HERE / "configs" / "dsmoe16b.json").read_text())
    assert published["model"]["norm_topk_prob"] is False
    with pytest.raises(ValueError, match="norm_topk_prob"):
        model_config(published)
    conf = dict(CONFIGS["tiny_moe"], name="tiny_moe")
    seq = [torch.arange(24) % 500]
    logits = {}
    for flag in (True, False):
        c = dict(conf, model=dict(conf["model"], norm_topk_prob=flag))
        logits[flag] = ref_lm.logits_at(c, SEED, seq, [23], "cpu")[0]
    gap = (logits[True] - logits[False]).abs().max()
    assert gap > 1e-2 * logits[True].abs().max()

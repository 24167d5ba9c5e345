"""The one traffic generator: the same for the same seed, the same sizes
and arrivals for every seed (in another order), and the lengths and rate
the mixes state."""

import json

import numpy as np
import pytest

from portbench import traffic
from portbench.spec import HERE


def mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["chat"])
def test_serve_mix_repeats_and_keeps_its_sizes(name):
    m = mix(name)
    a = traffic.serve_requests(m, 2 ** 31 + 11, 40, 64000)
    b = traffic.serve_requests(m, 2 ** 31 + 11, 40, 64000)
    c = traffic.serve_requests(m, 7, 40, 64000)
    assert [r["due_s"] for r in a] == [r["due_s"] for r in b]
    assert all((x["prompt"] == y["prompt"]).all() for x, y in zip(a, b))
    # every seed the same requests, arriving alike; other token ids
    assert [(len(r["prompt"]), r["max_new"], r["due_s"]) for r in a] == \
        [(len(r["prompt"]), r["max_new"], r["due_s"]) for r in c]
    assert any((x["prompt"] != y["prompt"]).any() for x, y in zip(a, c))
    plen = np.array([len(r["prompt"]) for r in a])
    out = np.array([r["max_new"] for r in a])
    assert plen.min() >= m["prompt"]["min"]
    assert plen.max() <= m["prompt"]["max"]
    assert out.min() >= m["output"]["min"]
    assert out.max() <= m["output"]["max"]
    if m["prompt"]["dist"] == "lognormal":
        assert abs(np.median(plen) / m["prompt"]["median"] - 1) < 0.1
    ids = np.concatenate([r["prompt"] for r in a])
    assert ids.min() >= 0 and ids.max() < 64000 - 1     # no end of sequence
    if m["loop"] == "open":
        due = np.array([r["due_s"] for r in a])
        assert due[0] == 0 and (np.diff(due) >= 0).all()
        rate = (len(due) - 1) / due[-1]
        assert abs(rate / m["rate_per_s"] - 1) < 0.1
        assert traffic.request_count(m, 40) == len(a)


@pytest.mark.parametrize("part", ["prompt", "output"])
def test_chat_lengths_have_their_sources_mean(part):
    """The chat mix's lengths, drawn within [min, max], have the mean its
    source published: over many draws within 2%, and in the schedule a
    run sends within 6%."""
    m = mix("chat")
    dist = m[part]
    many = traffic.draw_lengths(dist, 200_000, np.random.default_rng(5))
    assert abs(many.mean() / dist["source_mean"] - 1) < 0.02
    sent = traffic.serve_requests(m, 3, 51, 64000)
    got = np.mean([len(r["prompt"]) if part == "prompt" else r["max_new"]
                   for r in sent])
    assert abs(got / dist["source_mean"] - 1) < 0.06
    assert str(dist["source_mean"]) in m["source"]


def test_train_batches_pack_documents_and_differ():
    m = mix("train")
    a = traffic.train_batches(m, 2 ** 32 + 3, 64000, 8)
    b = traffic.train_batches(m, 2 ** 32 + 3, 64000, 8)
    assert all((x["tokens"] == y["tokens"]).all() for x, y in zip(a, b))
    eos = 64000 - 1
    rows = set()
    for batch in a:
        tok, lab = batch["tokens"], batch["labels"]
        assert tok.shape == lab.shape == (m["batch"], m["seq"])
        assert (lab[tok == eos] == -1).all()
        assert ((lab == -1) == (tok == eos)).all()
        assert (tok[:, 1:][lab[:, :-1] >= 0] == lab[:, :-1][
            lab[:, :-1] >= 0]).all()
        rows.update(r.tobytes() for r in tok)
    assert len(rows) == 8 * m["batch"]


def test_lognormal_truncation_and_uniform():
    rng = np.random.default_rng(0)
    x = traffic.draw_lengths({"dist": "lognormal", "median": 100,
                              "sigma": 1.0, "min": 50, "max": 150}, 5000,
                             rng)
    assert len(x) == 5000 and x.min() >= 50 and x.max() <= 150
    u = traffic.draw_lengths({"dist": "uniform", "min": 3, "max": 5}, 999,
                             rng)
    assert set(u) == {3, 4, 5}
    with pytest.raises(ValueError):
        traffic.draw_lengths({"dist": "zipf", "min": 1, "max": 2}, 1, rng)

"""The one generator of every traffic mix (``traffic/<name>.json``).

A mix is data: the loop (``open`` at a fixed rate, ``closed`` with a
number of clients, or ``train`` batches), the length distributions, the
rate and the lead-in.  So that every seed does the same work, the
requests' sizes and arrivals (prompt and output lengths, the gaps
between arrivals, in their order) and the documents' lengths are drawn
from the mix's own ``shape_seed``; the run's ``--seed`` draws the token
ids (and orders the documents).  A tail of time to first token turns on
which requests arrive together: with the order drawn from the seed, the
chat cell's 95th percentile spread by a third across seeds on the H100,
and by a few percent with one order.
Token ids are drawn below ``vocab - 1``, the end-of-sequence id, which no
prompt holds.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

# schedule past the window's close: load stays on while the window's
# requests finish, up to the wait the run allows them
TAIL_S = 75.0


def draw_lengths(dist: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """n whole lengths from ``dist``: ``lognormal`` (median, sigma),
    truncated to [min, max] by drawing again, or ``uniform`` on [min,
    max]."""
    lo, hi = int(dist["min"]), int(dist["max"])
    if dist["dist"] == "uniform":
        return rng.integers(lo, hi + 1, n)
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    out = np.empty(0, np.int64)
    mu, sigma = math.log(dist["median"]), float(dist["sigma"])
    while len(out) < n:
        x = np.rint(rng.lognormal(mu, sigma, 2 * n)).astype(np.int64)
        out = np.concatenate([out, x[(x >= lo) & (x <= hi)]])
    return out[:n]


def request_count(mix: Dict, seconds: float) -> int:
    """Requests a run's schedule holds: the open loop's over the lead-in,
    the window and the tail; the closed loop's pool."""
    if mix["loop"] == "open":
        return math.ceil(mix["rate_per_s"]
                         * (mix["lead_in_s"] + seconds + TAIL_S)) + 1
    return int(mix["pool"])


def serve_requests(mix: Dict, seed: int, seconds: float,
                   vocab: int) -> List[Dict]:
    """The run's requests in the order they are sent: uid, ``due_s``
    (seconds after the schedule's start; the open loop's Poisson
    arrivals, 0 for a closed loop's, which are sent as clients free),
    ``prompt`` (int32 ids) and ``max_new``."""
    n = request_count(mix, seconds)
    shape = np.random.default_rng(mix.get("shape_seed", 0))
    plen = draw_lengths(mix["prompt"], n, shape)
    olen = draw_lengths(mix["output"], n, shape)
    gaps = shape.exponential(1.0 / mix["rate_per_s"], n) \
        if mix["loop"] == "open" else np.zeros(n)
    due = np.cumsum(gaps) - gaps[0]
    ids = np.random.default_rng(seed).integers(0, vocab - 1,
                                               int(plen.sum()),
                                               dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(plen)])
    return [{"uid": j, "due_s": float(due[j]),
             "prompt": ids[starts[j]:starts[j + 1]], "max_new": int(olen[j])}
            for j in range(n)]


def cache_len(mix: Dict) -> int:
    """KV positions a slot needs: the longest prompt and output."""
    return int(mix["prompt"]["max"]) + int(mix["output"]["max"])


def train_batches(mix: Dict, seed: int, vocab: int,
                  n: int) -> List[Dict[str, np.ndarray]]:
    """``n`` batches of ``batch`` rows of ``seq`` packed tokens: documents
    of uniform lengths in [doc_min, doc_max) from an order-1 Markov chain
    of ``branching`` successors a token (the table drawn from the seed),
    each followed by the end-of-sequence id ``vocab - 1``; labels are the
    next tokens, -1 after an end of sequence (no prediction across
    documents).  Every row of every batch differs."""
    b, s = int(mix["batch"]), int(mix["seq"])
    need = n * b * (s + 1)
    shape = np.random.default_rng(mix.get("shape_seed", 0))
    lens = []
    while sum(lens) + len(lens) < need:
        lens.append(int(shape.integers(mix["doc_min"], mix["doc_max"])))
    lens = np.array(lens)
    rng = np.random.default_rng(seed)
    lens = lens[rng.permutation(len(lens))]
    eos = vocab - 1
    succ = rng.integers(0, eos, (eos, int(mix["branching"])),
                        dtype=np.int64)
    docs = np.zeros((len(lens), int(lens.max())), np.int64)
    tok = rng.integers(0, eos, len(lens))
    picks = rng.integers(0, succ.shape[1], docs.shape)
    for i in range(docs.shape[1]):
        docs[:, i] = tok
        tok = succ[tok, picks[:, i]]
    flat = np.concatenate([np.append(docs[j, :lens[j]], eos)
                           for j in range(len(lens))])[:need]
    block = flat.reshape(n, b, s + 1)
    out = []
    for blk in block:
        tokens = blk[:, :-1].astype(np.int32)
        labels = blk[:, 1:].astype(np.int32)
        labels[tokens == eos] = -1
        out.append({"tokens": tokens, "labels": labels})
    return out

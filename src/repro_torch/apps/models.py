"""Builders for the paper's three evaluation models (§5) and the int8 FC
classifier: the port's copy of ``repro.apps.models``, numpy only, so the
same seeds give the same weights and the same blobs."""

from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.graph_builder import GraphBuilder


def build_conv_reference(seed: int = 0) -> GraphBuilder:
    """§5.3: two conv layers, one max-pool, one dense, one activation."""
    rng = np.random.default_rng(seed)
    gb = GraphBuilder("conv_reference")
    x = gb.input("image", (1, 16, 16, 1))
    w1 = gb.const(rng.normal(0, 0.4, (8, 3, 3, 1)).astype(np.float32), "w1")
    b1 = gb.const(rng.normal(0, 0.05, (8,)).astype(np.float32), "b1")
    h = gb.conv2d(x, w1, b1, stride=1, padding="SAME", activation="relu")
    h = gb.max_pool2d(h, k=2)
    w2 = gb.const(rng.normal(0, 0.4, (16, 3, 3, 8)).astype(np.float32), "w2")
    b2 = gb.const(np.zeros(16, np.float32), "b2")
    h = gb.conv2d(h, w2, b2, stride=2, padding="SAME", activation="relu")
    h = gb.mean(h, axes=[1, 2])
    wd = gb.const(rng.normal(0, 0.4, (10, 16)).astype(np.float32), "wd")
    bd = gb.const(np.zeros(10, np.float32), "bd")
    h = gb.fully_connected(h, wd, bd)
    gb.mark_output(gb.softmax(h))
    return gb


def build_hotword(seed: int = 1, features: int = 40, units: int = 64,
                  memory: int = 8, rank: int = 1,
                  n_layers: int = 3, n_classes: int = 4) -> GraphBuilder:
    """A Google-Hotword-class SVDF keyword spotter.

    The production model is proprietary ("we use a version with scrambled
    weights and biases" — §5.1); this reproduces its published shape: a
    stack of SVDF layers over streaming audio features, topped by a
    softmax over keyword classes (cf. Zhang et al. 2017 / TFLM's
    keyword_benchmark).
    """
    rng = np.random.default_rng(seed)
    gb = GraphBuilder("hotword")
    x = gb.input("features", (1, features))
    h = x
    dim = features
    for li in range(n_layers):
        nf = units * rank
        wf = gb.const(rng.normal(0, 1 / np.sqrt(dim),
                                 (nf, dim)).astype(np.float32), f"wf{li}")
        wt = gb.const(rng.normal(0, 1 / np.sqrt(memory),
                                 (nf, memory)).astype(np.float32), f"wt{li}")
        bias = gb.const(np.zeros(units, np.float32), f"b{li}")
        state = gb.variable(f"svdf_state{li}", (1, nf * memory))
        h = gb.svdf(h, wf, wt, bias, state, rank=rank, activation="relu")
        dim = units
    wd = gb.const(rng.normal(0, 1 / np.sqrt(dim),
                             (n_classes, dim)).astype(np.float32), "w_out")
    bd = gb.const(np.zeros(n_classes, np.float32), "b_out")
    h = gb.fully_connected(h, wd, bd)
    gb.mark_output(gb.softmax(h))
    return gb


def _dw_separable(gb: GraphBuilder, rng, h, in_ch: int, out_ch: int,
                  stride: int, idx: int):
    wdw = gb.const(rng.normal(0, 0.3, (1, 3, 3, in_ch)).astype(np.float32),
                   f"dw{idx}")
    bdw = gb.const(np.zeros(in_ch, np.float32), f"dwb{idx}")
    h = gb.depthwise_conv2d(h, wdw, bdw, stride=stride, padding="SAME",
                            activation="relu6")
    wpw = gb.const(
        rng.normal(0, np.sqrt(2.0 / in_ch),
                   (out_ch, 1, 1, in_ch)).astype(np.float32), f"pw{idx}")
    bpw = gb.const(np.zeros(out_ch, np.float32), f"pwb{idx}")
    return gb.conv2d(h, wpw, bpw, stride=1, padding="SAME",
                     activation="relu6")


def build_vww(seed: int = 2, width: float = 0.25,
              resolution: int = 96) -> GraphBuilder:
    """Visual-Wake-Words person detector: MobileNet-v1 0.25x @ 96×96×1
    (Chowdhery et al. 2019 — the model TFLM benchmarks in Figure 6)."""
    rng = np.random.default_rng(seed)

    def c(ch: int) -> int:
        return max(8, int(ch * width + 0.5) // 8 * 8)

    gb = GraphBuilder("vww_mobilenet")
    x = gb.input("image", (1, resolution, resolution, 1))
    w0 = gb.const(rng.normal(0, 0.3, (c(32), 3, 3, 1)).astype(np.float32),
                  "conv0")
    b0 = gb.const(np.zeros(c(32), np.float32), "conv0b")
    h = gb.conv2d(x, w0, b0, stride=2, padding="SAME", activation="relu6")
    plan = [  # (out_ch, stride) — MobileNet-v1 body
        (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
        (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
        (1024, 1),
    ]
    in_ch = c(32)
    for i, (oc, s) in enumerate(plan):
        h = _dw_separable(gb, rng, h, in_ch, c(oc), s, i)
        in_ch = c(oc)
    h = gb.mean(h, axes=[1, 2])
    wd = gb.const(rng.normal(0, 1 / np.sqrt(in_ch),
                             (2, in_ch)).astype(np.float32), "fc")
    bd = gb.const(np.zeros(2, np.float32), "fcb")
    h = gb.fully_connected(h, wd, bd)
    gb.mark_output(gb.softmax(h))
    return gb


def build_fc_stack(seed: int = 3, features: int = 64,
                   hidden: int = 32, n_layers: int = 2,
                   n_classes: int = 8) -> GraphBuilder:
    """A pure fully-connected classifier — the int8 "FC family" the
    serving host routes at request granularity.  Stateless, so every
    request is a single-frame continuation; quantized int8 it is
    integer-exact, which makes it the bit-identity workhorse for the
    ragged micro path."""
    rng = np.random.default_rng(seed)
    gb = GraphBuilder("fc_stack")
    h = gb.input("features", (1, features))
    dim = features
    for li in range(n_layers):
        w = gb.const(rng.normal(0, 1 / np.sqrt(dim),
                                (hidden, dim)).astype(np.float32), f"w{li}")
        b = gb.const(rng.normal(0, 0.05, (hidden,)).astype(np.float32),
                     f"b{li}")
        h = gb.fully_connected(h, w, b, activation="relu")
        dim = hidden
    wo = gb.const(rng.normal(0, 1 / np.sqrt(dim),
                             (n_classes, dim)).astype(np.float32), "w_out")
    bo = gb.const(np.zeros(n_classes, np.float32), "b_out")
    gb.mark_output(gb.softmax(gb.fully_connected(h, wo, bo)))
    return gb


def paper_models() -> Dict[str, GraphBuilder]:
    return {
        "conv_reference": build_conv_reference(),
        "hotword": build_hotword(),
        "vww": build_vww(),
    }


def representative_dataset(gb: GraphBuilder, n: int = 8, seed: int = 9):
    rng = np.random.default_rng(seed)
    shapes = [gb.tensors[t].shape for t in gb.inputs]
    return [tuple(rng.normal(0, 1, s).astype(np.float32) for s in shapes)
            for _ in range(n)]

"""Micro graphs over the transformer and elementwise micro ops: one
llama-style decoder block at a model config's widths, and a graph that
reaches every micro op the §5 models do not.

Both are numpy graphs built from a seed.  ``builder`` is the GraphBuilder
class that builds them: the port's by default, or any class with the
same authoring API (the parity tests pass the JAX package's, so the two
packages export the same graph).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph_builder import GraphBuilder
from repro_torch.core.schema import OpCode


def _weights(rng, shape, sd):
    w = rng.standard_normal(shape, dtype=np.float32)
    w *= np.float32(sd)
    return w


def build_decoder_block(cfg, seq: int, seed: int = 0,
                        builder=GraphBuilder):
    """One decoder block of ``cfg`` (a ``models.common.ModelConfig`` of
    the dense family) over ``seq`` tokens, float32, batch 1: embedding
    lookup, RMS norm, the q/k/v projections, RoPE at ``cfg.rope_base``,
    causal attention with each of the ``n_kv_heads`` K/V heads repeated
    to the query heads it serves (head i reads K/V head i // group, as
    the LM's grouped attention does; the micro ATTENTION op takes equal
    head counts), the output projection and its residual, RMS norm and
    the SiLU-gated MLP and its residual.  Input: int32 token ids
    (1, seq); output: the block's (1, seq, d_model) activations."""
    rng = np.random.default_rng(seed)
    d, h, kh, dh, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                        cfg.d_ff)
    group = h // kh
    gb = builder(f"{cfg.arch_id}_block")

    def const(shape, fan_in, name):
        return gb.const(_weights(rng, shape, 1.0 / np.sqrt(fan_in)), name)

    def gain(name):
        return gb.const(1.0 + _weights(rng, (d,), 0.1), name)

    ids = gb.input("ids", (1, seq), "int32")
    x = gb.embedding(ids, const((cfg.vocab, d), 1, "embed"))
    hn = gb.rms_norm(x, gain("attn_norm"))
    q = gb.matmul(hn, const((d, h * dh), d, "wq"))
    k = gb.matmul(hn, const((d, kh * dh), d, "wk"))
    v = gb.matmul(hn, const((d, kh * dh), d, "wv"))
    q = gb.rope(gb.reshape(q, (1, seq, h, dh)), base=cfg.rope_base)
    k = gb.rope(gb.reshape(k, (1, seq, kh, dh)), base=cfg.rope_base)
    v = gb.reshape(v, (1, seq, kh, dh))

    def query_heads(t):                     # (1,S,KH,D) -> (1,H,S,D)
        t = gb.reshape(gb.transpose(t, (0, 2, 1, 3)), (1, kh, 1, seq, dh))
        return gb.reshape(gb.concat([t] * group, axis=2), (1, h, seq, dh))

    a = gb.attention(gb.transpose(q, (0, 2, 1, 3)), query_heads(k),
                     query_heads(v), causal=True)
    a = gb.reshape(gb.transpose(a, (0, 2, 1, 3)), (1, seq, h * dh))
    # the output projection stored (N, K), as a checkpoint's wo is
    x = gb.add(x, gb.matmul(a, const((d, h * dh), h * dh, "wo"),
                            transpose_b=True))
    hn = gb.rms_norm(x, gain("mlp_norm"))
    gate = gb.silu(gb.matmul(hn, const((d, ff), d, "w_gate")))
    up = gb.matmul(hn, const((d, ff), d, "w_up"))
    y = gb.matmul(gb.mul(gate, up), const((ff, d), ff, "w_down"))
    gb.mark_output(gb.add(x, y))
    return gb


def build_op_coverage(resolution: int = 96, quantizable_only: bool = False,
                      seed: int = 4, builder=GraphBuilder):
    """A graph at an image input of ``resolution`` x ``resolution`` x 3
    (VWW's 96 by default) that reaches the micro ops the §5 models do
    not.  Its first output runs only ops with an int8 path (ADD, SUB,
    MUL, AVERAGE_POOL_2D, RELU, RELU6, LOGISTIC, TANH, CONCATENATION,
    PAD, TRANSPOSE, with a conv, a mean, an FC and a softmax), and with
    ``quantizable_only`` it is the whole graph, so the graph exports to
    int8.  Otherwise a second input of 8 int32 token ids and a second
    output add the rest: SPLIT, MINIMUM, MAXIMUM, SQUARED_DIFFERENCE,
    STRIDED_SLICE, SILU, GELU, NEG, EXP, RSQRT, LEAKY_RELU, IDENTITY,
    DROPOUT (both kept when the graph is serialized with ``build()``; the
    exporter strips them), LAYER_NORM, MATMUL, EMBEDDING_LOOKUP,
    RMS_NORM, ROPE and BATCH_MATMUL."""
    if resolution % 8:
        raise ValueError(f"resolution {resolution} is not a multiple of 8")
    rng = np.random.default_rng(seed)
    gb = builder("op_coverage_int8" if quantizable_only else "op_coverage")

    def const(shape, sd, name):
        return gb.const(_weights(rng, shape, sd), name)

    def op(opcode, xs, n_outputs=1, **params):
        return gb._infer_and_add(opcode, [x.index for x in xs], params,
                                 n_outputs=n_outputs)

    x = gb.input("image", (1, resolution, resolution, 3))
    c = gb.conv2d(x, const((8, 3, 3, 3), 0.3, "conv"),
                  const((8,), 0.05, "conv_b"), stride=2, padding="SAME",
                  activation="relu")
    p = gb.avg_pool2d(c, k=2)                        # (1, R/4, R/4, 8)
    t = gb.unary(OpCode.TANH, p)
    mixed = gb.mul(gb.sub(gb.add(gb.unary(OpCode.RELU6, p), t),
                          gb.unary(OpCode.LOGISTIC, p)), t)
    mixed = gb.add(mixed, const((8,), 0.2, "shift"), activation="relu")
    cat = gb.concat([mixed, gb.relu(p)], axis=-1)   # (1, R/4, R/4, 16)
    padded = op(OpCode.PAD, [cat], paddings=[[0, 0], [1, 1], [1, 1], [0, 0]])
    feat = gb.mean(gb.transpose(padded, (0, 3, 1, 2)), axes=[2, 3])
    logits = gb.fully_connected(feat, const((2, 16), 0.25, "fc"),
                                const((2,), 0.05, "fc_b"))
    gb.mark_output(gb.softmax(logits))
    if quantizable_only:
        return gb

    q = resolution // 4
    a, b = op(OpCode.SPLIT, [p], n_outputs=2, axis=-1)
    lo, hi = op(OpCode.MINIMUM, [a, b]), op(OpCode.MAXIMUM, [a, b])
    sq = op(OpCode.SQUARED_DIFFERENCE, [lo, hi])
    sq = op(OpCode.STRIDED_SLICE, [sq], begin=[0, 0, 0, 0],
            end=[1, q, q, 4], strides=[1, 2, 2, 1])  # (1, R/8, R/8, 4)
    g = gb.gelu(gb.silu(sq))
    r = gb.unary(OpCode.RSQRT, gb.unary(OpCode.EXP, gb.unary(OpCode.NEG, g)))
    r = gb.unary(OpCode.LEAKY_RELU, gb.sub(r, const((4,), 0.5, "centre")))
    r = gb.dropout(gb.identity(r))
    seq = gb.reshape(r, (1, (q // 2) ** 2, 4))
    seq = gb.layer_norm(seq, const((4,), 1.0, "ln_g"),
                        const((4,), 0.1, "ln_b"))
    keys = gb.matmul(seq, const((4, 16), 0.5, "proj"))   # (1, N, 16)
    ids = gb.input("ids", (1, 8), "int32")
    e = gb.rms_norm(gb.embedding(ids, const((50, 16), 1.0, "table")),
                    const((16,), 1.0, "emb_g"))
    e = gb.reshape(gb.rope(gb.reshape(e, (1, 8, 2, 8))), (1, 8, 16))
    scores = op(OpCode.BATCH_MATMUL, [e, keys], transpose_b=True)
    gb.mark_output(gb.mean(scores, axes=[2]))       # (1, 8)
    return gb

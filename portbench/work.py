"""The yardstick's counts: FLOPs and bytes of a decode step, a prefill,
a train step and a K4 (paged decode attention) launch, from a
configuration file's shapes and the step's batch and lengths.

The count is the work the step needs, whatever implements it: each input
byte read once, each output byte written once, matrix products at 2
FLOPs a multiply-add, attention over the causal positions only, the
vocabulary unpadded.  A MoE step reads the weights of the experts its
tokens route to; with ``t`` tokens each routed to ``k`` of ``E`` experts,
uniformly, that is ``E (1 - (1 - k/E)^t)`` experts a layer in
expectation (99.8% of them at t = 64, k = 6, E = 64).  Frozen here, so
that no change to the program can make them stale.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA's data sheet, H100 SXM, dense: bf16 tensor cores and HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _dims(conf: Dict):
    m = conf["model"]
    d, h = m["hidden_size"], m["num_attention_heads"]
    dh = m.get("head_dim") or d // h
    return m, d, h, m["num_key_value_heads"], dh


def elem_bytes(conf: Dict) -> int:
    return 2 if conf["model"].get("torch_dtype") == "bfloat16" else 4


def layer_counts(conf: Dict):
    """(layers, dense layers, MoE layers), as ``weights.layer_prefixes``
    lists them."""
    m = conf["model"]
    n = m["num_hidden_layers"]
    if not m.get("n_routed_experts"):
        return n, n, 0
    first = 1 if m.get("first_k_dense_replace", 0) == 1 else 0
    return n, first, n - first


def params(conf: Dict) -> Dict[str, int]:
    """Parameter counts by part, the vocabulary unpadded: ``embed``,
    ``head`` (with the final norm), ``attn`` and ``norms`` over all
    layers, ``dense_mlp``, ``shared``, ``router`` and ``expert`` (ONE
    routed expert of one layer) and ``moe_layers``."""
    m, d, h, kh, dh = _dims(conf)
    v = m["vocab_size"]
    n, n_dense, n_moe = layer_counts(conf)
    out = {"embed": v * d,
           "head": d + (0 if m.get("tie_word_embeddings") else v * d),
           "attn": n * (2 * d * h * dh + 2 * d * kh * dh),
           "norms": n * 2 * d,
           "dense_mlp": n_dense * 3 * d * m["intermediate_size"],
           "shared": 0, "router": 0, "expert": 0, "moe_layers": n_moe,
           "experts": 0, "top_k": 0}
    if n_moe:
        fe = m["moe_intermediate_size"]
        out.update(shared=n_moe * 3 * d * fe * m.get("n_shared_experts", 0),
                   router=n_moe * d * m["n_routed_experts"],
                   expert=3 * d * fe, experts=m["n_routed_experts"],
                   top_k=m["num_experts_per_tok"])
    return out


def n_params(conf: Dict) -> int:
    """Every parameter of the model, the final norm included."""
    p = params(conf)
    return (p["embed"] + p["head"] + p["attn"] + p["norms"]
            + p["dense_mlp"] + p["shared"] + p["router"]
            + p["moe_layers"] * p["experts"] * p["expert"])


def n_active(conf: Dict) -> int:
    """The parameters one token runs through (its top-k routed experts
    of each MoE layer)."""
    p = params(conf)
    return n_params(conf) - p["moe_layers"] * (p["experts"] - p["top_k"]) \
        * p["expert"]


def kv_bytes_per_position(conf: Dict) -> int:
    """K and V of one position over every layer."""
    m, d, h, kh, dh = _dims(conf)
    return 2 * m["num_hidden_layers"] * kh * dh * elem_bytes(conf)


def experts_touched(conf: Dict, tokens: float) -> float:
    p = params(conf)
    if not p["moe_layers"]:
        return 0.0
    e, k = p["experts"], p["top_k"]
    return e * (1.0 - (1.0 - k / e) ** tokens)


def _layer_matmul_params(conf: Dict, experts_per_token: float) -> int:
    """Parameters of the layers that take part in a token's matrix
    products, ``experts_per_token`` routed experts a MoE layer."""
    p = params(conf)
    return (p["attn"] + p["dense_mlp"] + p["shared"] + p["router"]
            + p["moe_layers"] * experts_per_token * p["expert"])


def _head_matmul_params(conf: Dict) -> int:
    """The head's product: the hidden width times the vocabulary."""
    m = conf["model"]
    return m["hidden_size"] * m["vocab_size"]


def _weights_read(conf: Dict, tokens: float) -> float:
    """Bytes of the weights a step over ``tokens`` tokens reads: every
    layer's but the routed experts its tokens do not reach, the head,
    and the tokens' embedding rows."""
    m, d, *_ = _dims(conf)
    p = params(conf)
    dense = p["head"] + p["attn"] + p["norms"] + p["dense_mlp"] \
        + p["shared"] + p["router"]
    return (elem_bytes(conf) * (dense + tokens * d
                                + p["moe_layers"] * p["expert"]
                                * experts_touched(conf, tokens)))


def decode_step(conf: Dict, tokens: int, context: int) -> Tuple[float,
                                                                float]:
    """(FLOPs, bytes) of one decode step over ``tokens`` sequences whose
    attended positions (each sequence's length with the new token) sum to
    ``context``."""
    m, d, h, kh, dh = _dims(conf)
    n = m["num_hidden_layers"]
    flops = (2 * tokens * (_layer_matmul_params(conf, params(conf)["top_k"])
                           + _head_matmul_params(conf))
             + 4 * n * h * dh * context)
    nbytes = (_weights_read(conf, tokens)
              + context * kv_bytes_per_position(conf)
              + tokens * m["vocab_size"] * elem_bytes(conf))
    return float(flops), float(nbytes)


def prefill(conf: Dict, length: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one prefill of ``length`` true prompt tokens:
    every token through every layer, causal attention, the last token's
    logits; its K and V written."""
    m, d, h, kh, dh = _dims(conf)
    n = m["num_hidden_layers"]
    flops = (2 * length * _layer_matmul_params(conf, params(conf)["top_k"])
             + 2 * _head_matmul_params(conf)
             + 2 * n * h * dh * length * (length + 1))
    nbytes = (_weights_read(conf, length)
              + length * kv_bytes_per_position(conf)
              + m["vocab_size"] * elem_bytes(conf))
    return float(flops), float(nbytes)


def train_step(conf: Dict, batch: int, seq: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one train step on ``batch`` rows of ``seq``
    tokens: PaLM's count (appendix B: 6 N a token, N the parameters in
    the matrix products) with the attention term taken over the causal
    positions, the recompute of rematerialized layers not counted; bytes
    the weights read forward and backward, the gradients written and
    read, AdamW's float32 moments read and written and the weights
    written."""
    m, d, h, kh, dh = _dims(conf)
    n = m["num_hidden_layers"]
    tokens = batch * seq
    flops = (6 * tokens * (_layer_matmul_params(conf, params(conf)["top_k"])
                           + _head_matmul_params(conf))
             + 3 * batch * 2 * n * h * dh * seq * (seq + 1))
    e = elem_bytes(conf)
    nbytes = n_params(conf) * (2 * e + 2 * e + 4 * 4 + 2 * e)
    return float(flops), float(nbytes)


def k4_bytes(conf: Dict, tokens: int, context: int) -> float:
    """Bytes one decode step's K4 launches (one a layer) need: the valid
    K and V rows of every sequence (``context`` positions in all), each
    sequence's query and its output."""
    m, d, h, kh, dh = _dims(conf)
    e = elem_bytes(conf)
    return float(m["num_hidden_layers"]
                 * (context * 2 * kh * dh * e + tokens * 2 * h * dh * e))


def least_s(flops: float, nbytes: float) -> float:
    """The least time on the H100: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)

"""A configuration file's ``model`` block (the keys of the published
``config.json``, as the cell runs them) as the port's ``ModelConfig``.

Only what the port can run is accepted: a key whose value the port's
model would not follow raises here, so a configuration can never be
run as something other than what its file states."""

from __future__ import annotations

from typing import Any, Dict


def _require(model: Dict[str, Any], key: str, allowed) -> None:
    if model.get(key, allowed[0]) not in allowed:
        raise ValueError(f"{key}={model[key]!r}: the port runs only "
                         f"{allowed}")


def model_config(conf: Dict[str, Any]):
    """The port's ``ModelConfig`` for a configuration file's dict."""
    from repro_torch.models.common import ModelConfig

    m = conf["model"]
    _require(m, "hidden_act", ("silu",))
    _require(m, "rope_scaling", (None,))
    moe = bool(m.get("n_routed_experts"))
    if moe:
        _require(m, "moe_layer_freq", (1,))
        _require(m, "first_k_dense_replace", (0, 1))
        _require(m, "scoring_func", ("softmax",))
        # the port renormalizes the top-k weights (lm._route)
        _require(m, "norm_topk_prob", (True,))
    d, h = m["hidden_size"], m["num_attention_heads"]
    first_dense = moe and m.get("first_k_dense_replace", 0) == 1
    return ModelConfig(
        arch_id=conf["arch"],
        family="moe" if moe else "dense",
        n_layers=m["num_hidden_layers"],
        d_model=d,
        n_heads=h,
        n_kv_heads=m["num_key_value_heads"],
        head_dim=m.get("head_dim") or d // h,
        d_ff=0 if moe else m["intermediate_size"],
        vocab=m["vocab_size"],
        rope_base=float(m["rope_theta"]),
        sliding_window=None,
        act="silu",
        norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m.get("tie_word_embeddings", False)),
        n_experts=m.get("n_routed_experts", 0),
        top_k=m.get("num_experts_per_tok", 0),
        n_shared_experts=m.get("n_shared_experts", 0),
        moe_d_ff=m.get("moe_intermediate_size", 0),
        first_layer_dense_ff=m["intermediate_size"] if first_dense else 0,
        capacity_factor=float(conf.get("assumed", {})
                              .get("capacity_factor", 1.25)),
        dtype="bfloat16" if m.get("torch_dtype") == "bfloat16"
        else "float32",
        source=conf.get("paper", conf.get("source", "")))

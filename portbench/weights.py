"""The weights of a cell, made from ``--seed`` on the device.

Both sides take them from here: the program gets them as its model's
parameters, and the reference draws them again from the same seed, one
group at a time, so it reads nothing the program holds.  A group is the
embedding, the head with the final norm, or one layer; each is one flat
buffer in the served dtype filled by one ``normal_`` call (float32
leaves, the MoE router, by a second), and its leaves are views of it,
scaled in place.  The parameter names and shapes are the port's
(``models/lm.py``'s ``DenseLM``), which is also the layout the reference
reads them in.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import torch

ONES = "ones"
VOCAB_PAD = 2048


def vocab_rows(conf: dict) -> int:
    """Rows of the embedding and columns of the head: the vocabulary
    padded to a multiple of 2,048, as the port holds it."""
    v = conf["model"]["vocab_size"]
    return conf.get("assumed", {}).get("vocab_rows",
                                       -(-v // VOCAB_PAD) * VOCAB_PAD)


def dtype_of(conf: dict) -> torch.dtype:
    return (torch.bfloat16 if conf["model"].get("torch_dtype") == "bfloat16"
            else torch.float32)


def _mlp(prefix: str, d: int, f: int, lead=()) -> List[tuple]:
    return [(f"{prefix}.wi", (*lead, d, f), 1 / math.sqrt(d), None),
            (f"{prefix}.wg", (*lead, d, f), 1 / math.sqrt(d), None),
            (f"{prefix}.wo", (*lead, f, d), 1 / math.sqrt(f), None)]


def layer_leaves(conf: dict, prefix: str, moe: bool) -> List[tuple]:
    """(name, shape, std or ONES, dtype or None for the served one) of
    one layer's parameters."""
    m = conf["model"]
    d, h, kh = m["hidden_size"], m["num_attention_heads"], \
        m["num_key_value_heads"]
    dh = m.get("head_dim") or d // h
    out = [(f"{prefix}.ln1", (d,), ONES, None),
           (f"{prefix}.ln2", (d,), ONES, None),
           (f"{prefix}.attn.wq", (d, h, dh), 1 / math.sqrt(d), None),
           (f"{prefix}.attn.wk", (d, kh, dh), 1 / math.sqrt(d), None),
           (f"{prefix}.attn.wv", (d, kh, dh), 1 / math.sqrt(d), None),
           (f"{prefix}.attn.wo", (h, dh, d), 1 / math.sqrt(h * dh), None)]
    if not moe:
        return out + _mlp(f"{prefix}.mlp", d, m["intermediate_size"])
    e, fe = m["n_routed_experts"], m["moe_intermediate_size"]
    out.append((f"{prefix}.moe.router", (d, e), 0.02, torch.float32))
    out += _mlp(f"{prefix}.moe.experts", d, fe, lead=(e,))
    if m.get("n_shared_experts"):
        out += _mlp(f"{prefix}.moe.shared", d, m["n_shared_experts"] * fe)
    return out


def layer_prefixes(conf: dict) -> List[Tuple[str, bool]]:
    """(name prefix, is MoE) of each layer in cache order: a dense first
    block (``first_k_dense_replace``), then ``layers.i``."""
    m = conf["model"]
    moe = bool(m.get("n_routed_experts"))
    first = moe and m.get("first_k_dense_replace", 0) == 1
    out = [("first_block", False)] if first else []
    n = m["num_hidden_layers"] - len(out)
    return out + [(f"layers.{i}", moe) for i in range(n)]


def groups(conf: dict) -> List[Tuple[str, List[tuple]]]:
    """Every group of leaves: embedding, each layer, head."""
    m = conf["model"]
    d, vp = m["hidden_size"], vocab_rows(conf)
    out = [("embed", [("embed", (vp, d), 0.02, None)])]
    out += [(p, layer_leaves(conf, p, moe)) for p, moe in
            layer_prefixes(conf)]
    head = [("final_norm", (d,), ONES, None)]
    if not m.get("tie_word_embeddings"):
        head.append(("lm_head", (d, vp), 0.02, None))
    return out + [("head", head)]


def _seed(seed: int, index: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + index) % (1 << 63)


def group_tensors(conf: dict, seed: int, index: int,
                  device) -> Dict[str, torch.Tensor]:
    """Group ``index``'s tensors, drawn from ``seed``: the same values on
    every call with the same arguments on the same kind of device."""
    served = dtype_of(conf)
    leaves = groups(conf)[index][1]
    gen = torch.Generator(device).manual_seed(_seed(seed, index))
    out: Dict[str, torch.Tensor] = {}
    for dtype in (served, torch.float32):
        mine = [lf for lf in leaves if (lf[3] or served) == dtype
                and lf[0] not in out]
        if not mine:
            continue
        flat = torch.empty(sum(math.prod(s) for _, s, _, _ in mine),
                           dtype=dtype, device=device)
        flat.normal_(generator=gen)
        at = 0
        for name, shape, std, _ in mine:
            t = flat[at:at + math.prod(shape)].view(shape)
            at += t.numel()
            if std == ONES:
                t.fill_(1)
            else:
                t.mul_(std)
            out[name] = t
    return out


def all_groups(conf: dict, seed: int, device
               ) -> Iterator[Tuple[int, str, Dict[str, torch.Tensor]]]:
    for i, (gname, _) in enumerate(groups(conf)):
        yield i, gname, group_tensors(conf, seed, i, device)


def fill_module(module: torch.nn.Module, conf: dict, seed: int,
                device) -> torch.nn.Module:
    """Give an empty module (built on ``meta``) the seed's weights: each
    parameter becomes a view of its group's buffer."""
    names = {n for n, _ in module.named_parameters()}
    made = set()
    for _, _, tensors in all_groups(conf, seed, device):
        for name, t in tensors.items():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name \
                else module
            old = getattr(owner, leaf)
            if tuple(old.shape) != tuple(t.shape) or old.dtype != t.dtype:
                raise ValueError(f"{name}: the program holds {old.dtype} "
                                 f"{tuple(old.shape)}, the configuration "
                                 f"gives {t.dtype} {tuple(t.shape)}")
            setattr(owner, leaf, torch.nn.Parameter(t, requires_grad=False))
            made.add(name)
    if made != names:
        raise ValueError(f"parameters the configuration does not give: "
                         f"{sorted(names - made)}; given but not held: "
                         f"{sorted(made - names)}")
    return module

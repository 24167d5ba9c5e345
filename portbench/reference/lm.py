"""The plain reference of the dense and MoE decoder LMs, float32.

Written from the published descriptions (Yi-6B: arXiv:2403.04652, the
Llama layout; DeepSeekMoE: arXiv:2401.06066) and a configuration file's
``model`` block, with no kernel, cache or batching: pre-norm layers of
RMSNorm, rotary attention (the half-split rotation, grouped K/V heads),
a SwiGLU MLP or a MoE of softmax top-k routed experts (renormalized
where ``norm_topk_prob``) plus shared experts, then RMSNorm and the head.
The weights come from ``portbench.weights`` (the seed's draws, widened to
float32), one layer at a time, so a model runs layer by layer over every
sequence it is given and never holds more than one layer's weights.

``lowp="fp8"`` is the control: every matrix product of the layers and
the head takes its operands rounded to float8 e4m3 (per row of the
activations, per output column of the weights, each scaled to its
largest entry), the step below the bfloat16 the configurations state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from portbench import weights

FP8_MAX = 448.0
ATTN_CHUNK = 512


def set_precision() -> None:
    """True float32 products: TF32 off (a float32 product may run in it
    on the card otherwise)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the largest |entry| maps to 448), back in float32."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / FP8_MAX
    q = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, lowp: Optional[str]) -> torch.Tensor:
    """x (..., K) @ w (K, M), in float8 operands under ``lowp``."""
    if lowp == "fp8":
        x, w = fp8(x, -1), fp8(w, 0)
    elif lowp is not None:
        raise ValueError(f"unknown precision {lowp!r}")
    return x @ w


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, base: float) -> torch.Tensor:
    """x (..., S, H, dh) rotated at positions 0..S-1: the first and second
    halves of each head vector are the pairs' two coordinates, angles
    position · base^(-2i/dh), computed in float64."""
    s, dh = x.shape[-3], x.shape[-1]
    half = dh // 2
    inv = base ** (-torch.arange(half, dtype=torch.float64,
                                 device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    c = torch.cos(ang).to(x.dtype)[:, None, :]
    sn = torch.sin(ang).to(x.dtype)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * sn, x2 * c + x1 * sn], dim=-1)


def _attend_chunk(q, k, v, start: int):
    """Causal attention of the queries at positions start.. over k, v
    (..., H, S, dh); softmax in float32."""
    c, s = q.shape[-2], k.shape[-2]
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    qpos = torch.arange(start, start + c, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    logits = logits.masked_fill(kpos > qpos, float("-inf"))
    return torch.softmax(logits, dim=-1) @ v


def attention(x: torch.Tensor, w: Dict[str, torch.Tensor], p: str,
              m: Dict, lowp: Optional[str], checkpoint: bool = False):
    """x (..., S, D) -> the attention output (..., S, D)."""
    d = x.shape[-1]
    h, kh = m["num_attention_heads"], m["num_key_value_heads"]
    dh = w[f"{p}.attn.wq"].shape[-1]
    lead = x.shape[:-1]
    q = mm(x, w[f"{p}.attn.wq"].reshape(d, -1), lowp).view(*lead, h, dh)
    k = mm(x, w[f"{p}.attn.wk"].reshape(d, -1), lowp).view(*lead, kh, dh)
    v = mm(x, w[f"{p}.attn.wv"].reshape(d, -1), lowp).view(*lead, kh, dh)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    k = k.repeat_interleave(h // kh, dim=-2)
    v = v.repeat_interleave(h // kh, dim=-2)
    q, k, v = (t.transpose(-3, -2) for t in (q, k, v))    # (..., H, S, dh)
    outs = []
    for start in range(0, q.shape[-2], ATTN_CHUNK):
        qc = q[..., start:start + ATTN_CHUNK, :]
        if checkpoint:
            outs.append(torch.utils.checkpoint.checkpoint(
                _attend_chunk, qc, k, v, start, use_reentrant=False))
        else:
            outs.append(_attend_chunk(qc, k, v, start))
    out = torch.cat(outs, dim=-2).transpose(-3, -2).reshape(*lead, h * dh)
    return mm(out, w[f"{p}.attn.wo"].reshape(h * dh, d), lowp)


def swiglu(x: torch.Tensor, wi, wg, wo, lowp: Optional[str]) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(x, wg, lowp)) * mm(x, wi, lowp),
              wo, lowp)


def moe(x: torch.Tensor, w: Dict[str, torch.Tensor], p: str, m: Dict,
        lowp: Optional[str]) -> torch.Tensor:
    """x (N, D): softmax routing over the experts in float32, each token
    to its top k, weights renormalized where ``norm_topk_prob``; the
    shared experts on every token."""
    probs = torch.softmax(x @ w[f"{p}.moe.router"], dim=-1)
    top_w, top_i = torch.topk(probs, m["num_experts_per_tok"], dim=-1)
    if m.get("norm_topk_prob"):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    wi, wg, wo = (w[f"{p}.moe.experts.{n}"] for n in ("wi", "wg", "wo"))
    for e in range(wi.shape[0]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel():
            out = swiglu(x[rows], wi[e], wg[e], wo[e], lowp)
            y = y.index_add(0, rows, out * top_w[rows, slot][:, None])
    if m.get("n_shared_experts"):
        y = y + swiglu(x, w[f"{p}.moe.shared.wi"], w[f"{p}.moe.shared.wg"],
                       w[f"{p}.moe.shared.wo"], lowp)
    return y


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], p: str, is_moe: bool,
          m: Dict, lowp: Optional[str] = None,
          checkpoint: bool = False) -> torch.Tensor:
    """One pre-norm layer over x (..., S, D)."""
    eps = m["rms_norm_eps"]
    h = x + attention(rms_norm(x, w[f"{p}.ln1"], eps), w, p, m, lowp,
                      checkpoint)
    hin = rms_norm(h, w[f"{p}.ln2"], eps)
    if is_moe:
        shape = hin.shape
        return h + moe(hin.reshape(-1, shape[-1]), w, p, m,
                       lowp).view(shape)
    return h + swiglu(hin, w[f"{p}.mlp.wi"], w[f"{p}.mlp.wg"],
                      w[f"{p}.mlp.wo"], lowp)


def widened(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.float() for n, t in tensors.items()}


@torch.no_grad()
def logits_at(conf: Dict, seed: int, seqs: Sequence[torch.Tensor],
              starts: Sequence[int], device, lowp: Optional[str] = None
              ) -> List[torch.Tensor]:
    """The reference's float32 logits over the true vocabulary at
    positions ``starts[i]`` .. ``len(seqs[i]) - 1`` of each sequence (the
    logits that predict the tokens after them), the model run layer by
    layer over every sequence, its weights drawn from ``seed``."""
    set_precision()
    m = conf["model"]
    prefixes = weights.layer_prefixes(conf)
    n_groups = len(weights.groups(conf))
    emb = weights.group_tensors(conf, seed, 0, device)["embed"]
    hs = [emb[s.to(device).long()].float() for s in seqs]
    del emb
    for li, (p, is_moe) in enumerate(prefixes):
        w = widened(weights.group_tensors(conf, seed, li + 1, device))
        hs = [layer(h, w, p, is_moe, m, lowp) for h in hs]
        del w
    head = widened(weights.group_tensors(conf, seed, n_groups - 1, device))
    out_w = head.get("lm_head")
    if out_w is None:                       # tied: the embedding's rows
        out_w = weights.group_tensors(conf, seed, 0,
                                      device)["embed"].float().t()
    out_w = out_w[:, :m["vocab_size"]]
    return [mm(rms_norm(h[st:], head["final_norm"], m["rms_norm_eps"]),
               out_w, lowp) for h, st in zip(hs, starts)]

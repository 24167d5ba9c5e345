"""Shared model-config schema and primitive layers for the pod path.

The port's counterpart of ``repro.models.common``: the same
``ModelConfig`` (``torch_dtype()`` in place of ``jnp_dtype()``) and the
primitives the LM families are built from, as plain functions on
tensors.  Parameters live in ``nn.Module``s (``lm.DenseLM``); random
draws take an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    # attention details
    qk_norm: bool = False
    rope_base: float = 10000.0
    sliding_window: Optional[int] = None   # decode window for long_500k
    prefix_lm: bool = False                # PaliGemma-style prefix masking
    # activation / norm
    act: str = "silu"               # silu (SwiGLU) | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_layer_dense_ff: int = 0   # deepseek: dense layer 0
    capacity_factor: float = 1.25
    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    # hybrid (Zamba2): shared attention block period
    shared_attn_every: int = 0
    # enc-dec (Whisper)
    n_encoder_layers: int = 0
    n_audio_ctx: int = 0            # encoder positions (stub frontend)
    # VLM (PaliGemma)
    n_vision_tokens: int = 0        # patch embeddings from the stub
    d_vision: int = 1152            # SigLIP-So400m width (stub output)
    # numerics
    dtype: str = "bfloat16"
    # provenance
    source: str = ""

    @property
    def dh(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def ssm_heads(self) -> int:
        return (self.ssm_expand * self.d_model) // self.ssm_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def n_params(self) -> int:
        """The analytic parameter count of the JAX package's
        ``ModelConfig.n_params`` (the N of MODEL_FLOPS = 6·N·D), term for
        term: the unpadded vocabulary, no norms but two a layer, the
        hybrid's shared block counted once."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * self.n_heads * self.dh + 2 * d * self.n_kv_heads * self.dh \
            + self.n_heads * self.dh * d
        if self.family == "ssm":
            total = emb + self.n_layers * self._ssm_block_params()
        elif self.family == "hybrid":
            shared = attn + 3 * d * self.d_ff + 4 * d
            total = emb + self.n_layers * self._ssm_block_params() + shared
        elif self.family == "moe":
            experts = self.n_experts * 3 * d * self.moe_d_ff
            moe = (experts + self.n_shared_experts * 3 * d * self.moe_d_ff
                   + d * self.n_experts)
            total = emb + self.n_layers * (attn + moe + 2 * d)
            if self.first_layer_dense_ff:
                total += 3 * d * self.first_layer_dense_ff \
                    - (experts + d * self.n_experts)
        else:
            ff_mult = 3 if self.act == "silu" else 2
            per_layer = attn + ff_mult * d * self.d_ff + 2 * d
            total = emb + (self.n_layers + self.n_encoder_layers) * per_layer
            if self.n_encoder_layers:            # cross-attention
                total += self.n_layers * attn
        return int(total)

    def n_active_params(self) -> int:
        """The parameters a token runs through (MoE: its top_k routed
        experts of every layer's n_experts; every other family: all)."""
        if self.family != "moe":
            return self.n_params()
        per_expert = self.n_layers * 3 * self.d_model * self.moe_d_ff
        return int(self.n_params() - (self.n_experts - self.top_k)
                   * per_expert)

    def _ssm_block_params(self) -> int:
        d, di = self.d_model, self.d_inner
        n, g, h = self.ssm_state, self.ssm_groups, self.ssm_heads
        in_proj = d * (2 * di + 2 * g * n + h)
        conv = (di + 2 * g * n) * self.ssm_conv
        return in_proj + conv + 3 * h + di * d + d


# ---------------------------------------------------------------------------
# primitives (plain functions on tensors)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Normalise in float32, cast back to x's dtype, then scale."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = (xf * torch.rsqrt(ms + eps)).to(x.dtype)
    return y * gamma.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Normalise in float32, cast back to x's dtype, then scale and
    shift."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * gamma.to(x.dtype) + beta.to(x.dtype)


def rope_cos_sin(positions: torch.Tensor, dim: int, base: float,
                 dtype: torch.dtype = torch.float32
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin (..., dim//2)."""
    half = dim // 2
    inv = base ** (-torch.arange(half, dtype=torch.float32,
                                 device=positions.device) / half)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); cos/sin: (S, D//2), (..., S, D//2), or
    broadcastable with a head axis already in place.  A missing head
    axis is inserted: without it, per-slot decode positions of shape
    (B, 1, D//2) would right-align against (B, S, H, D//2) and rotate
    every slot by slot 0's position."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.dim() < x.dim():                # (..., S, half): add head axis
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    c = cos.to(x.dtype)
    s = sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,S,V) upcast to float32, cross-entropy against labels
    (B,S): the JAX function's steps — a detached max, a hand-rolled
    logsumexp, and the gold logit picked by a mask on the vocab index —
    then the mean over the ``mask``-weighted positions (at least 1).
    Inside a training context whose data axes hold more than one rank
    (``distributed.act_sharding``) the numerator and the count are summed
    over them first, so the loss is one device's over the whole batch,
    not a mean of the ranks' means."""
    logits = logits.float()
    m = logits.max(dim=-1, keepdim=True).values.detach()
    logz = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    iota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(iota == labels[..., None], logits, 0.0).sum(dim=-1)
    return _masked_mean(logz - gold, mask)


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 mask: Optional[torch.Tensor],
                                 comm) -> torch.Tensor:
    """``cross_entropy_loss`` of the logits over the whole padded
    vocabulary, from this rank's block of it: ``logits`` (B,S,V/m) are
    the columns [r·V/m, (r+1)·V/m) of ``comm``'s rank r (the vocab-
    parallel head's output), ``labels`` (B,S) index the whole padded
    vocabulary.  The JAX function's steps with three (B,S) all-reduces
    over ``comm`` in place of GSPMD's: the max of the blocks' maxima
    (detached, the raw ``Comm.all_reduce`` outside autograd, as JAX's
    ``stop_gradient``), the sum of exp(block - max) and the gold logit,
    which only the rank whose block holds the label contributes (the
    other ranks' where-sums are 0).  Both sums go through the
    differentiable ``collectives.all_reduce``, so every rank computes the
    same loss and its block's gradient is that block of the whole
    logits' gradient.  Masking and the data axes' sums are
    ``cross_entropy_loss``'s."""
    # imported here: distributed.sharding imports this module
    from repro_torch.distributed import collectives
    logits = logits.float()
    m = comm.all_reduce(logits.detach().amax(dim=-1, keepdim=True),
                        dist.ReduceOp.MAX)
    sumexp = collectives.all_reduce(comm,
                                    torch.exp(logits - m).sum(dim=-1))
    logz = m[..., 0] + torch.log(sumexp)
    n = logits.shape[-1]
    iota = comm.rank * n + torch.arange(n, device=logits.device)
    gold = collectives.all_reduce(comm, torch.where(
        iota == labels[..., None], logits, 0.0).sum(dim=-1))
    return _masked_mean(logz - gold, mask)


def _masked_mean(nll: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The mean of ``nll`` (B,S) over the ``mask``-weighted positions (at
    least 1); over every data rank's rows inside a training context whose
    data axes hold more than one rank."""
    # imported here: distributed.sharding imports this module
    from repro_torch.distributed import act_sharding, collectives
    ctx = act_sharding.current()
    data = ctx.data if ctx is not None else None
    if data is None:
        if mask is not None:
            return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return nll.mean()
    # a data-sharded batch: the masked mean over every data rank's rows
    num = (nll * mask).sum() if mask is not None else nll.sum()
    den = mask.sum() if mask is not None else nll.new_tensor(nll.numel())
    num = collectives.all_reduce(data, num)
    den = collectives.all_reduce(data, den.detach().clone())
    return num / torch.clamp(den, min=1.0)


def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normal(0, scale) drawn in float32 on the generator's device, then
    cast.  ``scale`` defaults to 1/sqrt(fan_in) with fan_in = shape[0],
    the JAX package's rule."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(fan_in)
    out = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                      device=gen.device)
    return out.mul_(scale).to(dtype)

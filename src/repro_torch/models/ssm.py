"""Mamba-2 (SSD — state-space duality) family [arXiv:2405.21060].

The port's counterpart of ``repro.models.ssm``: Mamba2-780m.  The
parameters keep the JAX package's layouts (``in_proj`` (D, 2·di+2·G·N+H),
``conv_w`` (K, di+2·G·N), ``out_proj`` (di, D), float32 ``dt_bias``,
``A_log`` and ``D`` (H,)) in one ``SSMLM`` module holding one
``MambaBlock`` per layer, where the JAX package stacks a leading ``L``
dim and scans.  The steps are plain functions on tensors:

  * ``ssm_prefill`` — a prompt through every layer, emitting the
    last-token logits and the recurrent cache: the pre-activation conv
    window ``conv`` (L,B,K-1,C) and the SSD state ``state``
    (L,B,G,H/G,P,N) in float32, batch on axis 1;
  * ``ssm_prefill_chunk`` — one right-padded prompt chunk continuing a
    batch=1 cache, written in place: the padded tail is an exact no-op
    (its dt is 0, and the conv window ends at the last real token);
  * ``ssm_decode`` — one token per sequence, O(1) in the context: the
    conv window and the state are updated in place;
  * ``ssm_loss`` — the training loss through ``ssm_backbone``, always on
    the plain ``ssd_chunked`` (K8 has no backward).

On a mesh (``distributed.sharding.shard_params``) every rank computes
the whole ``in_proj`` and causal conv (their weights stay whole), runs
the scan on its block of the SSD heads (the state's ``gh`` axis split),
and the gated norm, which reduces over all of ``d_inner``, sums its
squares over the ranks before the scale; ``out_proj`` is row-parallel.
In training those collectives are differentiable
(``distributed.collectives``): the whole tensors that feed a rank's own
heads or channels (the conv output, dt, z, and the per-head ``dt_bias``,
``A_log`` and ``D``) take the copy-in, so ``in_proj``, the conv and
everything before them get the gradient of every head, and the
layer's FSDP-sharded weights are gathered as it starts
(``act_sharding.gathered``).

The chunked scan is ``ssd_chunked`` (plain PyTorch); the prefill steps
take ``ssd_impl=`` in its place, the vendor-kernel hook (§4.8) through
which the ``"cuda"`` serving ops run the scan on K8 (``kernels.ops``),
as ``lm_decode`` takes ``attn_impl``.  ``ssd_chunked`` keeps the JAX
function's contract: the chunk is ``min(chunk, S)`` and S must be a
multiple of it, so a one-shot prefill takes prompts of at most 128
tokens or a multiple of 128, and longer ones go through
``prefill_chunk=`` in the engine.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.executor import resolve_device
from repro_torch.distributed import act_sharding as acts
from repro_torch.distributed import collectives as C

from .common import ModelConfig, dense_init, rms_norm
from .lm import (NEG_INF, _param, checkpointed, embed_tokens, lm_logits,
                 masked_ce, padded_vocab)

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# the model: parameters only, in the JAX package's layouts
# ---------------------------------------------------------------------------

class MambaBlock(nn.Module):
    """One Mamba-2 layer: ln → in_proj → causal conv → SSD → gated norm →
    out_proj.  ``dt_bias``, ``A_log`` and ``D`` are float32 whatever the
    model's dtype, as in the JAX package."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di = cfg.d_model, cfg.d_inner
        g, n, h, k = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
        conv_ch = di + 2 * g * n
        self.in_proj = _param((d, 2 * di + 2 * g * n + h), dtype, device)
        self.conv_w = _param((k, conv_ch), dtype, device)
        self.conv_b = _param((conv_ch,), dtype, device)
        self.dt_bias = _param((h,), torch.float32, device)
        self.A_log = _param((h,), torch.float32, device)
        self.D = _param((h,), torch.float32, device)
        self.norm = _param((di,), dtype, device)
        self.out_proj = _param((di, d), dtype, device)
        self.ln = _param((d,), dtype, device)


class SSMLM(nn.Module):
    """The pure-SSM LM's parameters: embedding (V_pad, D), one MambaBlock
    per layer, final norm and (untied) head (D, V_pad).  Built empty on
    ``device`` (the card by default; raises without one — pass ``"cpu"``
    for the CPU); ``init_ssm_lm`` or ``registry.params_from_jax`` fills it."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        dtype, vp, d = cfg.torch_dtype(), padded_vocab(cfg), cfg.d_model
        self.cfg = cfg
        self.embed = _param((vp, d), dtype, device)
        self.final_norm = _param((d,), dtype, device)
        self.layers = nn.ModuleList(MambaBlock(cfg, dtype, device)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _param((d, vp), dtype, device)


def _dt_bias(cfg: ModelConfig, n_layers: int) -> np.ndarray:
    """The JAX init's dt_bias (L, H): dt log-uniform in [1e-3, 1e-1] from
    numpy seed 7, through the inverse softplus — the same numbers in both
    packages."""
    rng = np.random.default_rng(7)
    dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1),
                            (n_layers, cfg.ssm_heads)))
    return (dt + np.log(-np.expm1(-dt))).astype(np.float32)


def init_mamba_block(gen: torch.Generator, blk: MambaBlock, cfg: ModelConfig,
                     dt_bias: np.ndarray) -> None:
    """Seeded random weights for one layer, following the JAX
    ``init_ssm_block``'s rules leaf by leaf with each leaf's own fan-in
    (the JAX package draws the stacked (L, …) leaves, so its ``in_proj``
    fan-in is L; ROADMAP queue 3)."""
    dtype, h = blk.in_proj.dtype, cfg.ssm_heads
    blk.in_proj.copy_(dense_init(gen, blk.in_proj.shape, dtype=dtype))
    blk.conv_w.copy_(dense_init(gen, blk.conv_w.shape, 0.5, dtype))
    blk.conv_b.zero_()
    blk.dt_bias.copy_(torch.from_numpy(dt_bias))
    blk.A_log.copy_(torch.log(torch.arange(1, h + 1, dtype=torch.float32)
                              / h + 0.5))
    blk.D.fill_(1)
    blk.norm.fill_(1)
    blk.out_proj.copy_(dense_init(gen, blk.out_proj.shape,
                                  1.0 / math.sqrt(cfg.d_inner), dtype))
    blk.ln.fill_(1)


def init_ssm_lm(gen: torch.Generator, cfg: ModelConfig) -> SSMLM:
    """Seeded random weights on ``gen.device``, following the JAX
    ``init_ssm_lm``'s rules (see ``init_mamba_block``)."""
    dtype = cfg.torch_dtype()
    model = SSMLM(cfg, gen.device)
    dt_bias = _dt_bias(cfg, cfg.n_layers)
    with torch.no_grad():
        model.embed.copy_(dense_init(gen, model.embed.shape, 0.02, dtype))
        model.final_norm.fill_(1)
        for i, blk in enumerate(model.layers):
            init_mamba_block(gen, blk, cfg, dt_bias[i])
        if not cfg.tie_embeddings:
            model.lm_head.copy_(dense_init(gen, model.lm_head.shape, 0.02,
                                           dtype))
    return model


# ---------------------------------------------------------------------------
# SSD chunked scan (plain PyTorch; heads grouped for B/C sharing)
# ---------------------------------------------------------------------------

def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H) post-softplus; A (H,) negative; Bm/Cm
    (B,S,G,N); init_state (B,G,H/G,P,N) or None (zeros).  Returns
    (y (B,S,H,P) in x's dtype, final state (B,G,H/G,P,N) float32).  The
    chunk is ``min(chunk, S)`` and S must be a multiple of it, as in the
    JAX function."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    gh = h // g
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {chunk}")
    nc = s // chunk
    xg = x.reshape(b, nc, chunk, g, gh, p)
    dtg = dt.reshape(b, nc, chunk, g, gh)
    bc_all = Bm.reshape(b, nc, chunk, g, n)
    cc_all = Cm.reshape(b, nc, chunk, g, n)
    ag = A.reshape(g, gh)
    state = (torch.zeros((b, g, gh, p, n), dtype=torch.float32,
                         device=x.device)
             if init_state is None else init_state)
    q = torch.arange(chunk, device=x.device)
    causal = (q[:, None] >= q[None, :])[None, :, :, None, None]
    ys = []
    for c in range(nc):
        xc = xg[:, c].float()                               # (B,Q,G,gh,P)
        dtc = dtg[:, c]                                     # (B,Q,G,gh)
        bc, cc = bc_all[:, c].float(), cc_all[:, c].float()  # (B,Q,G,N)
        la = torch.cumsum(dtc * ag, dim=1)                  # log-decay, <0
        # intra-chunk (masked attention-like)
        cb = torch.einsum("bign,bjgn->bgij", cc, bc)
        ldiff = la[:, :, None] - la[:, None]                # (B,i,j,G,gh)
        # mask in log space BEFORE exp: ldiff > 0 for j > i would overflow
        ldiff = torch.where(causal, ldiff, NEG_INF)
        m = torch.exp(ldiff) * dtc[:, None]                 # * dt_j
        m = m * cb.permute(0, 2, 3, 1)[..., None]           # (B,i,j,G,gh)
        y_intra = torch.einsum("bijgh,bjghp->bighp", m, xc)
        # inter-chunk (the state from previous chunks)
        y_inter = (torch.einsum("bign,bghpn->bighp", cc, state)
                   * torch.exp(la)[..., None])
        # state update
        la_end = la[:, -1]                                  # (B,G,gh)
        decay_to_end = torch.exp(la_end[:, None] - la) * dtc
        ds = torch.einsum("bjgn,bjgh,bjghp->bghpn", bc, decay_to_end, xc)
        state = state * torch.exp(la_end)[..., None, None] + ds
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y, state


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token recurrence.  state (B,G,gh,P,N); x_t (B,H,P); dt_t (B,H);
    B_t/C_t (B,G,N).  Returns (y_t (B,H,P), new state)."""
    b, h, p = x_t.shape
    g = B_t.shape[1]
    gh = h // g
    xg = x_t.reshape(b, g, gh, p).float()
    dtg = dt_t.reshape(b, g, gh)
    da = torch.exp(dtg * A.reshape(g, gh))                   # (B,G,gh)
    ds = torch.einsum("bgn,bgh,bghp->bghpn", B_t.float(), dtg, xg)
    state = state * da[..., None, None] + ds
    y = torch.einsum("bgn,bghpn->bghp", C_t.float(), state)
    return y.reshape(b, h, p).to(x_t.dtype), state


# ---------------------------------------------------------------------------
# mamba2 block (conv + SSD + gated norm)
# ---------------------------------------------------------------------------

def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """xbc (B,S,C) depthwise causal conv, kernel (K,C), then SiLU."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s] * w[i][None, None] for i in range(k))
    return F.silu(out + b[None, None])


def _conv_step(conv_cache: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_cache (B,K-1,C); x_t (B,C).  Returns (y_t, new window)."""
    full = torch.cat([conv_cache, x_t[:, None]], dim=1)      # (B,K,C)
    y = torch.einsum("bkc,kc->bc", full, w) + b[None]
    return F.silu(y), full[:, 1:]


def _in_proj(blk: MambaBlock, cfg: ModelConfig, h: torch.Tensor):
    """ln → in_proj → (z, xBC, dt) for h (B,S,D)."""
    b, s, d = h.shape
    xin = rms_norm(h, blk.ln, cfg.norm_eps)
    zxbcdt = (xin.reshape(b * s, d) @ blk.in_proj).view(b, s, -1)
    return _split_proj(cfg, zxbcdt)


def state_heads(blk: nn.Module, cfg: ModelConfig) -> Tuple[int, int]:
    """[lo, hi): the SSD heads whose state this rank carries — all of
    them, or on a mesh its block where the heads divide over the ranks
    (one group: its heads are then its ``d_inner`` block).  ``blk``: a
    Mamba block, or the model (its ``tp`` has the same axis)."""
    h = cfg.ssm_heads
    tp = getattr(blk, "tp", None)
    if tp is None or (h // cfg.ssm_groups) % tp.comm.size:
        return 0, h
    n = h // tp.comm.size
    return tp.comm.rank * n, (tp.comm.rank + 1) * n


def _ssd_inputs(blk: MambaBlock, cfg: ModelConfig, xbc: torch.Tensor,
                dt: torch.Tensor):
    """The conv output and raw dt (B,S,…) as the scan's inputs: xs
    (B,S,H,P), Bm/Cm (B,S,G,N), dt post-softplus (float32) and A, of
    this rank's heads (``state_heads``; the whole tensors feeding them
    take the copy-in)."""
    b, s = xbc.shape[:2]
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    lo, hi = state_heads(blk, cfg)
    dt_bias, a_log = blk.dt_bias, blk.A_log
    if hi - lo < cfg.ssm_heads:
        xbc, dt, dt_bias, a_log = C.copy_in(blk.tp.comm, xbc, dt, dt_bias,
                                            a_log)
    xs = xbc[..., :di].reshape(b, s, cfg.ssm_heads, cfg.ssm_head_dim)
    bm = xbc[..., di:di + g * n].reshape(b, s, g, n)
    cm = xbc[..., di + g * n:].reshape(b, s, g, n)
    dtf = F.softplus(dt.float() + dt_bias)
    a = -torch.exp(a_log)
    if hi - lo < cfg.ssm_heads:
        xs, dtf, a = xs[:, :, lo:hi], dtf[..., lo:hi], a[lo:hi]
    return xs, bm, cm, dtf, a


def _ssd_out(blk: MambaBlock, cfg: ModelConfig, h: torch.Tensor,
             xs: torch.Tensor, y: torch.Tensor,
             z: torch.Tensor) -> torch.Tensor:
    """y (B,S,H,P) + D·x, gated norm, out_proj, residual.  Where
    ``d_inner`` is split over the ranks: the rank's channels of y·silu(z)
    are normalized by the mean square over all of them (its sum of
    squares summed over the ranks), and ``out_proj``'s rows are
    row-parallel."""
    b, s = h.shape[:2]
    lo, hi = state_heads(blk, cfg)
    d_skip = blk.D
    if hi - lo < cfg.ssm_heads:
        z, d_skip = C.copy_in(blk.tp.comm, z, d_skip)
    y = y + xs * d_skip[lo:hi][None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, -1)
    tp = getattr(blk, "tp", None)
    if tp is None or not tp.split:
        y = rms_norm(y * F.silu(z), blk.norm, cfg.norm_eps)
        return h + (y.reshape(b * s, -1) @ blk.out_proj).view(b, s, -1)
    comm = tp.comm
    if y.shape[-1] == cfg.d_inner:          # the state's heads are whole
        y, z = C.copy_in(comm, y, z)
        y = comm.own(y, -1)
    g = y * F.silu(comm.own(z, -1))
    gf = g.float()
    # the sum of squares over every rank's channels scales this rank's
    ss = C.copy_in(comm, C.all_reduce(
        comm, gf.square().sum(dim=-1, keepdim=True)))
    g = (gf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)).to(g.dtype)
    y = g * blk.norm.to(g.dtype)
    out = (y.reshape(b * s, -1) @ blk.out_proj).view(b, s, -1)
    return h + C.all_reduce(comm, out)


def mamba_block(blk: MambaBlock, cfg: ModelConfig, h: torch.Tensor, *,
                ssd_impl=None) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """One layer over a whole prompt h (B,S,D), from an empty state.
    Returns (h out, the pre-activation conv window (B,K-1,C), the SSD
    state (B,G,gh,P,N))."""
    k, s = cfg.ssm_conv, h.shape[1]
    z, xbc, dt = _in_proj(blk, cfg, h)
    conv_tail = F.pad(xbc, (0, 0, max(k - 1 - s, 0), 0))[:, -(k - 1):]
    xbc = _causal_conv(xbc, blk.conv_w, blk.conv_b)
    xs, bm, cm, dtf, a = _ssd_inputs(blk, cfg, xbc, dt)
    y, state = (ssd_impl or ssd_chunked)(xs, dtf, a, bm, cm)
    return _ssd_out(blk, cfg, h, xs, y, z), conv_tail, state


def mamba_decode_block(blk: MambaBlock, cfg: ModelConfig, h: torch.Tensor,
                       conv: torch.Tensor, state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token layer.  h (B,1,D).  Returns (h out, conv, state)."""
    z, xbc, dt = _in_proj(blk, cfg, h)
    xbc, conv = _conv_step(conv, xbc[:, 0], blk.conv_w, blk.conv_b)
    xs, bm, cm, dtf, a = _ssd_inputs(blk, cfg, xbc[:, None], dt)
    y, state = ssd_step(state, xs[:, 0], dtf[:, 0], a, bm[:, 0], cm[:, 0])
    return _ssd_out(blk, cfg, h, xs, y[:, None], z), conv, state


def mamba_chunk_block(blk: MambaBlock, cfg: ModelConfig, h: torch.Tensor,
                      conv: torch.Tensor, state: torch.Tensor, n_real,
                      *, ssd_impl=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer over a right-padded chunk h (B,S,D) with CARRIED state:
    ``conv`` (B,K-1,C) the pre-activation window after the tokens so far,
    ``state`` (B,G,gh,P,N).  The first ``n_real`` rows are real (an int32
    scalar tensor, or a host int); the rest are exact no-ops (dt masked
    to 0: decay 1, input 0) and the window is gathered to end at the last
    real token.  Returns (h out, conv, state)."""
    k, s = cfg.ssm_conv, h.shape[1]
    z, xbc, dt = _in_proj(blk, cfg, h)
    # the causal conv continued from the carried window
    full = torch.cat([conv, xbc], dim=1)                     # (B,K-1+S,C)
    tail = n_real + torch.arange(k - 1, device=h.device)
    new_conv = full.index_select(1, tail)
    out = sum(full[:, i:i + s] * blk.conv_w[i][None, None] for i in range(k))
    xbc = F.silu(out + blk.conv_b[None, None])
    xs, bm, cm, dtf, a = _ssd_inputs(blk, cfg, xbc, dt)
    pos = torch.arange(s, device=h.device)
    dtf = torch.where(pos[None, :, None] < n_real, dtf, 0.0)
    y, state = (ssd_impl or ssd_chunked)(xs, dtf, a, bm, cm,
                                         init_state=state)
    return _ssd_out(blk, cfg, h, xs, y, z), new_conv, state


# ---------------------------------------------------------------------------
# public steps (pure-SSM LM: mamba2-780m)
# ---------------------------------------------------------------------------

def ssm_empty_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device, heads: Optional[int] = None) -> Cache:
    """The zeroed recurrent cache; ``heads``: the SSD heads a rank
    carries, in place of the config's."""
    g, n = cfg.ssm_groups, cfg.ssm_state
    gh, ph = (heads or cfg.ssm_heads) // g, cfg.ssm_head_dim
    conv_ch = cfg.d_inner + 2 * g * n
    L = cfg.n_layers
    return {"conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_ch),
                                dtype=dtype, device=device),
            "state": torch.zeros((L, batch, g, gh, ph, n),
                                 dtype=torch.float32, device=device)}


def ssm_prefill(model: SSMLM, cfg: ModelConfig, tokens: torch.Tensor,
                cache_len: Optional[int] = None, *,
                ssd_impl=None) -> Tuple[torch.Tensor, Cache]:
    """tokens (B,S) -> (last-token logits (B,V_pad), cache {conv, state}).
    ``cache_len`` is not used: the recurrent cache does not grow."""
    x = embed_tokens(model, cfg, tokens)
    lo, hi = state_heads(model, cfg)
    cache = ssm_empty_cache(cfg, x.shape[0], x.dtype, x.device, hi - lo)
    for i, blk in enumerate(model.layers):
        x, cache["conv"][i], cache["state"][i] = mamba_block(
            blk, cfg, x, ssd_impl=ssd_impl)
    return lm_logits(model, cfg, x[:, -1:])[:, 0], cache


def ssm_prefill_chunk(model: SSMLM, cfg: ModelConfig, cache: Cache,
                      tokens: torch.Tensor, n_real, *,
                      ssd_impl=None) -> Cache:
    """Advance a recurrent cache {conv, state} by one right-padded chunk of
    prompt tokens (B,S), of which the first ``n_real`` are real (an int32
    scalar tensor, as in the JAX package, or a host int), in place.  A
    chunk boundary is only a state checkpoint: there are no
    positions, so every chunk of every prompt is the same step.  Returns
    the cache; no logits (the engine hands the last prompt token to
    decode)."""
    x = embed_tokens(model, cfg, tokens)
    for i, blk in enumerate(model.layers):
        x, cache["conv"][i], cache["state"][i] = mamba_chunk_block(
            blk, cfg, x, cache["conv"][i], cache["state"][i], n_real,
            ssd_impl=ssd_impl)
    return cache


def ssm_decode(model: SSMLM, cfg: ModelConfig, cache: Cache,
               tokens: torch.Tensor, lengths: torch.Tensor
               ) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  tokens (B,1); cache {conv, state}, updated in
    place; ``lengths`` is not used (the state is position-free).  Returns
    (logits (B,V_pad), cache)."""
    x = embed_tokens(model, cfg, tokens)
    for i, blk in enumerate(model.layers):
        x, cache["conv"][i], cache["state"][i] = mamba_decode_block(
            blk, cfg, x, cache["conv"][i], cache["state"][i])
    return lm_logits(model, cfg, x)[:, 0], cache


def ssm_backbone(model: SSMLM, cfg: ModelConfig, x: torch.Tensor, *,
                 remat: bool = False) -> torch.Tensor:
    """Embedded input x (B,S,D) through every Mamba layer on the plain
    scan; ``remat`` rematerializes each layer."""
    for blk in model.layers:
        x = mamba_layer(blk, cfg, x, remat=remat)
    return x


def mamba_layer(blk: MambaBlock, cfg: ModelConfig, x: torch.Tensor, *,
                remat: bool = False) -> torch.Tensor:
    """One Mamba layer of the training forward (no cache), rematerialized
    under ``remat``; in a sharded step its weights are gathered inside
    (``act_sharding.gathered``)."""
    def fn(h):
        return mamba_block(acts.gathered(blk), cfg, h)[0]
    return checkpointed(fn, x) if remat else fn(x)


def ssm_loss(model: SSMLM, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
             *, remat: bool = True, data_shards: int = 16):
    """batch: tokens, labels (B,S).  Returns (loss, {"ce_loss"});
    ``data_shards`` is not used (no MoE), as in the JAX package."""
    x = embed_tokens(model, cfg, batch["tokens"])
    h = ssm_backbone(model, cfg, x, remat=remat)
    loss = masked_ce(lm_logits(model, cfg, h), batch["labels"])
    return loss, {"ce_loss": loss}

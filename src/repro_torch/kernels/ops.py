"""Kernel wrappers + the ``"cuda"`` vendor-tag registrations.

This module is the "optimized kernel library" a hardware vendor ships
(§4.7): importing it registers ``tag="cuda"`` implementations with the
port's op registry, so a resolver built with ``tags=("cuda",
"reference")`` swaps them in — the TAGS="cmsis-nn" build mechanism
(§4.8), no interpreter changes.  The tag is opt-in exactly as the JAX
package's ``"pallas"`` tag is.

Each wrapper runs its kernel's plain PyTorch version (``ref.py``) only
for tensors on the CPU; for a CUDA tensor it launches the hand-written
kernel or raises.  There is no fallback from one to the other.  A
kernel launch has no backward, so a wrapper given a CUDA input that
requires grad while grad is enabled raises (``NoBackwardError``) rather
than launch and silently cut the gradient: the training path never
reaches a kernel.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import quantize as Q
from repro_torch.core.executor import eval_each_lane
from repro_torch.core.micro_ops import Attention, FullyConnected
from repro_torch.core.op_resolver import PrepareResult, register_op
from repro_torch.core.schema import OpCode

from .decode_attention import decode_attention_cuda
from .dequant_matmul import dequant_matmul_cuda, dequant_matmul_i4_cuda
from .flash_attention import flash_attention_cuda
from .paged_decode_attention import (check_block_size,
                                     paged_decode_attention_cuda)
from .paged_decode_attention_q import paged_decode_attention_q_cuda
from .quant_matmul import quant_matmul_cuda
from .ref import (decode_attention_ref, dequant_matmul_i4_ref,
                  dequant_matmul_ref, mha_ref, paged_decode_attention_q_ref,
                  paged_decode_attention_ref, quant_matmul_ref, ssd_scan_ref)
from .ssd_scan import check_chunk, ssd_scan_cuda


class NoBackwardError(RuntimeError):
    """A kernel wrapper was differentiated: its launch has no backward."""


def _no_backward(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise ``NoBackwardError`` when grad is enabled and any of
    ``tensors`` requires grad; called before a launch."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NoBackwardError(
            f"{name}: the kernel has no backward and would cut the "
            f"gradient; call it under torch.no_grad() or on detached "
            f"inputs (training runs the plain model steps)")


# ---------------------------------------------------------------------------
# quantized matmul
# ---------------------------------------------------------------------------

def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor,
                 bias_q: Optional[torch.Tensor], x_zp: int,
                 scale: torch.Tensor, out_zp: int,
                 wsum: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 (M,K) @ (K,N) -> int8 (M,N).  ``wsum`` (Σ_k w_q, int32) may be
    passed in when the weight is constant."""
    if x_q.device.type == "cpu":
        return quant_matmul_ref(x_q, w_q, bias_q, x_zp, scale, out_zp)
    _no_backward("quant_matmul", x_q, w_q, bias_q, scale, wsum)
    n = w_q.shape[1]
    if wsum is None:
        wsum = w_q.sum(dim=0, dtype=torch.int32)
    if bias_q is None:
        bias_q = torch.zeros(n, dtype=torch.int32, device=x_q.device)
    return quant_matmul_cuda(x_q.contiguous(), w_q,
                             bias_q.to(torch.int32).contiguous(), wsum,
                             scale.to(torch.float32).contiguous(),
                             x_zp=int(x_zp), out_zp=int(out_zp))


def dequant_matmul(x: torch.Tensor, wleaf) -> torch.Tensor:
    """float (M,K) @ a quantized weight (K,N) -> float32 (M,N).

    ``wleaf`` is a ``models.lm_quant.QWeight`` of int8 ``q8`` or packed
    int4 ``q4`` with per-output-channel scales ``qs``; x is taken in
    float32.  K5 runs the int8 weight, K6 the int4 one."""
    x = x.float()
    w = wleaf.q4 if wleaf.int4 else wleaf.q8
    scale = wleaf.qs.reshape(-1)
    if x.device.type == "cpu":
        plain = dequant_matmul_i4_ref if wleaf.int4 else dequant_matmul_ref
        return plain(x, w, scale)
    _no_backward("dequant_matmul", x, w, scale)
    kernel = dequant_matmul_i4_cuda if wleaf.int4 else dequant_matmul_cuda
    return kernel(x.contiguous(), w, scale)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,H,S,D), k/v (B,KH,S,D) -> (B,H,S,D)."""
    if q.device.type == "cpu":
        return mha_ref(q, k, v, causal=causal, window=window, scale=scale)
    _no_backward("flash_attention", q, k, v)
    return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: Optional[int] = None,
                     scale: Optional[float] = None,
                     return_lse: bool = False):
    """q (B,H,D), caches (B,KH,S,D), lengths (B,) -> (B,H,D); with
    ``return_lse`` also the heads' float32 log-sum-exp (B,H)."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, lengths,
                                    window=window, scale=scale,
                                    return_lse=return_lse)
    _no_backward("decode_attention", q, k_cache, v_cache)
    return decode_attention_cuda(q.contiguous(), k_cache, v_cache,
                                 lengths.to(torch.int32).contiguous(),
                                 window=window, scale=scale,
                                 return_lse=return_lse)


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           return_lse: bool = False):
    """Block-table decode attention: q (B,H,D), pools (P,KH,BS,D), tables
    (B,T), lengths (B,) -> (B,H,D) (and the log-sum-exp (B,H) with
    ``return_lse``).  The block size is the pool's; one the kernel does
    not take is refused on either device."""
    check_block_size(k_pool.shape[2])
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, k_pool, v_pool, tables, lengths,
                                          window=window, scale=scale,
                                          return_lse=return_lse)
    _no_backward("paged_decode_attention", q, k_pool, v_pool)
    return paged_decode_attention_cuda(
        q.contiguous(), k_pool, v_pool, tables.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(), window=window, scale=scale,
        return_lse=return_lse)


def quant_paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, k_scales: torch.Tensor,
                                 v_scales: torch.Tensor, tables: torch.Tensor,
                                 lengths: torch.Tensor, *,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Int8-KV block-table decode attention: q (B,H,D), int8 pools
    (P,KH,BS,D) with float32 row scales (P,KH,BS), tables (B,T), lengths
    (B,) -> (B,H,D) in q's dtype; the rows dequantize inside the kernel
    (K7).  A block size the kernel does not take is refused on either
    device."""
    check_block_size(k_pool.shape[2])
    if q.device.type == "cpu":
        return paged_decode_attention_q_ref(q, k_pool, v_pool, k_scales,
                                            v_scales, tables, lengths,
                                            window=window, scale=scale)
    _no_backward("paged_decode_attention_q", q, k_pool, v_pool, k_scales,
                 v_scales)
    return paged_decode_attention_q_cuda(
        q.contiguous(), k_pool, v_pool, k_scales.float(), v_scales.float(),
        tables.to(torch.int32).contiguous(),
        lengths.to(torch.int32).contiguous(), window=window, scale=scale)


def decode_attention_f32_cache(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor,
                               lengths: torch.Tensor) -> torch.Tensor:
    """K3 over a float32 cache (the dequantized int8 cache) for a query of
    any float dtype: q in float32, the float32 result rounded once to q's
    dtype, which is what the Pallas kernel computes for a bfloat16 q
    over a float32 cache."""
    return decode_attention(q.float(), k_cache, v_cache,
                            lengths).to(q.dtype)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _pick_block(size: int, pref: int = 128) -> int:
    """The JAX package's block choice (``repro/kernels/ops.py``): ``pref``
    when it divides ``size``, else the largest of 64, 32, 16, 8 that
    does, else ``size``."""
    if size % pref == 0:
        return pref
    for b in (64, 32, 16, 8):
        if size % b == 0:
            return b
    return size


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             D: Optional[torch.Tensor] = None, *, chunk: Optional[int] = None,
             h0: Optional[torch.Tensor] = None):
    """The Mamba-2 SSD chunked scan: x (B,S,H,P), dt (B,S,H), A (H,), B/C
    (B,S,G,N), D (H,) or None, h0 (B,H,P,N) or None -> (y (B,S,H,P) in
    x's dtype, state (B,H,P,N) float32).  The chunk defaults to the JAX
    wrapper's choice; one above the kernel's 128 is refused on either
    device.  K8 runs it on the card."""
    if chunk is None:
        chunk = _pick_block(x.shape[1])
    check_chunk(chunk)
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, A, B, C, D, chunk=chunk, h0=h0)
    _no_backward("ssd_scan", x, dt, A, B, C, D, h0)
    f32 = lambda t: None if t is None else t.float().contiguous()
    return ssd_scan_cuda(x.contiguous(), f32(dt), f32(A), B.contiguous(),
                         C.contiguous(), f32(D), chunk=chunk, h0=f32(h0))


def ssd_chunked_kernel(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                       Bm: torch.Tensor, Cm: torch.Tensor, *,
                       chunk: int = 128,
                       init_state: Optional[torch.Tensor] = None):
    """``models.ssm.ssd_chunked``'s function through ``ssd_scan`` — the
    scan hook (``ssd_impl``) of the ``"cuda"`` prefill ops.  The same
    contract: the chunk is ``min(chunk, S)`` and S must be a multiple of
    it; D stays outside, as the model adds it.  The state (B,G,H/G,P,N)
    is a view of K8's (B,H,P,N), head = g·(H/G) + i."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2:]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {chunk}")
    h0 = None if init_state is None else init_state.reshape(b, h, p, n)
    y, state = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, h0=h0)
    return y, state.view(b, g, h // g, p, n)


# ---------------------------------------------------------------------------
# vendor-tag registrations for the micro path (§4.8)
# ---------------------------------------------------------------------------

def _weight_scales(rs: Q.RequantSpec, nchan: int) -> np.ndarray:
    """Recover per-channel weight scales from the requant spec: the spec
    stores M0/shift per channel of s_in*s_w/s_out."""
    real = (rs.multiplier.astype(np.float64) / (1 << 31)
            * np.exp2(rs.shift.astype(np.float64)))
    ws = real * rs.output_scale / rs.input_scale
    if ws.shape[0] == 1 and nchan > 1:
        ws = np.repeat(ws, nchan)
    return ws.astype(np.float32)


@register_op(OpCode.FULLY_CONNECTED, tag="cuda")
class CudaFullyConnected:
    """FC whose int8 path runs on the quant_matmul kernel (K1); float
    runs the reference matmul.  The kernel requantizes with an f32 scale
    where the reference uses gemmlowp's Q31 multiplier, so the two may
    differ by 1 LSB."""

    @staticmethod
    def prepare(ctx, op):
        prep = FullyConnected.prepare(ctx, op)
        d = prep.op_data
        if "requant" in d:
            rs: Q.RequantSpec = d["requant"]
            nchan = ctx.tensor_spec(op.inputs[1]).shape[0]
            real_scale = (rs.input_scale * _weight_scales(rs, nchan)
                          / rs.output_scale)
            d["scale_t"] = torch.as_tensor(real_scale, dtype=torch.float32,
                                           device=ctx.device)
            w = ctx.const_value(op.inputs[1])            # (N, K) or None
            d["wsum_t"] = None if w is None else torch.as_tensor(
                w.sum(axis=1, dtype=np.int32), device=ctx.device)
        return prep

    @staticmethod
    def eval(ctx, op, inputs):
        x, w = inputs[0], inputs[1]
        d = ctx.op_data
        if x.dtype != torch.int8:
            return FullyConnected.eval(ctx, op, inputs)
        rs: Q.RequantSpec = d["requant"]
        bias = inputs[2] if len(inputs) > 2 else None
        lead, nchan = x.shape[:-1], w.shape[0]
        out = quant_matmul(x.reshape(-1, x.shape[-1]), w.T, bias,
                           rs.input_zero_point, d["scale_t"],
                           rs.output_zero_point, wsum=d["wsum_t"])
        return [out.clamp(d["qmin"], d["qmax"]).reshape(*lead, nchan)]

    @staticmethod
    def eval_lanes(ctx, op, inputs, in_dims):
        """Lane-stacked x (L, ..., K) with a shared weight: the lanes fold
        into the kernel's rows, one launch of M = L x rows (``eval``
        already flattens every leading axis)."""
        if in_dims[0] == 0 and all(d is None for d in in_dims[1:]):
            return CudaFullyConnected.eval(ctx, op, inputs)
        return eval_each_lane(CudaFullyConnected.eval, ctx, op, inputs,
                              in_dims)


@register_op(OpCode.ATTENTION, tag="cuda")
class CudaAttention:
    """Micro ATTENTION on the flash_attention kernel (K2)."""

    prepare = staticmethod(Attention.prepare)

    @staticmethod
    def eval(ctx, op, inputs):
        q, k, v = inputs
        return [flash_attention(q, k, v,
                                causal=op.params.get("causal", True))]

    @staticmethod
    def eval_lanes(ctx, op, inputs, in_dims):
        """Lane-stacked q, k, v (L, B, H, S, D): the lanes fold into the
        kernel's batch axis, one launch over L x B."""
        if any(d is None for d in in_dims):
            return eval_each_lane(CudaAttention.eval, ctx, op, inputs,
                                  in_dims)
        lanes, b = inputs[0].shape[:2]
        folded = [x.reshape(lanes * b, *x.shape[2:]) for x in inputs]
        (out,) = CudaAttention.eval(ctx, op, folded)
        return [out.reshape(lanes, b, *out.shape[1:])]


# ---------------------------------------------------------------------------
# vendor-tag registration for the serving path (§4.8 at pod scale)
# ---------------------------------------------------------------------------

# the families whose decode attention runs on K3/K4/K7 (the JAX
# package's Pallas decode ops take the same two)
KERNEL_DECODE_FAMILIES = ("dense", "moe")

@register_op(OpCode.SERVING_PREFILL, tag="cuda")
class CudaServingPrefill:
    """Pod-scale prefill whose SSD scan runs on the ssd_scan kernel (K8)
    for the recurrent families (ssm, hybrid): one launch per Mamba layer.
    prepare() bakes the family decision into op_data, as the decode op
    does: dense runs the bundle's prefill unchanged (the JAX package has
    no vendor prefill for it).  The op takes exactly the prompts the
    reference takes: the scan hook keeps ``ssd_chunked``'s contract."""

    @staticmethod
    def prepare(ctx, op):
        return PrepareResult(output_specs=[], op_data=_scan_hook(ctx))

    @staticmethod
    def eval(ctx, op, inputs):
        params, batch = inputs
        return ctx.bundle.prefill(params, batch,
                                  cache_len=op.params["cache_len"],
                                  window=op.params.get("window"),
                                  **ctx.op_data["kw"])


def _scan_hook(ctx) -> dict:
    """op_data ``{"kw": ...}``: the prefill keyword that puts the SSD scan
    on K8 for the recurrent families, none for the others."""
    # imported here: the kernels sit beneath the serving package
    from repro_torch.serving.ops import RECURRENT_FAMILIES
    recurrent = ctx.bundle.cfg.family in RECURRENT_FAMILIES
    return {"kw": {"ssd_impl": ssd_chunked_kernel} if recurrent else {}}


@register_op(OpCode.SERVING_PREFILL_Q, tag="cuda")
class CudaServingPrefillQ:
    """Quantized prefill with ``CudaServingPrefill``'s scan hook: the
    float prefill over the dequantized model, its SSD scan on K8 for the
    quantized recurrent families (the JAX package has no Pallas
    quantized prefill, and there the reference one runs its Pallas-free
    scan; without this op the ``"cuda"`` chain would run the plain scan
    too).  The family gate is the reference's."""

    @staticmethod
    def prepare(ctx, op):
        from repro_torch.serving.ops import _quant_family_gate
        od = _quant_family_gate(ctx.bundle.cfg, op)
        od.update(_scan_hook(ctx))
        return PrepareResult(output_specs=[], op_data=od)

    @staticmethod
    def eval(ctx, op, inputs):
        from repro_torch.serving.ops import prefill_q
        return prefill_q(ctx, op, inputs, **ctx.op_data["kw"])


@register_op(OpCode.SERVING_PREFILL_CHUNK_STATE, tag="cuda")
class CudaServingPrefillChunkState:
    """Recurrent-state chunked prefill whose SSD scan runs on K8, the
    carried state passed to the kernel as its initial state ``h0``: one
    launch per Mamba layer and chunk.  The family gate is the
    reference's."""

    @staticmethod
    def prepare(ctx, op):
        from repro_torch.serving.ops import RefServingPrefillChunkState
        return RefServingPrefillChunkState.prepare(ctx, op)

    @staticmethod
    def eval(ctx, op, inputs):
        from repro_torch.serving.ops import prefill_chunk_state
        return prefill_chunk_state(ctx, op, inputs,
                                   ssd_impl=ssd_chunked_kernel)


@register_op(OpCode.SERVING_DECODE, tag="cuda")
class CudaServingDecode:
    """Pod-scale decode step whose per-layer attention runs on the
    decode_attention kernel (K3) for the dense and moe families (the
    MoE block's expert products stay matmuls, as the JAX package runs
    them outside any Pallas kernel).  prepare() inspects the family once
    at engine init and bakes the choice into op_data; any other family
    (vlm, audio, the recurrent ones) runs the bundle's reference decode,
    the per-kernel fallback the tag chain promises, as in the JAX
    package."""

    @staticmethod
    def prepare(ctx, op):
        use_kernel = ctx.bundle.cfg.family in KERNEL_DECODE_FAMILIES
        return PrepareResult(output_specs=[],
                             op_data={"use_kernel": use_kernel})

    @staticmethod
    def eval(ctx, op, inputs):
        from repro_torch.serving.ops import seq_kv_kw
        params, cache, tokens, lengths = inputs
        if not ctx.op_data["use_kernel"]:
            return ctx.bundle.decode(params, cache, tokens, lengths,
                                     window=op.params.get("window"),
                                     **seq_kv_kw(op))
        from repro_torch.models import lm
        # no window= here on purpose: the dense reference decode attends
        # over the whole valid cache, so the kernel must too — the tag
        # choice may never change semantics.  (So a rank of a
        # sequence-sharded cache never needs the window at global
        # positions: its clamped lengths are the whole mask.)
        return lm.lm_decode(params, ctx.bundle.cfg, cache, tokens, lengths,
                            attn_impl=decode_attention, **seq_kv_kw(op))


@register_op(OpCode.SERVING_DECODE_PAGED, tag="cuda")
class CudaServingDecodePaged:
    """Pod-scale paged decode step whose per-layer attention walks each
    slot's block table on the paged_decode_attention kernel (K4) for the
    dense and moe families; vlm shares the paged step with reference
    attention, as in the JAX package.  prepare() refuses the families
    the reference refuses and a block size the kernel does not take,
    once, at engine init."""

    @staticmethod
    def prepare(ctx, op):
        # imported here: the kernels sit beneath the serving package
        from repro_torch.serving.ops import (PAGED_FAMILIES, PAGED_FEATURE,
                                             family_gate)
        scale = family_gate(ctx.bundle.cfg, PAGED_FEATURE, PAGED_FAMILIES)
        use_kernel = ctx.bundle.cfg.family in KERNEL_DECODE_FAMILIES
        if use_kernel:
            check_block_size(op.params["kv_block"])
        return PrepareResult(output_specs=[], op_data={
            "scale": scale, "use_kernel": use_kernel})

    @staticmethod
    def eval(ctx, op, inputs):
        params, pool, tables, tokens, lengths = inputs
        from repro_torch.models import lm
        from repro_torch.serving.ops import seq_kv_kw
        # no window= here, as in the reference paged decode
        return lm.lm_decode_paged(
            params, ctx.bundle.cfg, pool, tables, tokens, lengths,
            embed_scale=ctx.op_data["scale"],
            attn_impl=(paged_decode_attention if ctx.op_data["use_kernel"]
                       else None), **seq_kv_kw(op))


@register_op(OpCode.SERVING_DECODE_Q, tag="cuda")
class CudaServingDecodeQ:
    """Quantized decode step on the kernels for the dense and moe
    families: with quantized weights every dense MLP's three matmuls
    (DeepSeek's first block included) run on K5 (int8) or K6 (int4), and
    attention runs on K7 (paged, int8 KV), K4 (paged, float KV) or K3
    (contiguous, over the dequantized float32 cache when the KV is
    int8); a MoE layer's experts run on its dequantized weights, as in
    the JAX package.  vlm takes the quantized LM step with reference
    attention and MLP, and the recurrent families the reference
    quantized decode, as in the JAX package.  prepare() refuses what
    the reference refuses and a block size the paged kernels do not
    take, once, at engine init."""

    @staticmethod
    def prepare(ctx, op):
        # imported here: the kernels sit beneath the serving package
        from repro_torch.serving.ops import _quant_family_gate
        od = _quant_family_gate(ctx.bundle.cfg, op)
        od["use_kernel"] = ctx.bundle.cfg.family in KERNEL_DECODE_FAMILIES
        if od["paged"] and od["use_kernel"]:
            check_block_size(op.params["kv_block"])
        # an int8-KV-only engine keeps float weights: nothing to dequantize
        od["use_mm"] = (od["use_kernel"]
                        and od["weight_dtype"] in ("int8", "int4"))
        return PrepareResult(output_specs=[], op_data=od)

    @staticmethod
    def eval(ctx, op, inputs):
        from repro_torch.serving.ops import decode_q
        od = ctx.op_data
        attn = None
        if od["use_kernel"]:
            if od["paged"]:
                attn = (quant_paged_decode_attention if od["kv_q"]
                        else paged_decode_attention)
            else:
                attn = (decode_attention_f32_cache if od["kv_q"]
                        else decode_attention)
        return decode_q(ctx, op, inputs, attn_impl=attn,
                        mlp_impl=dequant_matmul if od["use_mm"] else None)

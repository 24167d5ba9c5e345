"""Sharding policy: ModelConfig x mesh -> partition specs — the port's
counterpart of ``repro.distributed.sharding``, decision for decision.

Axes:
  * ``data`` (and ``pod`` when multi-pod) shard the batch and — FSDP
    style — the d_model dimension of the weights;
  * ``model`` shards heads / FFN hidden / experts / vocab (Megatron).

Head-sharding fallback chain (phi4 has 24 heads, paligemma 8, whisper 20
over model=16):
  1. n_heads % model == 0      -> shard the head axis;
  2. head_dim % model == 0     -> shard head_dim (``attn_fallback=
     "head_dim"`` only);
  3. otherwise                 -> replicate attention over ``model``
     (the FFN is still sharded).

KV caches: the kv-head axis is sharded on ``model`` when divisible, else
the *sequence* axis of the cache (flash-decoding partial attention; the
port's model steps combine the partials with explicit collectives).  The
batch shards on (pod, data) when divisible, else replicates.

A spec is a tuple with one entry per dimension — an axis name, a tuple
of axis names, or None — the counterpart of ``PartitionSpec``; a shorter
spec leaves the trailing dimensions whole, and ``()`` replicates.
``Sharding`` pairs one with its mesh (``NamedSharding``).  The specs are
computed on the JAX package's parameter tree layout: ``params_tree``
builds it from a port model (per-layer leaves stacked on a leading L
dim, as ``registry.params_to_jax`` lays them out), and ``param_specs``
maps the specs back to the port's parameter names, the stacked layer
dimension dropped.  ``shard_local`` is this rank's slice of a tensor,
``shard_params`` a model of this rank's slices, ready for the per-rank
model steps (serving's Megatron layout, or training's with FSDP), and
``unshard`` / ``gather_params`` put a rank's slices back together;
``shard_batch`` is this rank's rows of a batch.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig

from .collectives import Comm, DataShard, Shard

Spec = Tuple[Any, ...]


def P(*entries) -> Spec:
    """A partition spec: one entry per leading dimension."""
    return tuple(entries)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return mesh.data_axes


def _axis_size(mesh: Mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def _data_size(mesh: Mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        n *= _axis_size(mesh, a)
    return n


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Resolved per-(cfg, mesh) sharding decisions."""
    mesh: Mesh
    cfg: ModelConfig
    attn_mode: str          # "heads" | "head_dim" | "replicated"
    kv_cache_mode: str      # "kv_heads" | "sequence"
    fsdp: bool              # shard d_model dim of weights over data

    @property
    def batch_axes(self):
        return data_axes(self.mesh)


def make_policy(cfg: ModelConfig, mesh: Mesh, *, fsdp: bool = True,
                attn_fallback: str = "replicated") -> ShardingPolicy:
    """``attn_fallback`` for heads-indivisible archs: "replicated" keeps
    attention data-parallel only (weights replicated over ``model``), the
    JAX package's measured choice; "head_dim" shards the head dim."""
    m = _axis_size(mesh, "model")
    if cfg.n_heads and cfg.n_heads % m == 0:
        attn = "heads"
    elif cfg.n_heads and cfg.dh % m == 0 and attn_fallback == "head_dim":
        attn = "head_dim"
    else:
        attn = "replicated"
    kv = "kv_heads" if (cfg.n_kv_heads and cfg.n_kv_heads % m == 0) \
        else "sequence"
    return ShardingPolicy(mesh=mesh, cfg=cfg, attn_mode=attn,
                          kv_cache_mode=kv, fsdp=fsdp)


# ---------------------------------------------------------------------------
# parameter specs (on the JAX package's tree layout)
# ---------------------------------------------------------------------------

def _dm(pol: ShardingPolicy):
    """Axis for the d_model dim of weight matrices (FSDP over data)."""
    if not pol.fsdp:
        return None
    if pol.cfg.d_model % _data_size(pol.mesh) == 0:
        return pol.batch_axes
    return None


def _div(n: int, mesh: Mesh, axis: str) -> bool:
    return n % _axis_size(mesh, axis) == 0


def _attn_spec(pol: ShardingPolicy, lead) -> Dict[str, Spec]:
    """wq (…,D,H,dh) wk/wv (…,D,KH,dh) wo (…,H,dh,D)."""
    cfg, mesh = pol.cfg, pol.mesh
    dm = _dm(pol)
    if pol.attn_mode == "heads":
        h_ax, dh_ax = "model", None
        kv_h_ax = "model" if _div(cfg.n_kv_heads, mesh, "model") else None
        kv_dh_ax = None
    elif pol.attn_mode == "head_dim":
        h_ax, dh_ax = None, "model"
        kv_h_ax, kv_dh_ax = None, "model"
    else:
        h_ax = dh_ax = kv_h_ax = kv_dh_ax = None
    spec = {"wq": P(*lead, dm, h_ax, dh_ax),
            "wk": P(*lead, dm, kv_h_ax, kv_dh_ax),
            "wv": P(*lead, dm, kv_h_ax, kv_dh_ax),
            "wo": P(*lead, h_ax, dh_ax, dm)}
    if cfg.qk_norm:
        spec["q_norm"] = P(*lead, None)
        spec["k_norm"] = P(*lead, None)
    return spec


def _mlp_spec(pol: ShardingPolicy, lead, f: int) -> Dict[str, Spec]:
    dm = _dm(pol)
    f_ax = "model" if _div(f, pol.mesh, "model") else None
    spec = {"wi": P(*lead, dm, f_ax), "wo": P(*lead, f_ax, dm)}
    if pol.cfg.act in ("silu", "geglu"):
        spec["wg"] = P(*lead, dm, f_ax)
    return spec


def _moe_spec(pol: ShardingPolicy, lead) -> Dict[str, Any]:
    cfg = pol.cfg
    e_ax = "model" if _div(cfg.n_experts, pol.mesh, "model") else None
    dm = _dm(pol)
    expert = {"wi": P(*lead, e_ax, dm, None), "wo": P(*lead, e_ax, None, dm)}
    if cfg.act in ("silu", "geglu"):
        expert["wg"] = P(*lead, e_ax, dm, None)
    spec = {"router": P(*lead, dm, None), "experts": expert}
    if cfg.n_shared_experts:
        spec["shared"] = _mlp_spec(pol, lead,
                                   cfg.n_shared_experts * cfg.moe_d_ff)
    return spec


def _ssm_spec(pol: ShardingPolicy, lead) -> Dict[str, Spec]:
    """Mamba2 block: the packed z|xBC|dt projection stays whole; the
    inner (head) dim of the norm and ``out_proj`` shards on ``model``."""
    dm = _dm(pol)
    di_ax = "model" if _div(pol.cfg.d_inner, pol.mesh, "model") else None
    return {"in_proj": P(*lead, dm, None), "conv_w": P(*lead, None, None),
            "conv_b": P(*lead, None), "dt_bias": P(*lead, None),
            "A_log": P(*lead, None), "D": P(*lead, None),
            "norm": P(*lead, di_ax), "out_proj": P(*lead, di_ax, dm),
            "ln": P(*lead, None)}


def _vocab_spec(pol: ShardingPolicy) -> Spec:
    return P("model", _dm(pol))


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node


def param_spec(cfg: ModelConfig, pol: ShardingPolicy,
               params_tree: Dict[str, Any]) -> Dict[str, Any]:
    """A spec tree with the structure of ``params_tree``, a parameter tree
    in the JAX package's layout whose leaves have ``.ndim``
    (``params_tree`` builds one from a port model)."""
    spec: Dict[str, Any] = {}
    if "embed" in params_tree:
        spec["embed"] = _vocab_spec(pol)
    if "lm_head" in params_tree:
        spec["lm_head"] = P(_dm(pol), "model")
    if "final_norm" in params_tree:
        spec["final_norm"] = P(None)
    if "projector" in params_tree:
        spec["projector"] = P(None, _dm(pol))
    for top in ("blocks", "first_block", "shared", "encoder", "decoder"):
        if top not in params_tree:
            continue
        sub = params_tree[top]
        lead_t = () if top == "shared" else (None,)
        if "in_proj" in sub:                      # mamba2 block stack
            spec[top] = _ssm_spec(pol, lead_t)
            continue
        s: Dict[str, Any] = {}
        for k, v in sub.items():
            if k in ("attn", "xattn"):
                at = _attn_spec(pol, lead_t)
                # encdec attention carries biases
                for bk in ("bq", "bv", "bo"):
                    if bk in v:
                        at[bk] = (P(*lead_t, None, None) if bk != "bo"
                                  else P(*lead_t, None))
                s[k] = at
            elif k == "mlp":
                f = (cfg.first_layer_dense_ff if top == "first_block"
                     else cfg.d_ff)
                ms = _mlp_spec(pol, lead_t, f)
                for bk in ("bi", "bo"):
                    if bk in v:
                        ms[bk] = P(*lead_t,
                                   ms["wi"][-1] if bk == "bi" else None)
                s[k] = ms
            elif k == "moe":
                s[k] = _moe_spec(pol, lead_t)
            else:                                 # norms / biases
                s[k] = P(*([None] * _first_leaf(v).ndim))
        spec[top] = s
    for k in ("dec_pos", "enc_final_g", "enc_final_b", "final_g",
              "final_b"):
        if k in params_tree:
            spec[k] = P(*([None] * params_tree[k].ndim))
    return spec


def params_tree(model: nn.Module) -> Dict[str, Any]:
    """``model``'s parameter shapes in the JAX package's tree layout:
    nested dicts whose leaves carry ``shape`` and ``ndim``, per-layer
    leaves stacked on a leading L dim (``lm.jax_layout``)."""
    from repro_torch.models import lm
    tree: Dict[str, Any] = {}
    for key, (parts, stacked) in lm.jax_layout(
            model.named_parameters()).items():
        shape = tuple(parts[0].shape)
        if stacked:
            shape = (len(parts),) + shape
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = types.SimpleNamespace(shape=shape, ndim=len(shape))
    return tree


def param_specs(model: nn.Module, mesh: Mesh, *, fsdp: bool = True,
                policy: Optional[ShardingPolicy] = None) -> Dict[str, Spec]:
    """Each of ``model``'s parameters by its port name -> its spec: the
    JAX package's ``param_spec`` on ``params_tree(model)``, the stacked
    layer dimension of a per-layer leaf dropped."""
    from repro_torch.models import lm
    pol = policy or make_policy(model.cfg, mesh, fsdp=fsdp)
    tree = param_spec(model.cfg, pol, params_tree(model))
    out = {}
    for name, _ in model.named_parameters():
        key, index = lm.jax_key(name)
        node = tree
        for part in key.split("/"):
            node = node[part]
        out[name] = node[1:] if index is not None else node
    return out


# ---------------------------------------------------------------------------
# public API: shardings
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a mesh — the counterpart of ``NamedSharding``."""
    mesh: Mesh
    spec: Spec

    def local_shape(self, shape) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, self.mesh)

    def local(self, tensor: torch.Tensor) -> torch.Tensor:
        return shard_local(tensor, self.spec, self.mesh)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _parts(entry, mesh: Mesh) -> int:
    n = 1
    for a in _axes(entry):
        n *= _axis_size(mesh, a)
    return n


def _check(shape, spec: Spec, mesh: Mesh) -> None:
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape "
                         f"{tuple(shape)} has dims")
    for d, entry in enumerate(spec):
        n = _parts(entry, mesh)
        if shape[d] % n:
            raise ValueError(
                f"dim {d} of shape {tuple(shape)} ({shape[d]}) is not "
                f"divisible by {n}, the size of {entry!r} in spec {spec}")


def local_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one rank's slice of a tensor of ``shape``."""
    _check(shape, spec, mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        out[d] //= _parts(entry, mesh)
    return tuple(out)


def shard_local(tensor: torch.Tensor, spec: Spec,
                mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``tensor`` under ``spec``: along each sharded
    dimension the block at this rank's index over the entry's axes
    (row-major in their order, as in JAX).  A dimension the axes do not
    divide is refused with ``ValueError``, as ``jax.device_put`` refuses
    it.  The slice is a copy of its own; a spec that splits nothing
    returns ``tensor`` itself."""
    if mesh.abstract:
        raise ValueError(f"{mesh!r} is abstract: it has no rank to slice "
                         f"for")
    _check(tensor.shape, spec, mesh)
    out = tensor
    for d, entry in enumerate(spec):
        n = _parts(entry, mesh)
        if n == 1:
            continue
        idx = 0
        for a in _axes(entry):
            idx = idx * _axis_size(mesh, a) + mesh.coords.get(a, 0)
        size = tensor.shape[d] // n
        out = out.narrow(d, idx * size, size)
    return out if out is tensor else out.clone(
        memory_format=torch.contiguous_format)


def param_sharding(cfg: ModelConfig, mesh: Mesh, model: nn.Module, *,
                   fsdp: bool = True) -> Dict[str, Sharding]:
    """Each of ``model``'s parameters by name -> its ``Sharding``."""
    pol = make_policy(cfg, mesh, fsdp=fsdp)
    return {name: Sharding(mesh, s) for name, s in
            param_specs(model, mesh, policy=pol).items()}


def batch_sharding(cfg: ModelConfig, mesh: Mesh, batch_tree: Dict,
                   global_batch: int) -> Dict[str, Sharding]:
    """Shard the batch dim over (pod, data) when divisible."""
    axes = data_axes(mesh)
    dsz = _data_size(mesh)
    b_ax = axes if (global_batch % dsz == 0 and dsz > 1) else ()
    out = {}
    for k, v in batch_tree.items():
        spec = [None] * len(v.shape)
        if spec:
            spec[0] = b_ax if b_ax else None
        out[k] = Sharding(mesh, P(*spec))
    return out


# the KV leaves of every family's cache: (L, B, KH, C, dh), the paged
# pool's (L, P, KH, BS, dh)
KV_LEAVES = ("k", "v", "attn_k", "attn_v", "cross_k", "cross_v")


def cache_spec(pol: ShardingPolicy, name: str, shape,
               global_batch: int) -> Spec:
    """One cache leaf's spec.  Dense k/v: (L,B,KH,C,dh); ssm state:
    (L,B,G,gh,P,N); conv: (L,B,K-1,Ci); hybrid attn_k: (apps,B,KH,C,dh);
    cross_k: (L,B,KH,T,dh)."""
    mesh = pol.mesh
    dsz = _data_size(mesh)
    b_ax = data_axes(mesh) if (global_batch % dsz == 0 and dsz > 1) \
        else None
    if name in KV_LEAVES:
        if pol.kv_cache_mode == "kv_heads":
            return P(None, b_ax, "model", None, None)
        # sequence sharding only when the seq axis divides (the whisper
        # cross-KV T=1500 does not; replicate it instead)
        if shape[3] % _axis_size(mesh, "model") == 0:
            return P(None, b_ax, None, "model", None)
        return P(None, b_ax, None, None, None)
    if name == "state":         # (L,B,G,gh,P,N): shard heads on model
        gh_ax = "model" if _div(shape[3], mesh, "model") else None
        return P(None, b_ax, None, gh_ax, None, None)
    if name == "conv":          # (L,B,K-1,Ci)
        return P(None, b_ax, None, None)
    return P(*([None] * len(shape)))


def cache_sharding(cfg: ModelConfig, mesh: Mesh, cache_tree: Dict[str, Any],
                   global_batch: int) -> Dict[str, Sharding]:
    """KV/SSD cache leaf name -> its ``Sharding`` (``cache_spec``); the
    leaves may be tensors or anything with ``.shape``."""
    pol = make_policy(cfg, mesh)
    return {name: Sharding(mesh, cache_spec(pol, name, leaf.shape,
                                            global_batch))
            for name, leaf in cache_tree.items()}


def replicated(mesh: Mesh) -> Sharding:
    """The fully-replicated sharding on ``mesh`` — the placement of every
    bookkeeping value of a sharded engine (block tables, lengths, current
    tokens): each rank holds all of it."""
    return Sharding(mesh, P())


def engine_shardings(cfg: ModelConfig, mesh: Mesh, model: nn.Module,
                     cache_tree: Dict[str, Any], *, global_batch: int,
                     cache1_tree: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The shardings of a ``ServingEngine``'s state on ``mesh`` — the
    single entry point the serving layer shards through:

      * ``"params"`` — the Megatron-style weight shardings
        (``param_sharding``), FSDP off: a serving mesh replicates weights
        over ``data`` and shards heads / FFN / experts / vocab over
        ``model``;
      * ``"cache"`` — the KV arena (``cache_sharding``): the contiguous
        ``(L, max_slots, …)`` rings, or the paged pool ``(L, n_blocks,
        KH, bs, dh)``, which shards through the same per-leaf rules;
      * ``"cache1"`` (when ``cache1_tree`` is given) — the batch=1
        chunked-prefill cache;
      * ``"repl"`` — the fully-replicated sharding of the bookkeeping."""
    out = {"params": param_sharding(cfg, mesh, model, fsdp=False),
           "cache": cache_sharding(cfg, mesh, cache_tree, global_batch),
           "repl": replicated(mesh)}
    if cache1_tree is not None:
        out["cache1"] = cache_sharding(cfg, mesh, cache1_tree, 1)
    return out


# ---------------------------------------------------------------------------
# this rank's model
# ---------------------------------------------------------------------------

# the families a serving mesh shards (the JAX engine's SHARDED_FAMILIES;
# ``ServingEngine(mesh=)`` refuses the others); a training mesh shards
# every family, audio too
SHARDED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def shard_params(model: nn.Module, mesh: Mesh, *,
                 fsdp: bool = True) -> nn.Module:
    """This rank's model on ``mesh``: a module of the same class whose
    every parameter is ``shard_local`` of ``model``'s under
    ``param_sharding(..., fsdp=fsdp)``, each module told how its weights
    lie — ``tp`` (a ``collectives.Shard``) on the ``model`` axis and,
    where FSDP splits over more than one data rank, ``dp`` (a
    ``collectives.DataShard``) — so the model steps run on the local
    shards and meet the other ranks at their collectives.  ``specs``
    (parameter name -> spec), ``mesh`` and ``fsdp`` are set on the
    model.  Serving
    shards with ``fsdp=False`` (weights whole over ``data``), training
    with FSDP.  A model already sharded for ``mesh`` is returned as it
    is, and the shards of one ``model`` are made once per mesh and
    ``fsdp`` (replicas share them).  A ``model`` axis the padded
    vocabulary does not divide is refused with ``ValueError``."""
    if getattr(model, "mesh", None) is mesh:
        return model
    memo = model.__dict__.setdefault("_mesh_shards", {})
    if (id(mesh), fsdp) in memo:
        return memo[(id(mesh), fsdp)][1]
    from repro_torch.models import lm, registry
    cfg = model.cfg
    m, vocab = _axis_size(mesh, "model"), lm.padded_vocab(cfg)
    if vocab % m:
        raise ValueError(f"{cfg.arch_id}: its vocabulary of {cfg.vocab} "
                         f"(padded to {vocab} rows) does not divide over "
                         f"model={m}")
    pol = make_policy(cfg, mesh, fsdp=fsdp)
    specs = param_specs(model, mesh, policy=pol)
    local = registry.empty_model(cfg, "meta")
    for name, param in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        setattr(local.get_submodule(owner), leaf, nn.Parameter(
            shard_local(param.detach(), specs[name], mesh),
            requires_grad=False))
    _annotate(local, cfg, mesh, pol, specs)
    local.mesh, local.specs, local.fsdp = mesh, specs, fsdp
    memo[(id(mesh), fsdp)] = (mesh, local)
    return local


def unshard(tensor: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of which ``tensor`` is this rank's slice under
    ``spec`` (the inverse of ``shard_local``): every sharded dimension
    gathered over its entry's axes.  Every rank of ``mesh`` must call it
    for the same leaf at the same point; every rank gets the whole."""
    out = tensor.detach()
    for d, entry in enumerate(spec):
        if _parts(entry, mesh) > 1:
            out = mesh.comm(_axes(entry)).all_gather(out, d)
    return out


def gather_params(model: nn.Module, device=None) -> nn.Module:
    """The whole model of which ``model`` (``shard_params``' result) is
    this rank's part, every parameter ``unshard``ed, on ``device``
    (``model``'s by default).  A collective over the mesh: every rank
    calls it and gets the whole model."""
    from repro_torch.models import registry
    whole = registry.empty_model(model.cfg, "meta")
    for name, param in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        value = unshard(param, model.specs[name], model.mesh)
        setattr(whole.get_submodule(owner), leaf, nn.Parameter(
            value.to(device or param.device), requires_grad=False))
    return whole


def shard_batch(batch: Dict[str, Any], mesh: Mesh,
                grad_accum: int = 1) -> Dict[str, Any]:
    """This rank's rows of a global batch (numpy arrays or tensors,
    batch first) under ``batch_sharding``: a block of the rows over the
    data axes — of each of ``grad_accum`` micro-batches, as the JAX
    step's reshape of a data-sharded batch takes them, so micro-batch i
    is the same rows as on one device.  A batch the data axes do not
    divide is refused (each data rank's gradient is its rows' share,
    which a replicated batch would count once a rank)."""
    data = mesh.comm(data_axes(mesh))
    if data.size == 1:
        return batch
    out = {}
    for k, v in batch.items():
        rows = v.shape[0] // grad_accum
        if v.shape[0] % grad_accum or rows % data.size:
            raise ValueError(f"batch leaf {k!r}: {v.shape[0]} rows in "
                             f"{grad_accum} micro-batches do not divide "
                             f"over the {data.size} data ranks of {mesh!r}")
        n = rows // data.size
        parts = [v[i * rows + data.rank * n:i * rows + (data.rank + 1) * n]
                 for i in range(grad_accum)]
        out[k] = parts[0] if grad_accum == 1 else (
            torch.cat(parts) if isinstance(v, torch.Tensor)
            else np.concatenate(parts))
    return out


def _annotate(model: nn.Module, cfg: ModelConfig, mesh: Mesh,
              pol: ShardingPolicy, specs: Dict[str, Spec]) -> None:
    """Set ``tp`` on every module whose step meets a collective on
    ``model``, and ``dp`` on every module with parameters when the data
    axes hold more than one rank and FSDP is on."""
    from repro_torch.models import encdec, lm, ssm
    m = mesh.shape["model"]
    comm = mesh.comm("model")
    if pol.fsdp and _data_size(mesh) > 1:
        dcomm = mesh.comm(data_axes(mesh))
        dm = _dm(pol)
        for prefix, mod in model.named_modules():
            key = f"{prefix}." if prefix else ""
            names = [n for n, _ in mod.named_parameters(recurse=False)]
            if names:
                mod.dp = DataShard(dcomm, {
                    n: next((d for d, e in enumerate(specs[key + n])
                             if dm is not None and e == dm), None)
                    for n in names}, experts=prefix.endswith("experts"))
    if pol.attn_mode == "head_dim":
        raise ValueError("attention sharded by head_dim is not served on "
                         "a mesh (the serving policy replicates instead)")
    model.tp = Shard(comm, split=specs["embed"][0] == "model")
    for prefix, mod in model.named_modules():
        key = f"{prefix}." if prefix else ""
        if isinstance(mod, (lm.Attention, encdec.BiasedAttention)):
            mod.tp = Shard(comm, split=specs[key + "wq"][1] == "model",
                           kv_split=specs[key + "wk"][1] == "model")
            if (isinstance(mod, encdec.BiasedAttention)
                    and mod.tp.split != mod.tp.kv_split):
                raise ValueError(
                    f"{cfg.arch_id}: encoder-decoder attention with its "
                    f"{cfg.n_heads} query heads split over model={m} and "
                    f"its {cfg.n_kv_heads} KV heads whole (no "
                    f"configuration of the repository has them)")
        elif isinstance(mod, encdec.BiasedMLP):
            mod.tp = Shard(comm, split=specs[key + "wi"][-1] == "model")
        elif isinstance(mod, lm.MoE):
            mod.tp = Shard(comm,
                           split=specs[key + "experts.wi"][0] == "model")
        elif isinstance(mod, lm.MLP) and not prefix.endswith("experts"):
            mod.tp = Shard(comm, split=specs[key + "wi"][-1] == "model")
        elif isinstance(mod, ssm.MambaBlock):
            gh = cfg.ssm_heads // cfg.ssm_groups
            if cfg.ssm_groups > 1 and m > 1 and gh % m == 0:
                raise ValueError(
                    f"ssm_groups={cfg.ssm_groups} with the SSD state's "
                    f"heads split over model={m}: a rank's heads would "
                    f"not be its d_inner block (no configuration of the "
                    f"repository has more than one group)")
            mod.tp = Shard(comm, split=specs[key + "norm"][0] == "model")

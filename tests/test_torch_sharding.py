"""The port's sharding policy against the JAX package's, without
processes: for every architecture on the production mesh shapes, the
parameter specs leaf for leaf and dimension by dimension through the
``params_to_jax`` map, the cache specs at two layouts, the attention and
KV-cache modes; then ``shard_local``'s slices and refusals, and the
meshes' shapes and refusals.

The JAX side runs on ``AbstractMesh`` (``tests/test_sharding_policy.py``'s
meshes) and the port's on ``make_production_mesh``; the port's models are
built on the meta device (full widths, no memory)."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs
from repro.distributed import sharding as jax_sharding
from repro.models import get_model as jax_get_model

from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.models import get_model, lm
from repro_torch.models.registry import empty_model

ARCHS = list_archs()


def _jax_mesh(multi_pod):
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                    else ((16, 16), ("data", "model")))
    try:
        return AbstractMesh(shape, names)
    except TypeError:       # jax 0.4.x: ((name, size), ...) pairs
        return AbstractMesh(tuple(zip(names, shape)))


def _norm(spec, ndim):
    """A spec as a tuple of ndim entries, each None or a tuple of axis
    names (PartitionSpec keeps a lone axis as a string or a 1-tuple)."""
    out = []
    for e in tuple(spec) + (None,) * (ndim - len(tuple(spec))):
        out.append(None if e is None else (e,) if isinstance(e, str)
                   else tuple(e))
    return tuple(out)


def _jax_leaf(tree, key):
    node = tree
    for part in key.split("/"):
        node = node[part]
    return node


@pytest.fixture(scope="module")
def jax_params():
    """arch -> the JAX parameter tree's shapes (``eval_shape``)."""
    out = {}
    for arch in ARCHS:
        bundle = jax_get_model(jax_get_config(arch))
        out[arch] = jax.eval_shape(lambda b=bundle: b.init(
            jax.random.PRNGKey(0)))
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(jax_params, arch, multi_pod):
    """Every port parameter's spec equals the JAX leaf's through the
    ``params_to_jax`` map: the JAX leaf stacks the per-layer tensors on a
    leading dim that is never sharded, and the rest is the port's, dim
    for dim; the port leaf's shape is the JAX leaf's less that dim."""
    cfg = get_config(arch)
    jtree = jax_params[arch]
    jmesh = _jax_mesh(multi_pod)
    jspec = jax_sharding.param_spec(
        jax_get_config(arch), jax_sharding.make_policy(
            jax_get_config(arch), jmesh), jtree)
    model = empty_model(cfg, "meta")
    pmesh = port_mesh.make_production_mesh(multi_pod=multi_pod)
    specs = sharding.param_specs(model, pmesh)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    covered = set()
    for name, param in model.named_parameters():
        key, index = lm.jax_key(name)
        covered.add(key)
        leaf, spec = _jax_leaf(jtree, key), _jax_leaf(jspec, key)
        want = _norm(spec, leaf.ndim)
        if index is not None:
            assert want[0] is None, (name, spec)
            assert tuple(leaf.shape[1:]) == tuple(param.shape), name
            want = want[1:]
        else:
            assert tuple(leaf.shape) == tuple(param.shape), name
        assert _norm(specs[name], param.dim()) == want, (name, specs[name],
                                                          spec)
    # every JAX leaf has a port parameter
    jkeys = {"/".join(str(getattr(k, "key", k)) for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    assert jkeys == covered


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch):
    """Cache specs at (128 sequences, 32768 positions) and (1, the
    window or 8192), leaf for leaf."""
    cfg = get_config(arch)
    jcfg = jax_get_config(arch)
    jbundle, bundle = jax_get_model(jcfg), get_model(cfg)
    jmesh = _jax_mesh(False)
    pmesh = port_mesh.make_production_mesh()
    for batch, cl in ((128, 32768), (1, cfg.sliding_window or 8192)):
        jcache = jax.eval_shape(lambda: jbundle.empty_cache(
            batch, cl, jcfg.jnp_dtype()))
        want = jax_sharding.cache_sharding(jcfg, jmesh, jcache, batch)
        cache = bundle.empty_cache(batch, cl, cfg.torch_dtype(), "meta")
        got = sharding.cache_sharding(cfg, pmesh, cache, batch)
        assert set(got) == set(want)
        for name, t in cache.items():
            assert tuple(t.shape) == tuple(jcache[name].shape), name
            assert _norm(got[name].spec, t.dim()) == \
                _norm(want[name].spec, t.dim()), (arch, batch, name)


def test_policy_modes_equal_jax():
    """The attention and KV-cache modes of both packages' policies for
    the archs of the JAX package's fallback and cache-mode tests."""
    jmesh = _jax_mesh(False)
    pmesh = port_mesh.make_production_mesh()
    for arch, attn in (("qwen3-32b", "heads"),
                       ("phi4-mini-3.8b", "replicated"),
                       ("paligemma-3b", "replicated"),
                       ("whisper-large-v3", "replicated"),
                       ("phi3-mini-3.8b", "heads")):
        pol = sharding.make_policy(get_config(arch), pmesh)
        jpol = jax_sharding.make_policy(jax_get_config(arch), jmesh)
        assert pol.attn_mode == jpol.attn_mode == attn, arch
    for arch, kv in (("phi3-mini-3.8b", "kv_heads"), ("qwen3-32b", "sequence"),
                     ("yi-6b", "sequence"), ("deepseek-moe-16b", "kv_heads")):
        pol = sharding.make_policy(get_config(arch), pmesh)
        jpol = jax_sharding.make_policy(jax_get_config(arch), jmesh)
        assert pol.kv_cache_mode == jpol.kv_cache_mode == kv, arch
    for arch in ARCHS:
        for fallback in ("replicated", "head_dim"):
            pol = sharding.make_policy(get_config(arch), pmesh,
                                       attn_fallback=fallback)
            jpol = jax_sharding.make_policy(jax_get_config(arch), jmesh,
                                            attn_fallback=fallback)
            assert (pol.attn_mode, pol.kv_cache_mode) == \
                (jpol.attn_mode, jpol.kv_cache_mode), (arch, fallback)


def test_batch_sharding_and_data_axes_equal_jax():
    for multi_pod in (False, True):
        jmesh = _jax_mesh(multi_pod)
        pmesh = port_mesh.make_production_mesh(multi_pod=multi_pod)
        assert sharding.data_axes(pmesh) == jax_sharding.data_axes(jmesh)
        cfg, jcfg = get_config("yi-6b"), jax_get_config("yi-6b")
        for batch in (256, 96, 1):
            tree = {"tokens": np.zeros((batch, 8), np.int32),
                    "lengths": np.zeros((batch,), np.int32)}
            got = sharding.batch_sharding(cfg, pmesh, tree, batch)
            want = jax_sharding.batch_sharding(jcfg, jmesh, tree, batch)
            for k, v in tree.items():
                assert _norm(got[k].spec, v.ndim) == \
                    _norm(want[k].spec, v.ndim), (multi_pod, batch, k)


def _rank_mesh(model, rank):
    """A (1, model) mesh at ``rank``, with no process group: enough for
    ``shard_local``'s slices."""
    return port_mesh.Mesh((1, model), ("data", "model"),
                           coords={"data": 0, "model": rank})


def test_shard_local_slices_and_refuses():
    t = torch.arange(4 * 6 * 8).reshape(4, 6, 8)
    spec = (None, "model", None)
    parts = [sharding.shard_local(t, spec, _rank_mesh(3, r))
             for r in range(3)]
    assert torch.equal(torch.cat(parts, dim=1), t)
    assert all(p.is_contiguous() and p.shape == (4, 2, 8) for p in parts)
    assert parts[1].data_ptr() != t.data_ptr()          # a copy of its own
    # nothing split: the tensor itself
    assert sharding.shard_local(t, (None, None), _rank_mesh(3, 2)) is t
    assert sharding.local_shape((4, 6, 8), spec, _rank_mesh(3, 0)) == \
        (4, 2, 8)
    with pytest.raises(ValueError, match="not divisible"):
        sharding.shard_local(t, ("model",), _rank_mesh(3, 0))
    with pytest.raises(ValueError, match="not divisible"):
        sharding.local_shape((4, 6, 8), (None, None, "model"),
                             _rank_mesh(3, 0))
    with pytest.raises(ValueError, match="abstract"):
        sharding.shard_local(t, spec, port_mesh.make_production_mesh())
    # a dim over two axes: row-major in the entry's axis order
    m = port_mesh.Mesh((2, 3), ("data", "model"),
                       coords={"data": 1, "model": 2})
    got = sharding.shard_local(torch.arange(12), (("data", "model"),), m)
    assert got.tolist() == [10, 11]


def test_meshes():
    prod = port_mesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.abstract
    multi = port_mesh.make_production_mesh(multi_pod=True)
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    with pytest.raises(ValueError, match="must be >= 1"):
        port_mesh.make_serving_mesh(0)
    if not torch.distributed.is_initialized():
        with pytest.raises(ValueError, match="torchrun"):
            port_mesh.make_serving_mesh(2, device="cpu")
    # the card's constants, never a TPU's
    assert port_mesh.PEAK_FLOPS_BF16 == 989e12
    assert port_mesh.HBM_BW == 3.35e12 and port_mesh.NVLINK_BW == 450e9

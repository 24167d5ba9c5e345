"""The port's fixed-point requantization is bit-identical to the JAX
package's (jnp under x64) and to the numpy twin, on seeded sweeps that
include negative accumulators, both shift directions, saturation at the
int8 rails and the int32 extremes."""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.quantize as JQ
import repro_torch.core.quantize as TQ

INT32_MIN, INT32_MAX = -(2 ** 31), 2 ** 31 - 1


@pytest.fixture(scope="module", autouse=True)
def _jax_x64_alias():
    """The JAX package spells the scoped x64 switch
    ``jax.experimental.enable_x64``, which newer jax moved to
    ``jax.enable_x64``.  Alias it for this module's tests only and undo
    it afterwards; a no-op where the old name exists."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                       raising=False)
        yield


def _sweep(seed, n=4096, channels=None):
    """Accumulators, multipliers and shifts as the int8 ops produce them,
    plus the int32 extremes."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-(1 << 22), 1 << 22, n).astype(np.int32)
    acc[:8] = [0, -1, 1, INT32_MIN, INT32_MAX, -(1 << 20), 1 << 20, -3]
    c = channels or 1
    real = rng.uniform(1e-6, 0.9, c) * np.where(rng.random(c) < 0.2, 4.0,
                                                 1.0)
    ms, ss = zip(*(TQ.quantize_multiplier(float(r)) for r in real))
    mult, shift = np.asarray(ms, np.int32), np.asarray(ss, np.int32)
    if channels:
        acc = acc[: n - n % c].reshape(-1, c)
    else:
        mult, shift = mult[0], shift[0]
    zp = int(rng.integers(-128, 128))
    return acc, mult, shift, zp


def _torch_requant(acc, mult, shift, zp, qmin=-128, qmax=127):
    return TQ.requantize(torch.from_numpy(acc), torch.as_tensor(mult),
                         torch.as_tensor(shift, dtype=torch.int64), zp,
                         qmin, qmax).numpy()


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("channels", [None, 7])
def test_requantize_bit_identical_to_jax(seed, channels):
    acc, mult, shift, zp = _sweep(seed, channels=channels)
    with JQ.x64_scope():
        want = np.asarray(JQ.requantize(jnp.asarray(acc), mult, shift, zp))
    got = _torch_requant(acc, mult, shift, zp)
    np.testing.assert_array_equal(got, want)
    assert (got == 127).any() and (got == -128).any()      # saturates


@pytest.mark.parametrize("seed", range(6))
def test_requantize_bit_identical_to_numpy_twin(seed):
    acc, mult, shift, zp = _sweep(seed)
    want = JQ.requantize_np(acc, int(mult), int(shift), zp)
    np.testing.assert_array_equal(_torch_requant(acc, mult, shift, zp), want)
    np.testing.assert_array_equal(
        TQ.requantize_np(acc, int(mult), int(shift), zp), want)


@pytest.mark.parametrize("qmin,qmax", [(-128, 127), (-5, 100), (0, 127)])
def test_requantize_activation_clamp(qmin, qmax):
    acc, mult, shift, zp = _sweep(11, channels=3)
    with JQ.x64_scope():
        want = np.asarray(JQ.requantize(jnp.asarray(acc), mult, shift, zp,
                                        qmin, qmax))
    np.testing.assert_array_equal(
        _torch_requant(acc, mult, shift, zp, qmin, qmax), want)


def test_multiply_by_quantized_multiplier_edges():
    """The gemmlowp corner cases: INT32_MIN * INT32_MIN saturates, odd
    negative halves truncate toward zero, left shifts wrap in int32."""
    x = np.array([INT32_MIN, -1, 1, -(1 << 29), INT32_MAX, 12345, -7],
                 np.int32)
    for mult, shift in [(INT32_MIN, 0), (1 << 30, 0), (1610612736, -1),
                        (1 << 30, 3), (1073741824 + 12345, -31)]:
        want = JQ.multiply_by_quantized_multiplier_np(x, mult, shift)
        got = TQ.multiply_by_quantized_multiplier(torch.from_numpy(x), mult,
                                                  shift)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("real", [0.0, 1e-12, 3.7e-5, 0.25, 0.5,
                                  0.9999999999, 1.0, 7.5, 1234.5])
def test_quantize_multiplier_matches(real):
    assert TQ.quantize_multiplier(real) == JQ.quantize_multiplier(real)


def test_export_time_numpy_helpers_match():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.3, (8, 3, 3, 5)).astype(np.float32)
    for axis in (0, 3):
        for a, b in zip(TQ.quantize_weights_per_channel(w, axis),
                        JQ.quantize_weights_per_channel(w, axis)):
            np.testing.assert_array_equal(a, b)
    b = rng.normal(0, 0.1, 8).astype(np.float32)
    s = rng.uniform(1e-3, 1e-2, 8).astype(np.float32)
    np.testing.assert_array_equal(TQ.quantize_bias(b, 0.02, s),
                                  JQ.quantize_bias(b, 0.02, s))
    for lo, hi in [(-1.5, 2.0), (0.0, 6.0), (0.3, 0.9), (-2.0, -1.0),
                   (0.0, 0.0)]:
        assert TQ.choose_quant_params(lo, hi) == \
            JQ.choose_quant_params(lo, hi)
    x = rng.normal(0, 1, 100).astype(np.float32)
    np.testing.assert_array_equal(TQ.quantize_array(x, 0.03, -4),
                                  JQ.quantize_array(x, 0.03, -4))


def test_requant_spec_matches_and_moves_to_device():
    ws = np.array([0.01, 0.002, 0.3], np.float32)
    a = TQ.RequantSpec.build(0.05, ws, 0.1, 3, -2)
    b = JQ.RequantSpec.build(0.05, ws, 0.1, 3, -2)
    np.testing.assert_array_equal(a.multiplier, b.multiplier)
    np.testing.assert_array_equal(a.shift, b.shift)
    assert a.nbytes() == b.nbytes()
    mult, shift = a.on("cpu")
    assert mult.dtype == torch.int32 and shift.dtype == torch.int64
    np.testing.assert_array_equal(mult.numpy(), a.multiplier)

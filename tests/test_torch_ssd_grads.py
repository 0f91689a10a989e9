"""The SSD scan's gradients, the port's against the reference's.

``models.ssm._segsum_decay`` masks the exponent before ``exp`` where the
reference masks after it. The values are the same (tested here and in
tests/test_torch_models.py); the gradients are the same wherever the
reference's are finite, and stay finite where a chunk's decays are large
enough for ``exp`` above the diagonal to overflow, which gives the
reference NaN gradients (its ``where``'s backward multiplies the inf by
0). mamba2-1.3b at full width with random weights reaches that in its
first train step.

Tolerance: floats within ``2e-4 * max|ref| + 1e-5`` in float32, as in
tests/test_torch_models.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as RSSM

from repro_torch.models import ssm as SSM

B, S, H, P, N, CHUNK = 2, 32, 4, 8, 16, 16


def _inputs(scale):
    rng = np.random.default_rng(0)
    xdt = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dA = (-np.abs(rng.standard_normal((B, S, H))) * scale).astype(np.float32)
    B_ = rng.standard_normal((B, S, N)).astype(np.float32)
    C_ = rng.standard_normal((B, S, N)).astype(np.float32)
    w = rng.standard_normal((B, S, H, P)).astype(np.float32)
    return xdt, dA, B_, C_, w


def _ref(xdt, dA, B_, C_, w):
    def f(*a):
        return jnp.sum(RSSM.ssd_chunked(*a, CHUNK)[0] * w)
    args = tuple(map(jnp.asarray, (xdt, dA, B_, C_)))
    y = RSSM.ssd_chunked(*args, CHUNK)[0]
    return np.asarray(y), [np.asarray(g) for g in
                           jax.grad(f, argnums=(0, 1, 2, 3))(*args)]


def _port(xdt, dA, B_, C_, w):
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (xdt, dA, B_, C_)]
    y = SSM.ssd_chunked(*args, CHUNK)[0]
    grads = torch.autograd.grad((y * torch.from_numpy(w)).sum(), args)
    return y.detach().numpy(), [g.numpy() for g in grads]


def _close(got, want):
    assert got.shape == want.shape
    tol = 2e-4 * np.abs(want).max() + 1e-5
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("scale", [0.3, 2.0])
def test_ssd_gradients_match_the_reference_where_it_is_finite(scale):
    ins = _inputs(scale)
    y_ref, g_ref = _ref(*ins)
    y, g = _port(*ins)
    assert all(np.isfinite(a).all() for a in g_ref)
    _close(y, y_ref)
    for a, b in zip(g, g_ref):
        _close(a, b)


def test_ssd_gradients_stay_finite_where_exp_overflows():
    """Decays of about -50 a step: 15 steps above the diagonal of a
    chunk of 16 give exp(750), an overflow in float32. The values are the
    reference's; its gradients are NaN, the port's finite."""
    ins = _inputs(50.0)
    y_ref, g_ref = _ref(*ins)
    y, g = _port(*ins)
    _close(y, y_ref)
    assert not all(np.isfinite(a).all() for a in g_ref)
    assert all(np.isfinite(a).all() for a in g)

"""The port's fused RMSNorm+matmul (K4) on CPU tensors against the JAX
package's ``rmsnorm_matmul(impl="pallas")`` in interpret mode.

The port's wrapper runs the plain composition for CPU tensors; its
backward is autograd of that composition with the projection's products
written out. Forward and the gradients of x, scale and w are held against
the JAX kernel and ``jax.vjp`` of its custom VJP. Inputs come from
``numpy.random.default_rng`` in float32.

Tolerance 2e-5 (abs and rel): the same float32 normaliser and products
over D = 64 (and the backward's sums over M rows), in another summation
order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.kernels import fused_collective_matmul as jax_fcm
from deepspeed_tpu_torch.kernels import fused_collective_matmul as port_fcm

pytestmark = pytest.mark.torch_port

TOL = dict(atol=2e-5, rtol=2e-5)
EPS = 1e-5


def _inputs(seed, lead, D, F):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=lead + (D,)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    w = (rng.normal(size=(D, F)) / np.sqrt(D)).astype(np.float32)
    g = rng.normal(size=lead + (F,)).astype(np.float32)
    return x, scale, w, g


@pytest.mark.parametrize("lead,D,F", [((2, 24), 64, 48), ((100,), 64, 40)])
def test_forward_and_grads_match_pallas(lead, D, F):
    x, scale, w, g = _inputs(len(lead) + F, lead, D, F)
    y_j, vjp = jax.vjp(
        lambda a, s, b: jax_fcm.rmsnorm_matmul(a, s, b, EPS, impl="pallas"),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(w))
    dx_j, ds_j, dw_j = vjp(jnp.asarray(g))

    xt, st, wt = (torch.from_numpy(a).requires_grad_() for a in (x, scale, w))
    y = port_fcm.rmsnorm_matmul(xt, st, wt, EPS)
    dx, ds, dw = torch.autograd.grad(y, (xt, st, wt), torch.from_numpy(g))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(dx.numpy(), np.asarray(dx_j), **TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(ds_j), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **TOL)
    assert port_fcm.rmsnorm_matmul_fwd.launches == 0      # CPU: no kernel


def test_plain_version_is_the_unfused_composition():
    """The plain forward is rms_norm followed by the projection, exactly
    (the same operations in the same order)."""
    from deepspeed_tpu_torch.models.transformer import rms_norm

    x, scale, w, _ = _inputs(7, (3, 16), 64, 32)
    xt, st, wt = (torch.from_numpy(a) for a in (x, scale, w))
    fused = port_fcm.rmsnorm_matmul(xt, st, wt, EPS)
    torch.testing.assert_close(fused, rms_norm(xt, st, EPS) @ wt, rtol=0,
                               atol=0)


def test_bf16_rounding_order_matches_the_reference_composition():
    """bf16: the normaliser is cast to bf16 before the products and each
    product rounds to bf16, as ``rms_norm`` does."""
    x, scale, w, _ = _inputs(8, (5,), 64, 16)
    xt, st, wt = (torch.from_numpy(a).bfloat16() for a in (x, scale, w))
    var = xt.float().square().mean(-1, keepdim=True)
    h = (xt * torch.rsqrt(var + EPS).bfloat16()) * st
    expect = torch.matmul(h, wt)
    out = port_fcm.rmsnorm_matmul(xt, st, wt, EPS)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out, expect, rtol=0, atol=0)


@pytest.mark.parametrize("rows,D", [(256, 64), (100, 4096)])
def test_row_normaliser_prepass_matches_rms_norm_and_jax(rows, D):
    """The plain version of the bf16 pre-pass: each row's normaliser in
    float32, rounded to bf16. Bit-equal to the normaliser ``rms_norm``
    multiplies by (x * r with scale 1), and equal to the JAX ``rms_norm``'s
    ``rsqrt(var + eps).astype(x.dtype)`` (the tolerance of the bf16
    rounding-order test, 0)."""
    from deepspeed_tpu_torch.models.transformer import rms_norm

    x, _, _, _ = _inputs(9 + D, (rows,), D, 8)
    xt = torch.from_numpy(x).bfloat16()
    r = port_fcm.rms_normaliser(xt, EPS)
    assert r.dtype == torch.bfloat16 and tuple(r.shape) == (rows, 1)
    torch.testing.assert_close(xt * r, rms_norm(xt, torch.ones(D).bfloat16(),
                                                EPS), rtol=0, atol=0)
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16)
    var = jnp.mean(jnp.square(xj.astype(jnp.float32)), axis=-1,
                   keepdims=True)
    rj = jax.lax.rsqrt(var + EPS).astype(xj.dtype)
    np.testing.assert_array_equal(r.float().numpy(),
                                  np.asarray(rj.astype(jnp.float32)))

"""The port's flash attention (K1-K3) on CPU tensors against the JAX
package's Pallas flash attention in interpret mode (its own CPU route).

The port's wrappers run their plain PyTorch versions for CPU tensors: the
forward (O and LSE) against the JAX ``_fwd``; the backward's recompute
math (dQ, dK, dV from the LSE and δ) against the JAX ``_bwd``; and the
autograd Function behind ``flash_attention`` against ``jax.vjp`` of the
JAX ``flash_attention``, GQA repeat included. Inputs come from
``numpy.random.default_rng`` and feed both packages in float32.

Tolerance 2e-5 (abs and rel): both sides compute the same float32 softmax
and products over at most 256 keys, in a different summation order (the
JAX kernels walk 128- or 256-key blocks with an online softmax, the plain
versions take one dense softmax), which moves results by a few float32
ulps of values up to ~10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.transformer import flash_attention as jax_fa
from deepspeed_tpu_torch.ops.transformer import flash_attention as port_fa

pytestmark = pytest.mark.torch_port

TOL = dict(atol=2e-5, rtol=2e-5)
B, H, KV, HD = 2, 4, 2, 64


def _inputs(seed, S, kv_heads=KV):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    k = rng.normal(size=(B, S, kv_heads, HD)).astype(np.float32)
    v = rng.normal(size=(B, S, kv_heads, HD)).astype(np.float32)
    do = rng.normal(size=(B, S, H, HD)).astype(np.float32)
    return q, k, v, do


def _bhsd(x):
    return jnp.asarray(np.ascontiguousarray(x.transpose(0, 2, 1, 3)))


def _bshd(x):
    return np.asarray(x).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [100, 256])
def test_plain_kernels_match_pallas_kernels(causal, S):
    """K1's plain forward against ``_fwd``; K2's and K3's plain backward
    against ``_bwd`` on the same saved O and LSE (H = KV here: the kernels
    see repeated heads)."""
    q, k, v, do = _inputs(S, S, kv_heads=H)
    scale = 1.0 / np.sqrt(HD)
    block = 128 if S <= 128 else 256
    o_j, lse_j = jax_fa._fwd(_bhsd(q), _bhsd(k), _bhsd(v), scale, causal,
                             block, block)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    o_p, lse_p = port_fa.flash_attention_fwd(t[0], t[1], t[2], causal, scale)
    np.testing.assert_allclose(o_p.numpy(), _bshd(o_j), **TOL)
    np.testing.assert_allclose(lse_p.numpy(), np.asarray(lse_j), **TOL)

    dq_j, dk_j, dv_j = jax_fa._bwd(
        scale, causal, block, block,
        (_bhsd(q), _bhsd(k), _bhsd(v), o_j, lse_j), _bhsd(do))
    # the port's backward from the JAX forward's O and LSE: δ as in _bwd
    o_t = torch.from_numpy(_bshd(o_j).copy())
    lse_t = torch.from_numpy(np.asarray(lse_j).copy())
    delta = (t[3] * o_t).sum(-1).transpose(1, 2).contiguous()
    dq = port_fa.flash_attention_bwd_dq(*t, lse_t, delta, causal, scale)
    dk, dv = port_fa.flash_attention_bwd_dkv(*t, lse_t, delta, causal, scale)
    np.testing.assert_allclose(dq.numpy(), _bshd(dq_j), **TOL)
    np.testing.assert_allclose(dk.numpy(), _bshd(dk_j), **TOL)
    np.testing.assert_allclose(dv.numpy(), _bshd(dv_j), **TOL)
    assert port_fa.flash_attention_fwd.launches == 0     # CPU: no kernel
    assert port_fa.flash_attention_bwd_dq.launches == 0
    assert port_fa.flash_attention_bwd_dkv.launches == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [100, 256])
def test_autograd_function_matches_jax_vjp(causal, S):
    """``flash_attention`` with GQA (H 4, KV 2, hd 64): output and the
    gradients of q, k, v (dK, dV summed over each group by autograd of
    the repeat) against ``jax.vjp`` of the JAX ``flash_attention``."""
    q, k, v, do = _inputs(10 + S, S)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_fa.flash_attention(a, b, c, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    dq_j, dk_j, dv_j = vjp(jnp.asarray(do))

    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = port_fa.flash_attention(qt, kt, vt, causal=causal)
    dq, dk, dv = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), **TOL)
    np.testing.assert_allclose(dk.numpy(), np.asarray(dk_j), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(dv_j), **TOL)


def test_causal_first_row_sees_only_itself():
    """Row 0 of causal attention is v[0] exactly and its LSE is its own
    scaled score (masked scores weigh exactly 0, as with -1e30)."""
    q, k, v, _ = _inputs(3, 5, kv_heads=H)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = port_fa.flash_attention_fwd(*t, causal=True)
    np.testing.assert_array_equal(o[:, 0].numpy(), v[:, 0])
    own = (q[:, 0] * k[:, 0]).sum(-1) / np.sqrt(HD)          # [B, H]
    np.testing.assert_allclose(lse[:, :, 0].numpy(), own, rtol=1e-6,
                               atol=1e-6)


def test_rejects_heads_that_do_not_divide():
    q = torch.zeros(1, 4, 6, 64)
    k = torch.zeros(1, 4, 4, 64)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        port_fa.flash_attention(q, k, k)

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


# --------------------------------------------------------------------- #
# The bf16 kernels' tile walk (csrc/flash_attention_bwd.cu), emulated
# --------------------------------------------------------------------- #
OWN, WALK = 128, 64          # rows a CTA owns / of a walked tile (wg::)


def _emulate_bwd(q, k, v, do, lse, delta, causal, scale, rounding):
    """dQ, dK, dV as the bf16 kernels walk them: CTAs of ``OWN`` rows, two
    warpgroups of 64, walked tiles of ``WALK`` rows; rows past S read as
    zeros (TMA's fill), the dK/dV stage's lse/delta rows come from the flat
    ``[B*H*S]`` vectors (the next head's rows past S, zeros at the end);
    float32 sums tile after tile in the kernels' order; with ``rounding``,
    P and dS rounded to bf16 per tile before the second products, and each
    output once. Each skipped (warpgroup, tile) pair is checked to be fully
    masked, and each tile left unmasked to need no mask."""
    B, S, H, hd = q.shape
    rnd = (lambda x: x.bfloat16().float()) if rounding else (lambda x: x)
    n_own = -(-S // OWN)
    nw = -(-S // WALK)
    rows = n_own * OWN + WALK

    def pad(x):
        return torch.cat([x, x.new_zeros(rows - S, hd)])

    flat_lse = torch.cat([lse.reshape(-1), lse.new_zeros(WALK)])
    flat_delta = torch.cat([delta.reshape(-1), delta.new_zeros(WALK)])
    dq = torch.zeros(B, S, H, hd)
    dk, dv = torch.zeros_like(dq), torch.zeros_like(dq)
    for b in range(B):
        for h in range(H):
            qb, kb, vb, dob = (pad(x[b, :, h].float()) for x in (q, k, v, do))
            bh = b * H + h
            for tile in range(n_own):
                t0 = tile * OWN
                for w0 in (t0, t0 + 64):                 # the two warpgroups
                    own = torch.arange(w0, w0 + 64)
                    valid = own < S
                    # dQ: query rows `own`, key tiles up to the diagonal
                    n_k = min(nw, (t0 + OWN) // WALK) if causal else nw
                    lse_r = torch.where(valid, lse[b, h].index_select(
                        0, own.clamp(max=S - 1)), 0.0)[:, None]
                    delta_r = torch.where(valid, delta[b, h].index_select(
                        0, own.clamp(max=S - 1)), 0.0)[:, None]
                    acc = torch.zeros(64, hd)
                    for j0 in range(0, n_k * WALK, WALK):
                        keys = torch.arange(j0, j0 + WALK)
                        mask = (keys[None] < S) & (
                            (own[:, None] >= keys[None]) | (not causal))
                        if w0 >= S or (causal and j0 > w0):
                            assert not mask[valid].any()
                            continue
                        edge = (causal and j0 == w0) or j0 + WALK > S
                        if not edge:
                            assert mask[valid].all()
                        s = qb[w0:w0 + 64] @ kb[j0:j0 + WALK].T
                        dp = dob[w0:w0 + 64] @ vb[j0:j0 + WALK].T
                        ok = mask if edge else torch.ones_like(mask)
                        p = torch.where(ok, torch.exp(s * scale - lse_r), 0.0)
                        ds = torch.where(ok, p * (dp - delta_r) * scale, 0.0)
                        acc += rnd(ds) @ kb[j0:j0 + WALK]
                    dq[b, own[valid], h] = acc[valid]
                    # dK, dV: keys `own`, query tiles from the first that
                    # sees them; the tile's lse/delta from the flat rows
                    first = t0 // WALK if causal else 0
                    acc_k, acc_v = torch.zeros(64, hd), torch.zeros(64, hd)
                    for q0 in range(first * WALK, nw * WALK, WALK):
                        qs = torch.arange(q0, q0 + WALK)
                        mask = (qs[None] < S) & (
                            (qs[None] >= own[:, None]) | (not causal))
                        if w0 >= S or (causal and q0 < w0):
                            assert not mask[valid].any()
                            continue
                        edge = (causal and q0 == w0) or q0 + WALK > S
                        if not edge:
                            assert mask[valid].all()
                        lse_t = flat_lse[bh * S + q0:bh * S + q0 + WALK]
                        delta_t = flat_delta[bh * S + q0:bh * S + q0 + WALK]
                        st = kb[w0:w0 + 64] @ qb[q0:q0 + WALK].T
                        dpt = vb[w0:w0 + 64] @ dob[q0:q0 + WALK].T
                        ok = mask if edge else torch.ones_like(mask)
                        p = torch.where(ok, torch.exp(st * scale - lse_t), 0.0)
                        ds = torch.where(ok, p * (dpt - delta_t) * scale, 0.0)
                        acc_v += rnd(p) @ dob[q0:q0 + WALK]
                        acc_k += rnd(ds) @ qb[q0:q0 + WALK]
                    dk[b, own[valid], h] = acc_k[valid]
                    dv[b, own[valid], h] = acc_v[valid]
    return rnd(dq), rnd(dk), rnd(dv)


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 257])
def test_bf16_tile_walk_emulation(S, causal, hd, rounding):
    """The bf16 kernels' tile walk on the CPU (``_emulate_bwd``). Without
    rounding it must match the plain backward within ``TOL`` (float32 sums
    in another order); with P and dS rounded to bf16 it must stay within
    the limit ``chip_smoke.py`` holds the card's K2 and K3 to
    (``FLASH_BF16_TERMS`` of the terms' magnitudes on top of two output
    ulps, ``BF16_RTOL``) of the JAX ``_bwd`` in interpret mode, on inputs
    rounded to bf16 values. B 1, H 2."""
    import chip_smoke

    rng = np.random.default_rng(1000 + S + hd)
    q, k, v, do = (rng.normal(size=(1, S, 2, hd)).astype(np.float32)
                   for _ in range(4))
    if rounding:
        q, k, v, do = (torch.from_numpy(x).bfloat16().float().numpy()
                       for x in (q, k, v, do))
    scale = 1.0 / np.sqrt(hd)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    if not rounding:
        o, lse = port_fa.flash_attention_fwd(t[0], t[1], t[2], causal, scale)
        delta = (t[3] * o).sum(-1).transpose(1, 2).contiguous()
        got = _emulate_bwd(*t, lse, delta, causal, scale, rounding=False)
        want = (port_fa.flash_attention_bwd_dq_reference(
            *t, lse, delta, causal, scale),
            *port_fa.flash_attention_bwd_dkv_reference(
                *t, lse, delta, causal, scale))
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), w_.numpy(), **TOL)
        return

    block = 128 if S <= 128 else 256
    o_j, lse_j = jax_fa._fwd(_bhsd(q), _bhsd(k), _bhsd(v), scale, causal,
                             block, block)
    want = jax_fa._bwd(scale, causal, block, block,
                       (_bhsd(q), _bhsd(k), _bhsd(v), o_j, lse_j), _bhsd(do))
    want = [torch.from_numpy(_bshd(x).copy()) for x in want]
    o_t = torch.from_numpy(_bshd(o_j).copy())
    lse = torch.from_numpy(np.asarray(lse_j).copy())
    delta = (t[3] * o_t).sum(-1).transpose(1, 2).contiguous()
    got = _emulate_bwd(*t, lse, delta, causal, scale, rounding=True)
    p, ds = port_fa.probs_and_ds(*t, lse, delta, causal, scale)
    terms = (torch.einsum("bhqk,bkhd->bqhd", ds.abs(), t[1].abs()),
             torch.einsum("bhqk,bqhd->bkhd", ds.abs(), t[0].abs()),
             torch.einsum("bhqk,bqhd->bkhd", p.abs(), t[3].abs()))
    for name, g_, w_, bound in zip(("dQ", "dK", "dV"), got, want, terms):
        limit = (chip_smoke.BF16_ATOL + chip_smoke.BF16_RTOL * w_.abs()
                 + chip_smoke.FLASH_BF16_TERMS * bound)
        worst = float(((g_ - w_).abs() / limit).max())
        assert worst <= 1.0, f"{name}: {worst:.3f}x chip_smoke's limit"


# --------------------------------------------------------------------- #
# The bf16 forward's tile walk (csrc/flash_attention_fwd.cu), emulated
# --------------------------------------------------------------------- #
FWD_WALK = 128               # keys of the forward's walked tile (wg::kWalk)


def _emulate_fwd(q, k, v, causal, scale, rounding):
    """O and the LSE as the bf16 forward walks them: CTAs of ``OWN`` query
    rows, two warpgroups of 64, key tiles of ``FWD_WALK``; rows and keys
    past S read as zeros (TMA's fill); the online softmax in base 2 (the
    running max m2 of s·scale·log2 e and the sum l, P = 2^(s2 − m2), LSE =
    (m2 + log2 l)·ln 2), masked scores −1e30·log2 e; the mask only on the
    last tile a warpgroup sees, each skipped tile checked to be fully
    masked and each earlier tile to need no mask; with ``rounding``, P
    rounded to bf16 before P·V and O once."""
    B, S, H, hd = q.shape
    rnd = (lambda x: x.bfloat16().float()) if rounding else (lambda x: x)
    c = torch.tensor(scale, dtype=torch.float32) * np.float32(np.log2(np.e))
    masked = torch.tensor(-1e30, dtype=torch.float32) * np.float32(
        np.log2(np.e))
    n_own, nk = -(-S // OWN), -(-S // FWD_WALK)

    def pad(x, rows):
        return torch.cat([x, x.new_zeros(rows - S, hd)])

    o = torch.zeros(B, S, H, hd)
    lse = torch.zeros(B, H, S)
    for b in range(B):
        for h in range(H):
            qb = pad(q[b, :, h].float(), n_own * OWN)
            kb, vb = (pad(x[b, :, h].float(), nk * FWD_WALK) for x in (k, v))
            for tile in range(n_own):
                q0 = tile * OWN
                n_tiles = (min(nk, -(-(q0 + OWN) // FWD_WALK)) if causal
                           else nk)
                for rw in (q0, q0 + 64):                 # the two warpgroups
                    own = torch.arange(rw, rw + 64)
                    valid = own < S
                    nv = (0 if rw >= S else
                          min(n_tiles, (rw + 63) // FWD_WALK + 1) if causal
                          else n_tiles)
                    m2 = torch.full((64,), float(masked))
                    l = torch.zeros(64)
                    acc = torch.zeros(64, hd)
                    for jt in range(n_tiles):
                        j0 = jt * FWD_WALK
                        keys = torch.arange(j0, j0 + FWD_WALK)
                        mask = (keys[None] < S) & (
                            (own[:, None] >= keys[None]) | (not causal))
                        if jt >= nv:
                            assert not mask[valid].any()
                            continue
                        edge = jt == nv - 1
                        if not edge:
                            assert mask[valid].all()
                        s2 = (qb[rw:rw + 64] @ kb[j0:j0 + FWD_WALK].T) * c
                        if edge:
                            s2 = torch.where(mask, s2, masked)
                        mx = torch.maximum(m2, s2.amax(1))
                        alpha = torch.exp2(m2 - mx)
                        m2 = mx
                        p = torch.exp2(s2 - m2[:, None])
                        l = alpha * l + p.sum(1)
                        acc = (acc * alpha[:, None]
                               + rnd(p) @ vb[j0:j0 + FWD_WALK])
                    l = torch.where(l == 0, 1.0, l)
                    o[b, own[valid], h] = (acc / l[:, None])[valid]
                    lse[b, h, own[valid]] = ((m2 + torch.log2(l))
                                             * np.float32(np.log(2)))[valid]
    return rnd(o), lse


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 128, 129, 257])
def test_bf16_fwd_tile_walk_emulation(S, causal, hd, rounding):
    """The bf16 forward's tile walk on the CPU (``_emulate_fwd``). Without
    rounding it must match the plain forward within ``TOL`` (float32 sums
    in another order, base-2 exponentials); with P rounded to bf16 it must
    stay within the limit ``chip_smoke.py`` holds the card's K1 to
    (``FLASH_BF16_TERMS`` of |P|@|V| on top of two output ulps,
    ``BF16_RTOL``) of the JAX ``_fwd`` in interpret mode, on inputs rounded
    to bf16 values; the LSE within 1e-4 + 1e-5·|ref| either way. B 1, H 2.
    """
    import chip_smoke

    rng = np.random.default_rng(2000 + S + hd)
    q, k, v = (rng.normal(size=(1, S, 2, hd)).astype(np.float32)
               for _ in range(3))
    if rounding:
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (q, k, v))
    scale = 1.0 / np.sqrt(hd)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = _emulate_fwd(*t, causal, scale, rounding)
    if rounding:
        block = 128 if S <= 128 else 256
        o_j, lse_j = jax_fa._fwd(_bhsd(q), _bhsd(k), _bhsd(v), scale, causal,
                                 block, block)
        o_ref = torch.from_numpy(_bshd(o_j).copy())
        lse_ref = torch.from_numpy(np.asarray(lse_j).copy())
        s = torch.einsum("bqhd,bkhd->bhqk", *t[:2]) * scale
        if causal:
            s = torch.where(port_fa._causal_mask(S, s.device), s, -1e30)
        p = torch.exp(s - lse_ref[..., None])
        terms = torch.einsum("bhqk,bkhd->bqhd", p, t[2].abs())
        limit = (chip_smoke.BF16_ATOL + chip_smoke.BF16_RTOL * o_ref.abs()
                 + chip_smoke.FLASH_BF16_TERMS * terms)
        worst = float(((o - o_ref).abs() / limit).max())
        assert worst <= 1.0, f"O: {worst:.3f}x chip_smoke's limit"
    else:
        o_ref, lse_ref = port_fa.flash_attention_fwd_reference(*t, causal,
                                                               scale)
        np.testing.assert_allclose(o.numpy(), o_ref.numpy(), **TOL)
    np.testing.assert_array_less((lse - lse_ref).abs().numpy(),
                                 (1e-4 + 1e-5 * lse_ref.abs()).numpy())


# --------------------------------------------------------------------- #
# head dims off 64/128: the CUDA path's zero-pad-and-slice
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [16, 80, 96])
def test_padded_head_dim_matches_unpadded_and_pallas(hd, causal):
    """``run_padded`` (what the CUDA path calls: q, k, v, dO zero-padded
    to 64 or 128, the scale from the true hd, O/dQ/dK/dV sliced back, the
    LSE unchanged) around the plain versions, against the unpadded plain
    versions and the JAX ``_fwd``/``_bwd`` at that hd, within 2e-5 (the
    padded columns add +0 to float32 sums)."""
    rng = np.random.default_rng(hd + causal)
    S = 100
    q, k, v, do = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / np.sqrt(hd)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    assert port_fa.kernel_head_dim(hd) == (64 if hd <= 64 else 128)
    o, lse = port_fa.run_padded(port_fa.flash_attention_fwd_reference,
                                t[:3], 1, causal, scale)
    o_u, lse_u = port_fa.flash_attention_fwd_reference(*t[:3], causal, scale)
    assert o.shape == o_u.shape and o.is_contiguous()
    np.testing.assert_allclose(o.numpy(), o_u.numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), lse_u.numpy(), **TOL)
    o_j, lse_j = jax_fa._fwd(_bhsd(q), _bhsd(k), _bhsd(v), scale, causal,
                             128, 128)
    np.testing.assert_allclose(o.numpy(), _bshd(o_j), **TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j), **TOL)

    delta = (t[3] * o).sum(-1).transpose(1, 2).contiguous()
    dq = port_fa.run_padded(port_fa.flash_attention_bwd_dq_reference, t, 1,
                            lse, delta, causal, scale)
    dk, dv = port_fa.run_padded(port_fa.flash_attention_bwd_dkv_reference,
                                t, 2, lse, delta, causal, scale)
    dq_j, dk_j, dv_j = jax_fa._bwd(
        scale, causal, 128, 128,
        (_bhsd(q), _bhsd(k), _bhsd(v), o_j, lse_j), _bhsd(do))
    for got, ref in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.shape == (B, S, H, hd)
        np.testing.assert_allclose(got.numpy(), _bshd(ref), **TOL)
    np.testing.assert_allclose(
        dq.numpy(), port_fa.flash_attention_bwd_dq_reference(
            *t, lse, delta, causal, scale).numpy(), **TOL)


# --------------------------------------------------------------------- #
# head dims in (128, 256]: zero-padded to 256, the exact tile kernels
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", [160, 256])
def test_wide_head_dims_match_jax(hd, causal):
    """Head dims above 128 run (no refusal): ``run_padded`` (q, k, v, dO
    zero-padded to 256, the scale from the true hd, O/dQ/dK/dV sliced
    back) around the plain K1-K3 against the JAX ``flash_attention`` and
    its ``jax.vjp`` (the Pallas kernels in interpret mode) at that hd,
    within 2e-5; and the autograd Function behind the port's
    ``flash_attention`` against the same ``jax.vjp``."""
    rng = np.random.default_rng(hd + 7 * causal)
    S = 100
    q, k, v, do = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / np.sqrt(hd)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    assert port_fa.kernel_head_dim(hd) == 256
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_fa.flash_attention(a, b, c, causal=causal),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    o, lse = port_fa.run_padded(port_fa.flash_attention_fwd_reference,
                                t[:3], 1, causal, scale)
    assert o.shape == (B, S, H, hd)
    np.testing.assert_allclose(o.numpy(), np.asarray(out_j), **TOL)
    delta = (t[3] * o).sum(-1).transpose(1, 2).contiguous()
    dq = port_fa.run_padded(port_fa.flash_attention_bwd_dq_reference, t, 1,
                            lse, delta, causal, scale)
    dk, dv = port_fa.run_padded(port_fa.flash_attention_bwd_dkv_reference,
                                t, 2, lse, delta, causal, scale)
    for got, ref in zip((dq, dk, dv), grads_j):
        assert got.shape == (B, S, H, hd)
        np.testing.assert_allclose(got.numpy(), ref, **TOL)
    qkv = [x.clone().requires_grad_() for x in t[:3]]
    out = port_fa.flash_attention(*qkv, causal=causal)
    grads = torch.autograd.grad(out, qkv, t[3])
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    for got, ref in zip(grads, grads_j):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


@pytest.mark.parametrize("hd", [257, 320])
def test_head_dims_above_256_are_refused(hd):
    """No kernel is built wider than 256: ``kernel_head_dim`` and
    ``run_padded`` (the CUDA path of K1-K3 and K16-K19) raise, saying so;
    the widths up to 256 map to 64, 128 or 256."""
    for width, want in ((1, 64), (64, 64), (65, 128), (128, 128),
                        (129, 256), (200, 256), (256, 256)):
        assert port_fa.kernel_head_dim(width) == want
    with pytest.raises(ValueError, match="head_dim <= 256"):
        port_fa.kernel_head_dim(hd)
    x = torch.zeros(1, 4, 1, hd)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        port_fa.run_padded(port_fa.flash_attention_fwd_reference,
                           (x, x, x), 1, True, 1.0)

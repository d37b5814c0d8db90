"""The port's block-sparse attention (K16-K19) on CPU tensors against the
JAX package's (``deepspeed_tpu.ops.sparse_attention``), whose Pallas
kernels run in interpret mode here (their own CPU route).

* Layouts: the port's copy of the five config classes builds the same
  layouts, bit for bit (BigBird and Variable draw from
  ``random.Random(seed)`` in the same order).
* Kernels: the plain K16/K17 forward (O and LSE) against the JAX
  ``_bs_fwd`` with and without the LSE, and the autograd Function's dQ,
  dK, dV (plain K18/K19 from the LSE and δ) against ``jax.vjp`` of the
  JAX ``block_sparse_attention``.
* Edges: S not a multiple of the block, rows with no active block,
  layouts per head and shared, the masked-dense path's extras.

Inputs come from ``numpy.random.default_rng`` and feed both packages in
float32 (B 2, H 2, S 64-128, hd 32, block 16, as the JAX tests).

Tolerances: 2e-5 (abs and rel) for the forward — both sides take the
same float32 softmax over at most 128 keys, the JAX kernels one block at
a time with an online softmax, the plain version in one pass, so results
move by a few float32 ulps of values up to ~10. 1e-4 for the gradients —
three more float32 products (dP, dS, then dQ/dK/dV) over the same keys
in another order.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.sparse_attention import block_sparse_kernel as jax_bs
from deepspeed_tpu.ops.sparse_attention import sparse_self_attention as jax_ssa
from deepspeed_tpu.ops.sparse_attention import sparsity_config as jax_sc
from deepspeed_tpu_torch.ops.sparse_attention import block_sparse_kernel as bs
from deepspeed_tpu_torch.ops.sparse_attention import sparse_self_attention \
    as port_ssa
from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as port_sc

pytestmark = pytest.mark.torch_port

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
B, H, HD, BLOCK = 2, 2, 32, 16

# (class name, kwargs) of the layouts the kernel tests walk; every one
# has rows of different lengths, and Fixed unidirectional the diagonal
LAYOUTS = [
    ("FixedSparsityConfig", dict(num_local_blocks=2, num_global_blocks=1,
                                 attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(num_random_blocks=1,
                                   num_sliding_window_blocks=2,
                                   num_global_blocks=1)),
    ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                        global_block_indices=[0])),
    ("VariableSparsityConfig", dict(num_random_blocks=1,
                                    local_window_blocks=[1, 2],
                                    global_block_indices=[0, 3],
                                    attention="unidirectional")),
]

# wider coverage for the layout-equality test
CONFIGS = [
    ("DenseSparsityConfig", {}),
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional")),
    ("FixedSparsityConfig", dict(num_local_blocks=2, num_global_blocks=1,
                                 horizontal_global_attention=True,
                                 num_different_global_patterns=2)),
    ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                        global_block_indices=[0, 2],
                                        global_block_end_indices=[1, 4],
                                        attention="unidirectional")),
    ("BigBirdSparsityConfig", dict(num_random_blocks=2,
                                   num_sliding_window_blocks=3,
                                   num_global_blocks=1, seed=7)),
    ("VariableSparsityConfig", dict(num_random_blocks=1,
                                    local_window_blocks=[1, 2, 4],
                                    global_block_indices=[0, 5])),
]


def _configs(name, kw, heads=H, block=BLOCK, **extra):
    kw = dict(kw, **extra)
    return (getattr(jax_sc, name)(num_heads=heads, block=block, **kw),
            getattr(port_sc, name)(num_heads=heads, block=block, **kw))


def _qkv(S, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, H, S, HD)).astype(np.float32)
            for _ in range(n)]


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _jax_fwd(q, k, v, layout, want_lse, block=BLOCK):
    """The JAX forward pallas call (``_bs_fwd``), interpret mode, on q, k,
    v zero-padded to the layout's grid as ``block_sparse_attention`` pads
    them; O and the LSE sliced back to S."""
    S = q.shape[2]
    layout = np.ascontiguousarray(np.broadcast_to(
        layout, (q.shape[1],) + layout.shape[1:]))

    def pad(x, n):
        return jnp.pad(jnp.asarray(x),
                       ((0, 0), (0, 0), (0, n * block - S), (0, 0)))

    out, lse = jax_bs._bs_fwd(
        pad(q, layout.shape[1]), pad(k, layout.shape[2]),
        pad(v, layout.shape[2]), jax_bs._StaticArr(layout),
        jax_bs._StaticArr(jax_bs.build_fetch_table(layout)), block,
        1.0 / np.sqrt(q.shape[-1]), S, want_lse=want_lse)
    return (np.asarray(out)[:, :, :S],
            None if lse is None else np.asarray(lse)[:, :, :S, 0])


# --------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("seq_len", [64, 128, 256])
@pytest.mark.parametrize("name,kw", CONFIGS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CONFIGS)])
def test_layouts_identical_to_jax(name, kw, seq_len, per_head):
    jcfg, pcfg = _configs(name, kw, heads=4,
                          different_layout_per_head=per_head)
    a = np.asarray(jcfg.make_layout(seq_len))
    b = pcfg.make_layout(seq_len)
    assert b.dtype == a.dtype and b.shape == a.shape
    assert np.array_equal(a, b)


def test_layout_rejects_seq_len_off_the_block():
    _, pcfg = _configs("FixedSparsityConfig", {})
    with pytest.raises(ValueError, match="not divisible"):
        pcfg.make_layout(40)


def test_fetch_table_matches_jax():
    rng = np.random.default_rng(3)
    layout = rng.random((3, 7, 9)) < 0.3
    layout[1, 2] = False                                    # an empty row
    np.testing.assert_array_equal(bs.build_fetch_table(layout),
                                  jax_bs.build_fetch_table(layout))


def test_tables_list_active_blocks_and_share_one_head():
    _, pcfg = _configs("BigBirdSparsityConfig", LAYOUTS[1][1], heads=4)
    layout = pcfg.make_layout(128)                           # heads equal
    tables = bs.prepare_layout(layout, BLOCK, 4, "cpu")
    assert tables.num_layout_heads == 1
    assert bs.prepare_layout(layout, BLOCK, 4, "cpu") is tables
    assert tables.active_blocks(4) == 4 * int(layout[0].sum())
    rp, cols = tables.row_ptr.numpy(), tables.cols.numpy()
    rpt, colst = tables.row_ptr_t.numpy(), tables.cols_t.numpy()
    for i in range(tables.nq):
        assert list(cols[rp[i]:rp[i + 1]]) == list(np.nonzero(layout[0, i])[0])
        assert (list(colst[rpt[i]:rpt[i + 1]])
                == list(np.nonzero(layout[0, :, i])[0]))
    _, per = _configs("BigBirdSparsityConfig", LAYOUTS[1][1], heads=4,
                      different_layout_per_head=True)
    assert bs.prepare_layout(per.make_layout(128), BLOCK, 4,
                             "cpu").num_layout_heads == 4


# --------------------------------------------------------------------- #
# kernels: plain versions against the Pallas kernels
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("per_head", [False, True])
@pytest.mark.parametrize("name,kw", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_forward_matches_pallas_kernels(name, kw, per_head):
    """K16 (O, LSE) and K17 (O) plain versions against ``_bs_fwd`` with
    and without the LSE."""
    S = 128
    _, pcfg = _configs(name, kw, different_layout_per_head=per_head)
    layout = pcfg.make_layout(S)
    q, k, v = _qkv(S, seed=S, n=3)
    tables = bs.prepare_layout(layout, BLOCK, H, "cpu")
    o, lse = bs.block_sparse_fwd(*_t(q, k, v), tables)
    o_j, lse_j = _jax_fwd(q, k, v, layout, want_lse=True)
    np.testing.assert_allclose(o.numpy(), o_j, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **FWD_TOL)
    o2 = bs.block_sparse_fwd_nolse(*_t(q, k, v), tables)
    o2_j, _ = _jax_fwd(q, k, v, layout, want_lse=False)
    np.testing.assert_allclose(o2.numpy(), o2_j, **FWD_TOL)


@pytest.mark.parametrize("name,kw", LAYOUTS, ids=[n for n, _ in LAYOUTS])
def test_gradients_match_jax_grad(name, kw):
    """O, dQ, dK and dV of the autograd Function (K16, then K18 and K19
    from the LSE and δ) against ``jax.vjp`` of the JAX
    ``block_sparse_attention`` (its custom_vjp's Pallas dq/dkv kernels)."""
    S = 96
    _, pcfg = _configs(name, kw)
    layout = pcfg.make_layout(S)
    q, k, v, do = _qkv(S, seed=7)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_bs.block_sparse_attention(a, b, c, layout, BLOCK),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))
    qkv = [x.requires_grad_() for x in _t(q, k, v)]
    out = bs.block_sparse_attention(*qkv, layout, BLOCK)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    for g, g_j in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **GRAD_TOL)


def test_seq_len_off_the_block_grid():
    """S = 88 with block 16 (a partial last block of 8 keys and rows) and
    a per-head layout: padding in the reference, masking in the port."""
    S, nb = 88, 6
    rng = np.random.default_rng(11)
    layout = rng.random((H, nb, nb)) < 0.5
    layout[:, np.arange(nb), np.arange(nb)] = True
    q, k, v, do = _qkv(S, seed=12)
    out_j, vjp = jax.vjp(
        lambda a, b, c: jax_bs.block_sparse_attention(a, b, c, layout, BLOCK),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))
    qkv = [x.requires_grad_() for x in _t(q, k, v)]
    out = bs.block_sparse_attention(*qkv, layout, BLOCK)
    assert tuple(out.shape) == (B, H, S, HD)
    grads = torch.autograd.grad(out, qkv, torch.from_numpy(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **FWD_TOL)
    for g, g_j in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(g_j), **GRAD_TOL)


def test_rows_with_no_active_block_emit_zeros():
    """An empty q-block row gives O = 0 and LSE = -1e30 (the JAX test of
    the same name), and no gradient reaches its queries or flows from it;
    a key block no row attends gets dK = dV = 0."""
    S = 48
    layout = np.zeros((1, 3, 3), bool)
    layout[0, 0, 0] = layout[0, 2, 0] = layout[0, 2, 1] = True  # row 1 empty
    q, k, v, do = _qkv(S, seed=5)
    tables = bs.prepare_layout(layout, BLOCK, H, "cpu")
    o, lse = bs.block_sparse_fwd(*_t(q, k, v), tables)
    assert torch.all(o[:, :, 16:32] == 0) and torch.any(o[:, :, :16] != 0)
    assert torch.all(lse[:, :, 16:32] == -1e30)
    out_j = jax_bs.block_sparse_attention(*map(jnp.asarray, (q, k, v)),
                                          layout, BLOCK)
    np.testing.assert_allclose(o.numpy(), np.asarray(out_j), **FWD_TOL)
    qkv = [x.requires_grad_() for x in _t(q, k, v)]
    grads = torch.autograd.grad(bs.block_sparse_attention(*qkv, layout,
                                                          BLOCK),
                                qkv, torch.from_numpy(do))
    assert torch.all(grads[0][:, :, 16:32] == 0)
    assert torch.all(grads[1][:, :, 32:] == 0)
    assert torch.all(grads[2][:, :, 32:] == 0)


def test_no_grad_call_takes_the_no_lse_forward(monkeypatch):
    """Under ``torch.no_grad()``, or with no input requiring grad, the
    forward is K17's (no LSE); with a gradient to take it is K16's."""
    calls = []

    def spy(name):
        real = getattr(bs, name)

        def wrapped(*args, **kwargs):
            calls.append(name)
            return real(*args, **kwargs)
        return wrapped

    for name in ("block_sparse_fwd", "block_sparse_fwd_nolse"):
        monkeypatch.setattr(bs, name, spy(name))
    _, pcfg = _configs(*LAYOUTS[0])
    attn = port_ssa.SparseSelfAttention(pcfg)
    q, k, v = _t(*_qkv(64, seed=1, n=3))
    attn(q, k, v, use_kernel=True)
    assert calls == ["block_sparse_fwd_nolse"]
    qg = q.clone().requires_grad_()
    with torch.no_grad():
        attn(qg, k, v, use_kernel=True)
    assert calls == ["block_sparse_fwd_nolse"] * 2
    attn(qg, k, v, use_kernel=True).sum().backward()
    assert calls[-1] == "block_sparse_fwd" and qg.grad is not None


def test_layout_and_input_checks():
    q = torch.zeros(B, H, 64, HD)
    with pytest.raises(ValueError, match="layout heads 3"):
        bs.block_sparse_attention(q, q, q, np.ones((3, 4, 4), bool), BLOCK)
    with pytest.raises(ValueError, match="does not cover"):
        bs.block_sparse_attention(q, q, q, np.ones((3, 3), bool), BLOCK)
    # a device with no kernel and no plain route raises, never falls back
    meta = torch.empty(B, H, 64, 64, device="meta")
    tables = bs.prepare_layout(np.ones((4, 4), bool), BLOCK, H, "meta")
    with pytest.raises(ValueError, match="runs on CUDA or CPU"):
        bs.block_sparse_fwd(meta, meta, meta, tables)


# --------------------------------------------------------------------- #
# SparseSelfAttention: the kernel path and the masked-dense path
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name,kw", LAYOUTS[:2], ids=[n for n, _ in
                                                      LAYOUTS[:2]])
def test_kernel_path_matches_masked_dense(name, kw):
    jcfg, pcfg = _configs(name, kw)
    q, k, v = _qkv(128, seed=2, n=3)
    attn = port_ssa.SparseSelfAttention(pcfg)
    out = attn(*_t(q, k, v), use_kernel=True)
    dense = attn(*_t(q, k, v))
    dense_j = jax_ssa.SparseSelfAttention(jcfg)(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(dense.numpy(), np.asarray(dense_j), **FWD_TOL)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), **FWD_TOL)


@pytest.mark.parametrize("kpm_mode,mask_mode", [("add", "mul"), ("mul", "add"),
                                                ("add", "add"),
                                                ("mul", "mul")])
def test_dense_path_extras_match_jax(kpm_mode, mask_mode):
    """rpe, key_padding_mask and attn_mask in each mode, on the
    masked-dense path, against the JAX dense path."""
    S = 64
    jcfg, pcfg = _configs(*LAYOUTS[1])
    rng = np.random.default_rng(9)
    q, k, v = _qkv(S, seed=4, n=3)
    rpe = rng.normal(size=(H, S, S)).astype(np.float32)
    if kpm_mode == "add":
        kpm = np.where(rng.random((B, S)) < 0.2, -1e4, 0.0).astype(np.float32)
    else:
        kpm = (rng.random((B, S)) > 0.2).astype(np.float32)
    if mask_mode == "mul":
        am = rng.uniform(0.5, 1.5, size=(S, S)).astype(np.float32)
    else:
        am = rng.normal(size=(S, S)).astype(np.float32)
    kw = dict(key_padding_mask_mode=kpm_mode, attn_mask_mode=mask_mode)
    ref = jax_ssa.SparseSelfAttention(jcfg, **kw)(
        *map(jnp.asarray, (q, k, v)), rpe=jnp.asarray(rpe),
        key_padding_mask=jnp.asarray(kpm), attn_mask=jnp.asarray(am))
    out = port_ssa.BertSparseSelfAttention(pcfg, **kw)(
        *_t(q, k, v), rpe=torch.from_numpy(rpe),
        key_padding_mask=torch.from_numpy(kpm), attn_mask=torch.from_numpy(am))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_kernel_path_refuses_the_extras():
    _, pcfg = _configs(*LAYOUTS[0])
    q = torch.zeros(B, H, 64, HD)
    with pytest.raises(ValueError, match="plain layout only"):
        port_ssa.SparseSelfAttention(pcfg)(q, q, q, rpe=torch.zeros(64, 64),
                                           use_kernel=True)


def test_bigbird_draws_match_python_random():
    """BigBird's random blocks come from ``random.Random(seed)``: the
    port's layout changes with the seed exactly as the JAX one does."""
    for seed in (0, 1, random.Random(5).randrange(1000)):
        jcfg, pcfg = _configs("BigBirdSparsityConfig",
                              dict(num_random_blocks=3, seed=seed), heads=3,
                              different_layout_per_head=True)
        assert np.array_equal(pcfg.make_layout(256),
                              np.asarray(jcfg.make_layout(256)))


# --------------------------------------------------------------------- #
# head dims off 64/128: the CUDA path's zero-pad-and-slice
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("hd", [16, 80, 96])
def test_padded_head_dim_matches_unpadded_and_pallas(hd):
    """``bs.run_padded`` (what the CUDA path calls: q, k, v, dO zero-padded
    to 64 or 128, the scale from the true hd, O/dQ/dK/dV sliced back)
    around the plain K16-K19, against the unpadded plain versions and the
    JAX ``_bs_fwd`` at that hd (forward 2e-5, gradients 1e-4)."""
    S = 96
    _, pcfg = _configs(*LAYOUTS[0])
    layout = pcfg.make_layout(S)
    rng = np.random.default_rng(hd)
    q, k, v, do = (rng.normal(size=(B, H, S, hd)).astype(np.float32)
                   for _ in range(4))
    t = _t(q, k, v, do)
    tables = bs.prepare_layout(layout, BLOCK, H, "cpu")
    scale = 1.0 / np.sqrt(hd)
    o, lse = bs.run_padded(bs.block_sparse_fwd_reference, t[:3], 1, tables,
                           scale)
    o_u, lse_u = bs.block_sparse_fwd_reference(*t[:3], tables, scale)
    np.testing.assert_allclose(o.numpy(), o_u.numpy(), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_u.numpy(), **FWD_TOL)
    o_j, lse_j = _jax_fwd(q, k, v, layout, want_lse=True)
    np.testing.assert_allclose(o.numpy(), o_j, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **FWD_TOL)
    delta = (t[3] * o).sum(-1)
    dq = bs.run_padded(bs.block_sparse_bwd_dq_reference, t, 1, lse, delta,
                       tables, scale)
    dk, dv = bs.run_padded(bs.block_sparse_bwd_dkv_reference, t, 2, lse,
                           delta, tables, scale)
    ref_q = bs.block_sparse_bwd_dq_reference(*t, lse, delta, tables, scale)
    ref_k, ref_v = bs.block_sparse_bwd_dkv_reference(*t, lse, delta, tables,
                                                     scale)
    for got, ref in ((dq, ref_q), (dk, ref_k), (dv, ref_v)):
        assert got.shape == (B, H, S, hd)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **GRAD_TOL)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_bs.block_sparse_attention(a, b, c, layout, BLOCK),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


@pytest.mark.parametrize("hd", [160, 256])
def test_wide_head_dim_matches_pallas(hd):
    """Head dims above 128 run (no refusal): ``bs.run_padded`` (q, k, v, dO
    zero-padded to 256, the scale from the true hd, O/dQ/dK/dV sliced
    back) around the plain K16-K19 against the JAX ``_bs_fwd`` (O, LSE)
    and ``jax.vjp`` of the JAX ``block_sparse_attention`` (the Pallas
    kernels in interpret mode) at that hd (forward 2e-5, gradients 1e-4),
    S off the block grid, a per-head layout with an emptied row; hd 257
    raises."""
    S = 88
    _, pcfg = _configs(*LAYOUTS[1], different_layout_per_head=True)
    layout = pcfg.make_layout(96)
    layout[:, 2] = False
    rng = np.random.default_rng(hd)
    q, k, v, do = (rng.normal(size=(B, H, S, hd)).astype(np.float32)
                   for _ in range(4))
    t = _t(q, k, v, do)
    tables = bs.prepare_layout(layout, BLOCK, H, "cpu")
    scale = 1.0 / np.sqrt(hd)
    o, lse = bs.run_padded(bs.block_sparse_fwd_reference, t[:3], 1, tables,
                           scale)
    assert o.shape == (B, H, S, hd)
    assert bool((o[:, :, 32:48] == 0).all())
    assert bool((lse[:, :, 32:48] == -1e30).all())
    o_j, lse_j = _jax_fwd(q, k, v, layout, want_lse=True)
    np.testing.assert_allclose(o.numpy(), o_j, **FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), lse_j, **FWD_TOL)
    o2 = bs.run_padded(lambda *a: bs.block_sparse_fwd_reference(*a)[0],
                       t[:3], 1, tables, scale)
    o2_j, _ = _jax_fwd(q, k, v, layout, want_lse=False)
    np.testing.assert_allclose(o2.numpy(), o2_j, **FWD_TOL)
    delta = (t[3] * o).sum(-1)
    dq = bs.run_padded(bs.block_sparse_bwd_dq_reference, t, 1, lse, delta,
                       tables, scale)
    dk, dv = bs.run_padded(bs.block_sparse_bwd_dkv_reference, t, 2, lse,
                           delta, tables, scale)
    _, vjp = jax.vjp(
        lambda a, b, c: jax_bs.block_sparse_attention(a, b, c, layout, BLOCK),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, ref in zip((dq, dk, dv), vjp(jnp.asarray(do))):
        assert got.shape == (B, H, S, hd)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)
    wide = torch.zeros(B, H, S, 257)
    with pytest.raises(ValueError, match="head_dim <= 256"):
        bs.run_padded(bs.block_sparse_fwd_reference, (wide,) * 3, 1, tables,
                      scale)


# --------------------------------------------------------------------- #
# K19's bf16 walk at blocks 64 and 128 (csrc/block_sparse_attention_bwd.cu)
# --------------------------------------------------------------------- #
DKV_KEYS = DKV_WALK = 64     # keys a CTA owns, query rows of a walked tile


def _emulate_dkv(q, k, v, do, lse, delta, tables, scale, rounding):
    """dK, dV as the bf16 kernel walks them: a CTA owns 64 keys of one
    (batch, head) and walks its k-block's transposed-layout list, block /
    64 query tiles of 64 rows an entry; warpgroup g takes the tiles n with
    n % 2 == g and sums them tile after tile in float32; the two sums are
    folded at the end, dK = dK_0 + dK_1 (the same for dV). Rows past S
    read as zeros (TMA's fill), and so do their lse and delta (cp.async's);
    only the tail tile masks queries at or past S (every other tile is
    asserted to need no mask). With ``rounding`` P^T and dS^T are rounded
    to bf16 before the second products, and each output once. The order
    in which CTAs run changes no sum."""
    B, H, S, hd = q.shape
    blk = tables.block
    per = blk // DKV_WALK
    rnd = (lambda x: x.bfloat16().float()) if rounding else (lambda x: x)
    rows = tables.nq * blk + DKV_WALK

    def pad(x):
        return torch.cat([x, x.new_zeros((rows - S,) + tuple(x.shape[1:]))])

    dk = torch.zeros(B, H, S, hd)
    dv = torch.zeros_like(dk)
    LH = tables.num_layout_heads
    rp, cols = tables.row_ptr_t.numpy(), tables.cols_t.numpy()
    for b in range(B):
        for h in range(H):
            qb, kb, vb, dob = (pad(x[b, h].float()) for x in (q, k, v, do))
            lb, db = pad(lse[b, h]), pad(delta[b, h])
            lh = 0 if LH == 1 else h
            for kt in range(tables.nk * per):
                k0 = kt * DKV_KEYS
                if k0 >= S:
                    continue
                row = lh * tables.nk + k0 // blk
                entries = cols[rp[row]:rp[row + 1]]
                tiles = [c * blk + DKV_WALK * i for c in entries
                         for i in range(per)]
                sums = []
                for g in (0, 1):
                    acc_k = torch.zeros(DKV_KEYS, hd)
                    acc_v = torch.zeros(DKV_KEYS, hd)
                    for q0 in tiles[g::2]:
                        qs = torch.arange(q0, q0 + DKV_WALK)
                        mask = (qs < S)[None].expand(DKV_KEYS, -1)
                        edge = q0 + DKV_WALK > S
                        if not edge:
                            assert mask.all()
                        st = kb[k0:k0 + DKV_KEYS] @ qb[q0:q0 + DKV_WALK].T
                        dpt = vb[k0:k0 + DKV_KEYS] @ dob[q0:q0 + DKV_WALK].T
                        lt = lb[q0:q0 + DKV_WALK][None]
                        dt = db[q0:q0 + DKV_WALK][None]
                        ok = mask if edge else torch.ones_like(mask)
                        p = torch.where(ok, torch.exp(st * scale - lt), 0.0)
                        ds = torch.where(ok, p * (dpt - dt) * scale, 0.0)
                        acc_v += rnd(p) @ dob[q0:q0 + DKV_WALK]
                        acc_k += rnd(ds) @ qb[q0:q0 + DKV_WALK]
                    sums.append((acc_k, acc_v))
                keys = slice(k0, min(k0 + DKV_KEYS, S))
                n = keys.stop - k0
                dk[b, h, keys] = (sums[0][0] + sums[1][0])[:n]
                dv[b, h, keys] = (sums[0][1] + sums[1][1])[:n]
    return rnd(dk), rnd(dv)


# (block, hd, layout, per-head, S off the grid, an emptied row)
DKV_CASES = [
    (64, 64, 0, False, False, False),
    (64, 128, 0, True, True, False),
    (64, 64, 1, False, True, True),
    (64, 128, 1, True, False, False),
    (128, 64, 0, False, True, True),
    (128, 128, 1, False, False, False),
    (128, 64, 2, True, True, False),
    (64, 64, 3, False, True, False),
]
_JAX_DKV = {}


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("case", DKV_CASES,
                         ids=[f"blk{c[0]}-hd{c[1]}-{LAYOUTS[c[2]][0][:-14]}"
                              f"{'-per_head' if c[3] else ''}"
                              f"{'-off_grid' if c[4] else ''}"
                              f"{'-empty_row' if c[5] else ''}"
                              for c in DKV_CASES])
def test_bf16_dkv_walk_emulation(case, rounding):
    """K19's bf16 walk on the CPU (``_emulate_dkv``) against the JAX
    ``_bs_dkv_kernel`` in interpret mode (dK, dV of ``jax.vjp`` of the JAX
    ``block_sparse_attention``): within 2e-5 (abs and rel) without
    rounding; with P^T and dS^T rounded to bf16 and inputs rounded to
    bf16 values, within the limit ``chip_smoke.py`` holds the card's K19
    to (``FLASH_BF16_TERMS`` of the terms' magnitudes on top of two
    output ulps). B 1, H 2; Fixed, BigBird, BSLongformer and Variable
    layouts, shared and per head, S on and off the block grid, an emptied
    q-block row (a k-block whose list loses an entry)."""
    import chip_smoke

    blk, hd, li, per_head, off, empty = case
    name, kw = LAYOUTS[li]
    nb = 6 if blk == 64 else 4
    S = nb * blk - (5 if off else 0)
    Hh = 2
    cfg = getattr(port_sc, name)(num_heads=Hh, block=blk,
                                 different_layout_per_head=per_head, **kw)
    layout = cfg.make_layout(nb * blk)
    if empty:
        layout[:, 1] = False
    key = case
    rng = np.random.default_rng(3000 + 7 * li + blk + hd + S)
    q, k, v, do = (rng.normal(size=(1, Hh, S, hd)).astype(np.float32)
                   for _ in range(4))
    q, k, v, do = (torch.from_numpy(x).bfloat16().float().numpy()
                   for x in (q, k, v, do))
    if key not in _JAX_DKV:
        _, vjp = jax.vjp(lambda a, b, c: jax_bs.block_sparse_attention(
            a, b, c, layout, blk), *map(jnp.asarray, (q, k, v)))
        _JAX_DKV[key] = [np.asarray(g) for g in vjp(jnp.asarray(do))[1:]]
    want = _JAX_DKV[key]
    tables = bs.prepare_layout(layout, blk, Hh, "cpu")
    tq, tk, tv, tdo = _t(q, k, v, do)
    scale = 1.0 / np.sqrt(hd)
    o, lse = bs.block_sparse_fwd_reference(tq, tk, tv, tables, scale)
    delta = (tdo * o).sum(-1)
    got = _emulate_dkv(tq, tk, tv, tdo, lse, delta, tables, scale, rounding)
    if not rounding:
        for g_, w_ in zip(got, want):
            np.testing.assert_allclose(g_.numpy(), w_, atol=2e-5, rtol=2e-5)
        return
    _, _, dsq, pdo = chip_smoke.sparse_terms(torch, bs, tq, tk, tv, tdo, lse,
                                             delta, tables, scale)
    for nm, g_, w_, t_ in zip(("dK", "dV"), got, want, (dsq, pdo)):
        w_ = torch.from_numpy(np.array(w_))
        limit = (chip_smoke.BF16_ATOL + chip_smoke.BF16_RTOL * w_.abs()
                 + chip_smoke.FLASH_BF16_TERMS * t_)
        worst = float(((g_ - w_).abs() / limit).max())
        assert worst <= 1.0, f"{nm}: {worst:.3f}x chip_smoke's limit"



# --------------------------------------------------------------------- #
# K16/K17's and K18's bf16 walks at blocks 64 and 128
# (csrc/block_sparse_attention_fwd.cu, csrc/block_sparse_attention_bwd.cu)
# --------------------------------------------------------------------- #
ROWS = 64                    # query rows a CTA owns = keys of a walked tile
LOG2E = np.float32(np.log2(np.e))
MASKED2 = np.float32(-1e30) * LOG2E        # the kernels' masked score


def _walk(tables, S, h):
    """For each CTA of head ``h``: (its first query row q0, the first keys
    of the 64-key tiles its q-block's list names: block / 64 an entry)."""
    blk = tables.block
    per = blk // ROWS
    lh = 0 if tables.num_layout_heads == 1 else h
    rp, cols = tables.row_ptr.numpy(), tables.cols.numpy()
    for q0 in range(0, S, ROWS):
        row = lh * tables.nq + q0 // blk
        yield q0, [c * blk + ROWS * i for c in cols[rp[row]:rp[row + 1]]
                   for i in range(per)]


def _padded(x, S):
    """[S, ...] → rows up to S + the widest walk past S, zeros (TMA's fill
    of rows past S)."""
    return torch.cat([x, x.new_zeros((4 * 128,) + tuple(x.shape[1:]))])


def _emulate_fwd(q, k, v, tables, scale, rounding):
    """O and the LSE as the bf16 forward walks them: a CTA owns 64 query
    rows of one (batch, head); warpgroup g takes the tiles n of its
    q-block's list with n % 2 == g and keeps its own online softmax in
    base 2 (the running max m2 of s·scale·log2 e, the sum l, O), the mask
    (keys at or past S at −1e30·log2 e) on the tail tile only (every other
    tile asserted to need none); the two states are merged once at the
    end: m = max(m0, m1), O = (O0·2^(m0−m) + O1·2^(m1−m)) / (l0·2^(m0−m) +
    l1·2^(m1−m)), LSE = (m + log2 l)·ln 2, or −1e30 when l = 0 (an empty
    list). With ``rounding`` P is rounded to bf16 before P·V, and O
    once."""
    B, H, S, hd = q.shape
    rnd = (lambda x: x.bfloat16().float()) if rounding else (lambda x: x)
    c = torch.tensor(scale, dtype=torch.float32) * LOG2E
    o = torch.zeros(B, H, S, hd)
    lse = torch.zeros(B, H, S)
    for b in range(B):
        for h in range(H):
            qb, kb, vb = (_padded(x[b, h].float(), S) for x in (q, k, v))
            for q0, tiles in _walk(tables, S, h):
                states = []
                for g in (0, 1):
                    m2 = torch.full((ROWS,), float(MASKED2))
                    l = torch.zeros(ROWS)
                    acc = torch.zeros(ROWS, hd)
                    for k0 in tiles[g::2]:
                        keys = torch.arange(k0, k0 + ROWS)
                        edge = k0 + ROWS > S
                        if not edge:
                            assert bool((keys < S).all())
                        s2 = (qb[q0:q0 + ROWS] @ kb[k0:k0 + ROWS].T) * c
                        if edge:
                            s2 = torch.where(keys[None] < S, s2,
                                             torch.tensor(MASKED2))
                        mx = torch.maximum(m2, s2.amax(1))
                        alpha = torch.exp2(m2 - mx)
                        m2 = mx
                        p = torch.exp2(s2 - m2[:, None])
                        l = alpha * l + p.sum(1)
                        acc = acc * alpha[:, None] + rnd(p) @ vb[k0:k0 + ROWS]
                    states.append((m2, l, acc))
                (m0, l0, o0), (m1, l1, o1) = states
                m = torch.maximum(m0, m1)
                a0, a1 = torch.exp2(m0 - m), torch.exp2(m1 - m)
                lsum = l0 * a0 + l1 * a1
                out = (o0 * a0[:, None] + o1 * a1[:, None]) / torch.where(
                    lsum == 0, 1.0, lsum)[:, None]
                n = min(ROWS, S - q0)
                o[b, h, q0:q0 + n] = out[:n]
                lse[b, h, q0:q0 + n] = torch.where(
                    lsum == 0, torch.tensor(-1e30),
                    (m + torch.log2(lsum)) * np.float32(np.log(2)))[:n]
    return rnd(o), lse


def _emulate_dq(q, k, v, do, lse, delta, tables, scale, rounding):
    """dQ as the bf16 K18 kernel walks it: a CTA owns 64 query rows of one
    (batch, head) with their lse and delta (0 past S; Q and dO rows past S
    read as zeros); warpgroup g takes the tiles n of its q-block's list with
    n % 2 == g and sums dS·K tile after tile in float32, keys at or past S
    masked on the tail tile only (every other tile asserted to need none);
    the two sums are folded at the end, dQ = dQ_0 + dQ_1. With
    ``rounding`` dS is rounded to bf16 before dS·K, and dQ once."""
    B, H, S, hd = q.shape
    rnd = (lambda x: x.bfloat16().float()) if rounding else (lambda x: x)
    dq = torch.zeros(B, H, S, hd)
    for b in range(B):
        for h in range(H):
            qb, kb, vb, dob = (_padded(x[b, h].float(), S)
                               for x in (q, k, v, do))
            lb, db = _padded(lse[b, h], S), _padded(delta[b, h], S)
            for q0, tiles in _walk(tables, S, h):
                rows = slice(q0, q0 + ROWS)
                sums = []
                for g in (0, 1):
                    acc = torch.zeros(ROWS, hd)
                    for k0 in tiles[g::2]:
                        keys = torch.arange(k0, k0 + ROWS)
                        edge = k0 + ROWS > S
                        if not edge:
                            assert bool((keys < S).all())
                        s = qb[rows] @ kb[k0:k0 + ROWS].T
                        dp = dob[rows] @ vb[k0:k0 + ROWS].T
                        p = torch.exp(s * scale - lb[rows, None])
                        ds = p * (dp - db[rows, None]) * scale
                        if edge:
                            ds = torch.where(keys[None] < S, ds, 0.0)
                        acc += rnd(ds) @ kb[k0:k0 + ROWS]
                    sums.append(acc)
                n = min(ROWS, S - q0)
                dq[b, h, q0:q0 + n] = (sums[0] + sums[1])[:n]
    return rnd(dq)


_JAX_WALK = {}


def _walk_case(case):
    """The inputs of one of DKV_CASES' batches (bf16 values in float32),
    its layout and tables, and the JAX kernels' O, LSE and dQ on them
    (``_bs_fwd`` and ``jax.vjp`` in interpret mode, cached per case)."""
    blk, hd, li, per_head, off, empty = case
    name, kw = LAYOUTS[li]
    nb = 6 if blk == 64 else 4
    S = nb * blk - (5 if off else 0)
    Hh = 2
    cfg = getattr(port_sc, name)(num_heads=Hh, block=blk,
                                 different_layout_per_head=per_head, **kw)
    layout = cfg.make_layout(nb * blk)
    if empty:
        layout[:, 1] = False
    rng = np.random.default_rng(4000 + 7 * li + blk + hd + S)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(1, Hh, S, hd)).astype(
        np.float32)).bfloat16().float().numpy() for _ in range(4))
    if case not in _JAX_WALK:
        o_j, lse_j = _jax_fwd(q, k, v, layout, want_lse=True, block=blk)
        _, vjp = jax.vjp(lambda a, b, c: jax_bs.block_sparse_attention(
            a, b, c, layout, blk), *map(jnp.asarray, (q, k, v)))
        _JAX_WALK[case] = (o_j.copy(), lse_j.copy(),
                           np.array(vjp(jnp.asarray(do))[0]))
    tables = bs.prepare_layout(layout, blk, Hh, "cpu")
    return _t(q, k, v, do), tables, _JAX_WALK[case]


def _chip_limit(ref, terms):
    """``chip_smoke.py``'s limit for the card's bf16 kernels: two output
    ulps (``BF16_RTOL``) and ``FLASH_BF16_TERMS`` of the terms' magnitudes
    on top of ``BF16_ATOL``."""
    import chip_smoke

    return (chip_smoke.BF16_ATOL + chip_smoke.BF16_RTOL * ref.abs()
            + chip_smoke.FLASH_BF16_TERMS * terms)


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("case", DKV_CASES,
                         ids=[f"blk{c[0]}-hd{c[1]}-{LAYOUTS[c[2]][0][:-14]}"
                              f"{'-per_head' if c[3] else ''}"
                              f"{'-off_grid' if c[4] else ''}"
                              f"{'-empty_row' if c[5] else ''}"
                              for c in DKV_CASES])
def test_bf16_fwd_walk_emulation(case, rounding):
    """K16's bf16 walk on the CPU (``_emulate_fwd``: alternate tiles per
    warpgroup, two online softmax states merged once in a fixed order)
    against the JAX ``_bs_kernel`` in interpret mode: without rounding O
    and the LSE within 2e-5 (abs and rel) of it and of the plain version;
    with P rounded to bf16, O within the limit ``chip_smoke.py`` holds the
    card's K16 to (``FLASH_BF16_TERMS`` of |P|@|V| on top of two output
    ulps) and the LSE within 1e-4 + 1e-5·|ref|. An emptied row must give O
    = 0 and LSE = -1e30 exactly. B 1, H 2; DKV_CASES' layouts, blocks,
    head dims and edges."""
    import chip_smoke

    (q, k, v, do), tables, (o_j, lse_j, _) = _walk_case(case)
    scale = 1.0 / np.sqrt(q.shape[-1])
    o, lse = _emulate_fwd(q, k, v, tables, scale, rounding)
    o_j, lse_j = torch.from_numpy(o_j), torch.from_numpy(lse_j)
    if case[5]:                                        # the emptied row
        rows = slice(case[0], 2 * case[0])
        assert bool((o[:, :, rows] == 0).all())
        assert bool((lse[:, :, rows] == -1e30).all())
    if not rounding:
        o_p, lse_p = bs.block_sparse_fwd_reference(q, k, v, tables, scale)
        for want_o, want_l in ((o_j, lse_j), (o_p, lse_p)):
            np.testing.assert_allclose(o.numpy(), want_o.numpy(), atol=2e-5,
                                       rtol=2e-5)
            np.testing.assert_allclose(lse.numpy(), want_l.numpy(),
                                       atol=2e-5, rtol=2e-5)
        return
    delta = (do * o_j).sum(-1)
    pv, _, _, _ = chip_smoke.sparse_terms(torch, bs, q, k, v, do, lse_j,
                                          delta, tables, scale)
    worst = float(((o - o_j).abs() / _chip_limit(o_j, pv)).max())
    assert worst <= 1.0, f"O: {worst:.3f}x chip_smoke's limit"
    assert bool(((lse - lse_j).abs() <= 1e-4 + 1e-5 * lse_j.abs()).all())


@pytest.mark.parametrize("rounding", [False, True])
@pytest.mark.parametrize("case", DKV_CASES,
                         ids=[f"blk{c[0]}-hd{c[1]}-{LAYOUTS[c[2]][0][:-14]}"
                              f"{'-per_head' if c[3] else ''}"
                              f"{'-off_grid' if c[4] else ''}"
                              f"{'-empty_row' if c[5] else ''}"
                              for c in DKV_CASES])
def test_bf16_dq_walk_emulation(case, rounding):
    """K18's bf16 walk on the CPU (``_emulate_dq``: alternate tiles per
    warpgroup, the fixed-order fold dQ = dQ_0 + dQ_1) against dQ of
    ``jax.vjp`` of the JAX ``block_sparse_attention`` (its
    ``_bs_dq_kernel`` in interpret mode), from the JAX forward's LSE:
    within 2e-5 (abs and rel) of it and of the plain version without
    rounding; with dS rounded to bf16, within the limit ``chip_smoke.py``
    holds the card's K18 to (``FLASH_BF16_TERMS`` of |dS|@|K| on top of
    two output ulps). An emptied row must give dQ = 0. B 1, H 2."""
    import chip_smoke

    (q, k, v, do), tables, (o_j, lse_j, dq_j) = _walk_case(case)
    scale = 1.0 / np.sqrt(q.shape[-1])
    lse = torch.from_numpy(lse_j)
    delta = (do * torch.from_numpy(o_j)).sum(-1)
    dq = _emulate_dq(q, k, v, do, lse, delta, tables, scale, rounding)
    dq_j = torch.from_numpy(dq_j)
    if case[5]:
        assert bool((dq[:, :, case[0]:2 * case[0]] == 0).all())
    if not rounding:
        dq_p = bs.block_sparse_bwd_dq_reference(q, k, v, do, lse, delta,
                                                tables, scale)
        for want in (dq_j, dq_p):
            np.testing.assert_allclose(dq.numpy(), want.numpy(), atol=2e-5,
                                       rtol=2e-5)
        return
    _, dsk, _, _ = chip_smoke.sparse_terms(torch, bs, q, k, v, do, lse, delta,
                                           tables, scale)
    worst = float(((dq - dq_j).abs() / _chip_limit(dq_j, dsk)).max())
    assert worst <= 1.0, f"dQ: {worst:.3f}x chip_smoke's limit"

"""The port's paged-attention wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode.

Inputs come from ``numpy.random.default_rng`` and feed both packages; all
comparisons are in float32. Tolerance 2e-5 (abs and rel): both sides
accumulate the same float32 softmax over at most a few dozen keys, in a
different summation order (online softmax in chunks on the JAX side, one
dense softmax on the port side), which moves the result by a few ulps.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2.kernels import ragged_ops as jax_ops
from deepspeed_tpu_torch.inference.v2.kernels import ragged_ops as port_ops

pytestmark = pytest.mark.torch_port

TOL = dict(atol=2e-5, rtol=2e-5)


def _pages_and_tables(rng, S, KV, hd, ps, NB):
    np_tot = S * NB + 1                      # + shared trash page
    pages = rng.normal(size=(np_tot, ps, 2 * KV, hd)).astype(np.float32)
    perm = rng.permutation(np_tot - 1)       # distinct pages, never trash
    pt = np.stack([perm[s * NB:(s + 1) * NB] for s in range(S)]).astype(
        np.int32)
    return pages, pt


def _ragged_case(rng, q_lens, ctx_lens, KV, G, hd, ps, NB, pad_tokens=0):
    S = len(q_lens)
    T = int(sum(q_lens)) + pad_tokens
    q = rng.normal(size=(T, KV * G, hd)).astype(np.float32)
    pages, pt = _pages_and_tables(rng, S, KV, hd, ps, NB)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    return q, pages, np.asarray(ctx_lens, np.int32), pt, cu


def _jax_ragged(q, pages, kvl, pt, cu, KV):
    return np.asarray(jax_ops.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(kvl), jnp.asarray(pt),
        jnp.asarray(cu), num_kv_heads=KV, block_q=8, pages_per_chunk=2,
        interpret=True))


def _port_ragged(q, pages, kvl, pt, cu, KV):
    return port_ops.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(pages), torch.from_numpy(kvl),
        torch.from_numpy(pt), torch.from_numpy(cu), num_kv_heads=KV).numpy()


class TestRaggedPagedAttention:
    @pytest.mark.parametrize("G", [1, 2])
    def test_mixed_prefill_and_decode_rows(self, G):
        """Prefill rows, single-token decode rows, contexts crossing page
        boundaries (ps = 8), and trailing padding rows (which give 0)."""
        rng = np.random.default_rng(10 + G)
        KV, hd, ps, NB = 2, 16, 8, 5
        q_lens, ctx_lens = [5, 1, 12, 1], [9, 20, 12, 33]
        q, pages, kvl, pt, cu = _ragged_case(rng, q_lens, ctx_lens, KV, G, hd,
                                             ps, NB, pad_tokens=3)
        ref = _jax_ragged(q, pages, kvl, pt, cu, KV)
        out = _port_ragged(q, pages, kvl, pt, cu, KV)
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_array_equal(out[-3:], 0.0)

    def test_context_ends_on_page_edge(self):
        """ctx % page_size == 0: the walk's last page is full."""
        rng = np.random.default_rng(12)
        KV, G, hd, ps, NB = 2, 2, 16, 8, 4
        q_lens, ctx_lens = [8, 1, 3], [16, 24, 8]
        q, pages, kvl, pt, cu = _ragged_case(rng, q_lens, ctx_lens, KV, G, hd,
                                             ps, NB)
        np.testing.assert_allclose(_port_ragged(q, pages, kvl, pt, cu, KV),
                                   _jax_ragged(q, pages, kvl, pt, cu, KV),
                                   **TOL)

    def test_interior_zero_query_row_is_skipped(self):
        """cu_q_lens = [0, 2, 2, 4]: the empty row hides nothing after it."""
        rng = np.random.default_rng(13)
        KV, G, hd, ps, NB = 2, 2, 16, 8, 4
        q, pages, kvl, pt, cu = _ragged_case(rng, [2, 0, 2], [2, 0, 17], KV,
                                             G, hd, ps, NB)
        np.testing.assert_allclose(_port_ragged(q, pages, kvl, pt, cu, KV),
                                   _jax_ragged(q, pages, kvl, pt, cu, KV),
                                   **TOL)

    def test_nan_page_stays_in_its_sequence(self):
        """A NaN-poisoned sequence cannot reach its batchmates: their rows
        stay finite and equal to the unpoisoned run (and to JAX's)."""
        rng = np.random.default_rng(14)
        KV, G, hd, ps, NB = 2, 2, 16, 8, 4
        q_lens, ctx_lens = [3, 4, 1], [11, 4, 20]
        q, pages, kvl, pt, cu = _ragged_case(rng, q_lens, ctx_lens, KV, G, hd,
                                             ps, NB)
        clean = _port_ragged(q, pages, kvl, pt, cu, KV)
        poisoned = pages.copy()
        poisoned[pt[1]] = np.nan                     # all of sequence 1's pages
        out = _port_ragged(q, poisoned, kvl, pt, cu, KV)
        ref = _jax_ragged(q, poisoned, kvl, pt, cu, KV)
        mates = np.r_[0:3, 7:8]                      # rows of sequences 0, 2
        assert np.isfinite(out[mates]).all()
        np.testing.assert_array_equal(out[mates], clean[mates])
        np.testing.assert_allclose(out[mates], ref[mates], **TOL)
        assert np.isnan(out[3:7]).all()


def _decode_case(rng, ctx_lens, KV, G, hd, ps, NB):
    S = len(ctx_lens)
    q = rng.normal(size=(S, KV * G, hd)).astype(np.float32)
    pages, pt = _pages_and_tables(rng, S, KV, hd, ps, NB)
    return q, pages, np.asarray(ctx_lens, np.int32), pt


def _port_decode(q, pages, kvl, pt, KV):
    return port_ops.decode_paged_attention(
        torch.from_numpy(q), torch.from_numpy(pages), torch.from_numpy(kvl),
        torch.from_numpy(pt), num_kv_heads=KV).numpy()


class TestDecodePagedAttention:
    @pytest.mark.parametrize("G", [1, 2])
    def test_matches_pallas_kernel_and_dense(self, G):
        """Contexts crossing page boundaries, one ending on a page edge and
        kv_lens == 0 padding rows (which give 0)."""
        rng = np.random.default_rng(20 + G)
        KV, hd, ps, NB = 2, 16, 8, 6
        ctx = [44, 0, 17, 16, 1, 0]
        q, pages, kvl, pt = _decode_case(rng, ctx, KV, G, hd, ps, NB)
        args = (jnp.asarray(q), jnp.asarray(pages), jnp.asarray(kvl),
                jnp.asarray(pt))
        ref_kernel = np.asarray(jax_ops.decode_paged_attention(
            *args, num_kv_heads=KV, pages_per_chunk=2, interpret=True))
        ref_dense = np.asarray(jax_ops.decode_attend_dense(
            *args, num_kv_heads=KV))
        out = _port_decode(q, pages, kvl, pt, KV)
        np.testing.assert_allclose(out, ref_kernel, **TOL)
        np.testing.assert_allclose(out, ref_dense, **TOL)
        np.testing.assert_array_equal(out[[1, 5]], 0.0)

    def test_nan_page_stays_in_its_sequence(self):
        """Poisoning one sequence's pages (and a padding row's page) leaves
        every other row finite and unchanged."""
        rng = np.random.default_rng(23)
        KV, G, hd, ps, NB = 2, 2, 16, 8, 4
        ctx = [9, 30, 0, 5]
        q, pages, kvl, pt = _decode_case(rng, ctx, KV, G, hd, ps, NB)
        clean = _port_decode(q, pages, kvl, pt, KV)
        poisoned = pages.copy()
        poisoned[pt[1]] = np.nan
        poisoned[pt[2, 0]] = np.nan                  # the padding row's page
        out = _port_decode(q, poisoned, kvl, pt, KV)
        assert np.isfinite(out[[0, 2, 3]]).all()
        np.testing.assert_array_equal(out[[0, 2, 3]], clean[[0, 2, 3]])
        assert np.isnan(out[1]).all()


#: context positions a split of the CUDA K7's first pass covers (``kSplit``
#: in ``csrc/decode_paged_attention.cu``), for the emulation below
K7_SPLIT = 64


def _split_merge_emulation(q, pages, kvl, pt, KV, split=K7_SPLIT):
    """A plain float32 emulation of the CUDA K7's two passes, for these
    tests only: the context cut into fixed splits of ``split``
    positions, each split's K/V rows gathered position by position through
    the page table, its scores, max, sum and unnormalised P.V; then a
    sequence's splits merged in split order (m* = max m_i, weights
    exp(m_i - m*), one division at the end). Empty splits are never formed;
    kv_lens == 0 rows give 0."""
    q, pages = torch.as_tensor(q), torch.as_tensor(pages)
    pt = torch.as_tensor(pt).long()
    S, H, hd = q.shape
    ps = pages.shape[1]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    out = torch.zeros(S, H, hd)
    for s in range(S):
        L = min(int(kvl[s]), pt.shape[1] * ps)
        states = []
        for base in range(0, L, split):
            pos = torch.arange(base, min(base + split, L))
            rows = pages[pt[s, pos // ps], pos % ps]          # [n, 2KV, hd]
            k = rows[:, :KV].repeat_interleave(G, dim=1)
            v = rows[:, KV:].repeat_interleave(G, dim=1)
            scores = torch.einsum("hd,nhd->hn", q[s], k) * scale
            m = scores.max(dim=-1).values
            p = torch.exp(scores - m[:, None])
            states.append((m, p.sum(-1), torch.einsum("hn,nhd->hd", p, v)))
        if not states:
            continue
        m_star = torch.stack([m for m, _, _ in states]).max(dim=0).values
        l, acc = torch.zeros(H), torch.zeros(H, hd)
        for m, l_i, acc_i in states:
            a = torch.exp(m - m_star)
            l = l + a * l_i
            acc = acc + a[:, None] * acc_i
        out[s] = acc / l[:, None]
    return out.numpy()


def _paged_from_rows(rng, rows, ps):
    """The logical context rows ``[S, C, 2KV, hd]`` (C a multiple of ps)
    scattered into a pool of ``ps``-row pages under a random page table."""
    S, C = rows.shape[:2]
    NB = C // ps
    perm = rng.permutation(S * NB)
    pt = perm.reshape(S, NB).astype(np.int32)
    pages = rng.normal(size=(S * NB + 1,) + (ps,) + rows.shape[2:]).astype(
        np.float32)
    for s in range(S):
        pages[pt[s]] = rows[s].reshape(NB, ps, *rows.shape[2:])
    return pages, pt


SPLIT_EDGE_LENS = (0, 1, K7_SPLIT - 1, K7_SPLIT, K7_SPLIT + 1)


class TestSplitContextDecode:
    """The CUDA K7 splits the context into fixed runs of K7_SPLIT
    positions and merges the splits' softmax states (flash-decoding). Its
    arithmetic, emulated in float32, against the dense plain version and
    the Pallas kernel (interpret mode) within 2e-5: the two sides sum the
    same float32 terms over <= 256 keys in another order."""

    @pytest.mark.parametrize("hd", [64, 128])
    @pytest.mark.parametrize("G", [1, 4, 8])
    @pytest.mark.parametrize("ps", [16, 64, 128])
    def test_split_edges_match_dense_and_pallas(self, ps, G, hd):
        """kv_lens 0, 1, split - 1, split, split + 1 and the table's whole
        width NB * ps, which ends on a split and a page edge."""
        rng = np.random.default_rng(50 + ps + G + hd)
        KV, C = 2, 256
        ctx = list(SPLIT_EDGE_LENS) + [C]
        q, pages, kvl, pt = _decode_case(rng, ctx, KV, G, hd, ps, C // ps)
        emu = _split_merge_emulation(q, pages, kvl, pt, KV)
        dense = _port_decode(q, pages, kvl, pt, KV)
        pallas = np.asarray(jax_ops.decode_paged_attention(
            jnp.asarray(q), jnp.asarray(pages), jnp.asarray(kvl),
            jnp.asarray(pt), num_kv_heads=KV, interpret=True))
        np.testing.assert_allclose(emu, dense, **TOL)
        np.testing.assert_allclose(emu, pallas, **TOL)
        np.testing.assert_array_equal(emu[0], 0.0)

    @pytest.mark.parametrize("G,hd", [(4, 128), (8, 64)])
    def test_bit_equal_across_page_sizes(self, G, hd):
        """The same q and the same K/V rows at the same positions, paged at
        64 and at 128: the split boundaries and every sum's order depend on
        positions alone, so the outputs are equal bit for bit. This holds
        the emulation only, which gathers rows by position and so cannot
        show a page-size fault; the CUDA kernel's bit-identity across page
        sizes is checked on the card by ``chip_smoke.py``
        (``phase_decode_split_checks``)."""
        rng = np.random.default_rng(60 + G)
        KV, C = 2, 512
        rows = rng.normal(size=(6, C, 2 * KV, hd)).astype(np.float32)
        q = rng.normal(size=(6, KV * G, hd)).astype(np.float32)
        kvl = np.asarray([1, 63, 64, 65, 300, C], np.int32)
        outs = []
        for ps in (64, 128):
            pages, pt = _paged_from_rows(rng, rows, ps)
            outs.append(_split_merge_emulation(q, pages, kvl, pt, KV))
        np.testing.assert_array_equal(outs[0], outs[1])
        pages, pt = _paged_from_rows(rng, rows, 64)
        np.testing.assert_allclose(outs[0], _port_decode(q, pages, kvl, pt,
                                                         KV), **TOL)

    def test_nan_page_stays_in_its_sequence(self):
        """A NaN page of one sequence reaches none of the other rows, nor
        any split of theirs; the poisoned row is NaN."""
        rng = np.random.default_rng(70)
        KV, G, hd, ps, C = 2, 4, 64, 16, 256
        ctx = [65, C, 0, 64]
        q, pages, kvl, pt = _decode_case(rng, ctx, KV, G, hd, ps, C // ps)
        clean = _split_merge_emulation(q, pages, kvl, pt, KV)
        poisoned = pages.copy()
        poisoned[pt[1, 9]] = np.nan                  # one page of sequence 1
        poisoned[pt[2, 0]] = np.nan                  # the padding row's page
        out = _split_merge_emulation(q, poisoned, kvl, pt, KV)
        mates = [0, 2, 3]
        np.testing.assert_array_equal(out[mates], clean[mates])
        np.testing.assert_allclose(out[mates], _port_decode(
            q, poisoned, kvl, pt, KV)[mates], **TOL)
        assert np.isnan(out[1]).all()


class TestWrapperChecks:
    def test_cpu_path_launches_nothing(self):
        rng = np.random.default_rng(30)
        before = (port_ops.ragged_paged_attention.launches,
                  port_ops.decode_paged_attention.launches)
        q, pages, kvl, pt, cu = _ragged_case(rng, [2], [2], 1, 1, 16, 4, 1)
        _port_ragged(q, pages, kvl, pt, cu, 1)
        _port_decode(q[:1], pages, kvl, pt, 1)
        assert (port_ops.ragged_paged_attention.launches,
                port_ops.decode_paged_attention.launches) == before

    def test_inconsistent_shapes_raise(self):
        q = torch.zeros(4, 4, 16)
        pages = torch.zeros(3, 4, 4, 16)
        with pytest.raises(ValueError, match="combined-head"):
            port_ops.decode_paged_attention(
                q, pages, torch.zeros(4, dtype=torch.int32),
                torch.zeros(4, 1, dtype=torch.int32), num_kv_heads=1)
        with pytest.raises(ValueError, match="cu_q_lens"):
            port_ops.ragged_paged_attention(
                q, pages, torch.zeros(2, dtype=torch.int32),
                torch.zeros(2, 1, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int32), num_kv_heads=2)

    def test_decode_needs_one_query_row_per_sequence(self):
        rng = np.random.default_rng(31)
        q, pages, kvl, pt = _decode_case(rng, [7, 12], 1, 4, 16, 4, 4)
        with pytest.raises(ValueError, match="3 rows for 2 sequences"):
            port_ops.decode_paged_attention(
                torch.from_numpy(np.concatenate([q, q[:1]])),
                torch.from_numpy(pages), torch.from_numpy(kvl),
                torch.from_numpy(pt), num_kv_heads=1)


def test_paged_kv_append_matches_jax():
    """The in-place index_put_ equals the JAX scatter, padded tokens to the
    trash page included."""
    rng = np.random.default_rng(40)
    KV, hd, ps, NP = 2, 16, 4, 7
    pages = rng.normal(size=(NP, ps, 2 * KV, hd)).astype(np.float32)
    T = 6
    k = rng.normal(size=(T, KV, hd)).astype(np.float32)
    v = rng.normal(size=(T, KV, hd)).astype(np.float32)
    page_of = np.array([0, 0, 3, 5, NP - 1, NP - 1], np.int32)
    off_of = np.array([1, 2, 0, 3, 0, 0], np.int32)
    ref = np.asarray(jax_ops.paged_kv_append(
        jnp.asarray(pages), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(page_of), jnp.asarray(off_of)))
    pool = torch.from_numpy(pages.copy())
    ret = port_ops.paged_kv_append(pool, torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(page_of),
                                   torch.from_numpy(off_of))
    assert ret is pool
    real = slice(0, NP - 1)          # the trash page's content is unspecified
    np.testing.assert_array_equal(pool.numpy()[real], ref[real])


# --------------------------------------------------------------------- #
# ALiBi (both forms), head dims off 64/128, wide query groups
# --------------------------------------------------------------------- #
def _alibi_for(H, seed):
    """Standard slopes scaled up so that the bias moves the softmax at
    these short contexts (Bloom's slopes at H heads times 3)."""
    return (port_ops.alibi_slopes(H).numpy() * (1.0 + seed % 3)).astype(
        np.float32)


def _jax_ragged_alibi(q, pages, kvl, pt, cu, KV, alibi, scaled):
    return np.asarray(jax_ops.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(pages), jnp.asarray(kvl), jnp.asarray(pt),
        jnp.asarray(cu), num_kv_heads=KV, alibi=alibi, alibi_scaled=scaled,
        block_q=8, pages_per_chunk=2, interpret=True))


def _port_ragged_alibi(q, pages, kvl, pt, cu, KV, alibi, scaled):
    return port_ops.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(pages), torch.from_numpy(kvl),
        torch.from_numpy(pt), torch.from_numpy(cu), num_kv_heads=KV,
        alibi=alibi, alibi_scaled=scaled).numpy()


#: (G, hd) pairs of the ALiBi cases: MHA at hd 16, GQA 4 at hd 80, a group
#: of 16 at hd 128
ALIBI_SHAPES = [(1, 16), (4, 80), (16, 128)]


class TestAlibi:
    """ALiBi in the plain K6 and K7 against the Pallas kernels in interpret
    mode within 2e-5 (the same float32 softmax terms in another order; the
    biases and the fused ``dot·scale + bias`` computed alike, Falcon's
    bf16(k_pos) included), and Bloom's against the JAX
    ``decode_attend_dense``. kv_lens run past 256, where k_pos is no longer
    exact in bf16. Falcon's form is not held against an eager call of
    ``decode_attend_dense``: eager, JAX rounds bf16(slope)·bf16(k_pos) to
    bf16 once more, which jitted XLA (the Pallas kernels and the JAX
    engine) does not."""

    @pytest.mark.parametrize("scaled", [False, True])
    @pytest.mark.parametrize("G,hd", ALIBI_SHAPES)
    def test_ragged_matches_pallas(self, G, hd, scaled):
        rng = np.random.default_rng(80 + G + hd)
        KV, ps, NB = 2, 32, 12
        q_lens, ctx_lens = [3, 1, 0, 6, 1], [300, 290, 0, 261, 17]
        q, pages, kvl, pt, cu = _ragged_case(rng, q_lens, ctx_lens, KV, G,
                                             hd, ps, NB, pad_tokens=2)
        alibi = _alibi_for(KV * G, G)
        ref = _jax_ragged_alibi(q, pages, kvl, pt, cu, KV, alibi, scaled)
        out = _port_ragged_alibi(q, pages, kvl, pt, cu, KV, alibi, scaled)
        np.testing.assert_allclose(out, ref, **TOL)
        np.testing.assert_array_equal(out[-2:], 0.0)
        plain = _port_ragged_alibi(q, pages, kvl, pt, cu, KV, None, False)
        assert np.abs(out - plain).max() > 1e-2      # the bias moved it

    @pytest.mark.parametrize("scaled", [False, True])
    @pytest.mark.parametrize("G,hd", ALIBI_SHAPES)
    def test_decode_matches_pallas_and_dense(self, G, hd, scaled):
        rng = np.random.default_rng(90 + G + hd)
        KV, ps, NB = 2, 32, 12
        ctx = [300, 0, 257, 383, 1]
        q, pages, kvl, pt = _decode_case(rng, ctx, KV, G, hd, ps, NB)
        alibi = _alibi_for(KV * G, G + 1)
        ref = np.asarray(jax_ops.decode_paged_attention(
            jnp.asarray(q), jnp.asarray(pages), jnp.asarray(kvl),
            jnp.asarray(pt), num_kv_heads=KV, alibi=alibi,
            alibi_scaled=scaled, pages_per_chunk=2, interpret=True))
        out = port_ops.decode_paged_attention(
            torch.from_numpy(q), torch.from_numpy(pages),
            torch.from_numpy(kvl), torch.from_numpy(pt), num_kv_heads=KV,
            alibi=alibi, alibi_scaled=scaled).numpy()
        np.testing.assert_allclose(out, ref, **TOL)
        if not scaled:
            dense = np.asarray(jax_ops.decode_attend_dense(
                jnp.asarray(q), jnp.asarray(pages), jnp.asarray(kvl),
                jnp.asarray(pt), num_kv_heads=KV, alibi=alibi))
            np.testing.assert_allclose(out, dense, **TOL)
        np.testing.assert_array_equal(out[1], 0.0)

    def test_slopes_are_the_reference_ones(self):
        from deepspeed_tpu.models.families import alibi_slopes as jax_slopes

        for H in (1, 3, 8, 12, 16, 71):
            np.testing.assert_array_equal(port_ops.alibi_slopes(H).numpy(),
                                          jax_slopes(H))

    def test_slope_count_must_match_heads(self):
        rng = np.random.default_rng(95)
        q, pages, kvl, pt = _decode_case(rng, [7, 12], 1, 4, 16, 4, 4)
        args = [torch.from_numpy(a) for a in (q, pages, kvl, pt)]
        with pytest.raises(ValueError, match="per query head"):
            port_ops.decode_paged_attention(*args, num_kv_heads=1,
                                            alibi=[0.5, 0.25])
        cu = torch.tensor([0, 1, 2], dtype=torch.int32)
        with pytest.raises(ValueError, match="per query head"):
            port_ops.ragged_paged_attention(*args, cu, num_kv_heads=1,
                                            alibi=[0.5] * 5)

    def test_falcon_bias_rounds_k_pos_in_bf16(self):
        """Past 256, bf16(k_pos) steps by 2, rounding half to even: Falcon's
        bias is slope·bf16(k_pos), Bloom's slope·k_pos."""
        slopes = torch.tensor([0.5])
        pos = torch.arange(256, 264)
        falcon = port_ops.alibi_bias(slopes, pos, 1.0, True)[0]
        bloom = port_ops.alibi_bias(slopes, pos, 1.0, False)[0]
        assert falcon.tolist() == [0.5 * p for p in (256, 256, 258, 260, 260,
                                                     260, 262, 264)]
        assert bloom.tolist() == [0.5 * p for p in range(256, 264)]


def test_padded_head_dim_and_copy_width():
    assert [port_ops.padded_head_dim(h) for h in (1, 16, 64, 65, 80, 128,
                                                  129, 256)] == [
        64, 64, 64, 128, 128, 128, 256, 256]
    with pytest.raises(ValueError, match="Queue 3"):
        port_ops.padded_head_dim(257)
    t = torch.zeros(64, dtype=torch.bfloat16)
    assert port_ops.copy_width(128, 2, t) == 16
    assert port_ops.copy_width(20, 2, t) == 8
    assert port_ops.copy_width(6, 2, t) == 4
    assert port_ops.copy_width(7, 2, t) == 2
    assert port_ops.copy_width(8, 2, t[1:]) == 2
    assert port_ops.copy_width(5, 4, torch.zeros(8)) == 4


# --------------------------------------------------------------------- #
# The CUDA K6 bf16 kernel's walk, emulated in float32
# --------------------------------------------------------------------- #
#: rows a tile of the CUDA K6 (``kRows`` in csrc/ragged_paged_attention.cu)
K6_ROWS = 64
#: warp groups walking alternate chunks of a tile (``kGroups``)
K6_GROUPS = 2
LOG2E = np.float32(1.4426950408889634)


def _k6_geometry(G):
    """(n_gs, GS, BQ): group slices, heads a slice, tokens a tile."""
    n_gs = -(-G // K6_ROWS)
    GS = -(-G // n_gs)
    return n_gs, GS, K6_ROWS // GS


def _merge_states(states):
    """Softmax states (m, l, acc) merged in order: m* = max m_i, each
    weighed by 2^(m_i - m*)."""
    m_star = torch.stack([st[0] for st in states]).max(dim=0).values
    l, acc = torch.zeros_like(states[0][1]), 0.0
    for m_i, l_i, acc_i in states:
        f = torch.exp2(m_i - m_star)
        l = l + f * l_i
        acc = acc + f[:, None] * acc_i
    return m_star, l, acc


def _k6_walk_emulation(q, pages, kvl, pt, cu, KV, alibi=None,
                       scaled=False):
    """A plain float32 emulation of the CUDA K6 bf16 kernel's walk, for
    these tests only (its bf16 rounding of P left out): tiles of up to 64
    rows (BQ tokens x GS heads of a group slice, a group wider than 64 cut
    into slices), context chunks of 64 positions (32 at a padded head width
    of 256) gathered through the page table, K6_GROUPS warp groups taking
    alternate chunks, scores in base 2 (the scale and log2 e folded in, the
    ALiBi bias added to s * scale first), the causal mask only on chunks
    that reach past the tile's first row, masked entries weighing exactly
    0; the groups' states merged in group order (m* = max m_i, 2^(m_i -
    m*) weights), one division at the end."""
    q, pages = torch.as_tensor(q), torch.as_tensor(pages)
    pt, cu, kvl = (torch.as_tensor(pt).long(), np.asarray(cu),
                   np.asarray(kvl))
    T, H, hd = q.shape
    G = H // KV
    ps = pages.shape[1]
    scale = np.float32(1.0 / np.sqrt(hd))
    KC = 32 if port_ops.padded_head_dim(hd) == 256 else 64
    n_gs, GS, BQ = _k6_geometry(G)
    slopes = None if alibi is None else torch.as_tensor(alibi).float()
    neg = torch.tensor(-1e30)

    def walk(qt, s, h, heads, qpos, q_pos0, chunks):
        R = qt.shape[0]
        m = torch.full((R,), -1e30)
        l, acc = torch.zeros(R), torch.zeros(R, hd)
        for base, end in chunks:
            pos = torch.arange(base, end)
            rows = pages[pt[s, pos // ps], pos % ps]
            x = qt @ rows[:, h].T
            if slopes is None:
                x = x * (scale * LOG2E)
            else:
                b = port_ops.alibi_bias(slopes[heads], pos, float(scale),
                                        scaled)
                x = port_ops.biased_scores(x, float(scale), b) * LOG2E
            if base + KC - 1 > q_pos0:
                x = torch.where(pos[None, :] > qpos, neg, x)
            m_new = torch.maximum(m, x.max(dim=1).values)
            alpha = torch.exp2(m - m_new)
            p = torch.where(x == neg, 0.0, torch.exp2(x - m_new[:, None]))
            l = l * alpha + p.sum(dim=1)
            acc = acc * alpha[:, None] + p @ rows[:, KV + h]
            m = m_new
        return m, l, acc

    out = torch.zeros(T, H, hd)
    for s in range(len(kvl)):
        q0, q1, L = int(cu[s]), int(cu[s + 1]), int(kvl[s])
        n = q1 - q0
        for tb in range(-(-n // BQ) if n > 0 else 0):
            for gi in range(n_gs):
                t0, g0 = q0 + tb * BQ, gi * GS
                t1, g1 = min(t0 + BQ, q1), min(gi * GS + GS, G)
                q_pos0 = L - n + (t0 - q0)
                eff = max(0, min(L, L - n + (t1 - q0)))
                toks = torch.arange(t0, t1).repeat_interleave(g1 - g0)
                gs = torch.arange(g0, g1).repeat(t1 - t0)
                qpos = (L - n + (toks - q0))[:, None]
                for h in range(KV):
                    heads = h * G + gs
                    qt = q[toks, heads]                          # [R, hd]
                    if eff == 0:
                        continue
                    chunks = [(b, min(b + KC, eff))
                              for b in range(0, eff, KC)]
                    _, l, acc = _merge_states([
                        walk(qt, s, h, heads, qpos, q_pos0,
                             chunks[g::K6_GROUPS])
                        for g in range(K6_GROUPS)])
                    out[toks, heads] = torch.where(
                        l[:, None] == 0, 0.0,
                        acc / torch.where(l == 0, 1.0, l)[:, None])
    return out.numpy()


class TestRaggedTileWalk:
    """The CUDA K6's tile walk (group slices, the two warp groups'
    alternate chunks), emulated in float32, against the plain version and
    the Pallas kernel (interpret mode) within 2e-5: the same float32 terms
    in another order."""

    @pytest.mark.parametrize("ps", [16, 32, 64])
    @pytest.mark.parametrize("G,hd", [(1, 16), (4, 128), (16, 80),
                                      (71, 16)])
    def test_walk_matches_plain_and_pallas(self, G, hd, ps):
        """Pages of 16, 32 and 64 rows: a chunk's positions gathered from
        one page or several."""
        rng = np.random.default_rng(100 + G + hd + ps)
        KV = 1 if G == 71 else 2
        NB = 384 // ps
        q_lens = [5, 1, 0, 12, 1, 0]
        ctx_lens = [9, 300, 0, 140, 64, 0]
        q, pages, kvl, pt, cu = _ragged_case(rng, q_lens, ctx_lens, KV, G,
                                             hd, ps, NB, pad_tokens=3)
        emu = _k6_walk_emulation(q, pages, kvl, pt, cu, KV)
        np.testing.assert_allclose(emu, _port_ragged(q, pages, kvl, pt, cu,
                                                     KV), **TOL)
        if ps == 16:
            np.testing.assert_allclose(emu, _jax_ragged(q, pages, kvl, pt,
                                                        cu, KV), **TOL)
        np.testing.assert_array_equal(emu[-3:], 0.0)

    @pytest.mark.parametrize("scaled", [False, True])
    def test_alibi_walk_at_hd_256(self, scaled):
        """hd 256 (32-position chunks), ALiBi past 256 positions: equal to
        the plain version and Pallas."""
        rng = np.random.default_rng(110 + scaled)
        KV, G, hd, ps, NB = 2, 2, 256, 32, 12
        q_lens, ctx_lens = [4, 1, 2], [290, 377, 2]
        q, pages, kvl, pt, cu = _ragged_case(rng, q_lens, ctx_lens, KV, G,
                                             hd, ps, NB)
        alibi = _alibi_for(KV * G, 2)
        emu = _k6_walk_emulation(q, pages, kvl, pt, cu, KV, alibi, scaled)
        np.testing.assert_allclose(emu, _port_ragged_alibi(
            q, pages, kvl, pt, cu, KV, alibi, scaled), **TOL)
        np.testing.assert_allclose(emu, _jax_ragged_alibi(
            q, pages, kvl, pt, cu, KV, alibi, scaled), **TOL)

    def test_nan_page_stays_in_its_sequence(self):
        rng = np.random.default_rng(120)
        KV, G, hd, ps, NB = 2, 4, 64, 16, 24
        q_lens, ctx_lens = [3, 4, 1], [11, 200, 300]
        q, pages, kvl, pt, cu = _ragged_case(rng, q_lens, ctx_lens, KV, G,
                                             hd, ps, NB)
        clean = _k6_walk_emulation(q, pages, kvl, pt, cu, KV)
        poisoned = pages.copy()
        poisoned[pt[1, 3]] = np.nan              # one page of sequence 1
        out = _k6_walk_emulation(q, poisoned, kvl, pt, cu, KV)
        mates = np.r_[0:3, 7:8]
        np.testing.assert_array_equal(out[mates], clean[mates])
        assert np.isnan(out[3:7]).all()

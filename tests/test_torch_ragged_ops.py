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

"""Block-sparse attention for the PyTorch port (counterpart of
``deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py``).

Four kernels, written by hand in CUDA C++ for Hopper, replace the JAX
package's four Pallas kernels:

  * :func:`block_sparse_fwd` — ``csrc/block_sparse_attention_fwd.cu``,
    replacing ``_bs_kernel`` (O and the float32 row log-sum-exp, K16);
  * :func:`block_sparse_fwd_nolse` — the same source, replacing
    ``_bs_kernel_nolse`` (O alone, the inference primal, K17);
  * :func:`block_sparse_bwd_dq` — ``csrc/block_sparse_attention_bwd.cu``,
    replacing ``_bs_dq_kernel`` (K18);
  * :func:`block_sparse_bwd_dkv` — the same source, replacing
    ``_bs_dkv_kernel`` (dK, dV over the transposed layout, K19).

The TPU kernels walk a dense ``(B, H, nq, nk)`` grid and skip the DMA of
masked steps through a fetch table (:func:`build_fetch_table`, kept for
its test). The CUDA kernels instead walk lists of active blocks: for each
layout head and q-block row its active k-blocks (CSR: row offsets and
column indices), and the same lists for the transposed layout, which dK/dV
walks. :func:`prepare_layout` builds those lists once per layout content,
block and device (a layout whose heads are all equal is kept as one head)
and caches them, as the reference's ``_PREPARED_CACHE`` caches its holders.

:func:`block_sparse_attention` wires the kernels as the reference's
``custom_vjp`` on ``_bs_attn`` does: when no gradient will be taken
(``torch.is_grad_enabled()`` is false, or no input requires grad) it runs
the no-LSE forward; otherwise a ``torch.autograd.Function`` runs the
forward with the LSE and saves q, k, v, O and the LSE, and its backward
computes δ = rowsum(dO∘O) in float32 outside the kernels, then dQ and
dK/dV.

Semantics kept from the reference: keys at positions ≥ S are masked with
-1e30 (not -inf); a query row with no active block gives O = 0 and LSE =
-1e30, and the backward never touches it; there is no token-level causal
mask inside a block (``attention="unidirectional"`` is a block-level
lower triangle). Inputs are read at their length S: the kernels mask the
partial last block instead of padding copies of q, k and v.

The kernels are built for head dims 64, 128 and 256 (256 on the exact
tile kernels): any other hd up to 256 is zero-padded to the next of the
three (:func:`run_padded`, shared with flash attention), with the scale
from the true hd and O, dQ, dK and dV sliced back; hd above 256 raises.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version beside it (``*_reference``):
float32 math that loops over q-blocks (k-blocks for dK/dV) and gathers
only the active blocks, never an ``[S, S]`` tensor, with the backward's
recompute form taken from the LSE. Each wrapper counts its kernel
launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...accelerator import get_accelerator
from ..op_builder.builder import DTYPE_CODES, check_launch, kernel_function
from ..transformer.flash_attention import KERNEL_HEAD_DIMS, run_padded

_NEG_INF = -1e30
_KERNEL_BLOCKS = (16, 32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_P] * 7 + [_I] * 7 + [_F, _I, _P]
_FWD_NOLSE_ARGS = [_P] * 6 + [_I] * 7 + [_F, _I, _P]
_DQ_ARGS = [_P] * 9 + [_I] * 7 + [_F, _I, _P]
_DKV_ARGS = [_P] * 10 + [_I] * 7 + [_F, _I, _P]


def build_fetch_table(layout: np.ndarray) -> np.ndarray:
    """[H, nq, nk] layout → same-shape table of kv block indices to fetch at
    each grid step: the block itself when active, else the last active block
    of the row (no new DMA).  Rows with no active block fetch block 0.

    The TPU kernels' DMA schedule, kept as the reference computes it; the
    CUDA kernels walk :class:`BlockSparseTables` instead."""
    H, nq, nk = layout.shape
    table = np.zeros((H, nq, nk), np.int32)
    for h in range(H):
        for i in range(nq):
            row = np.nonzero(layout[h, i])[0]
            last = int(row[0]) if len(row) else 0
            for j in range(nk):
                if layout[h, i, j]:
                    last = j
                table[h, i, j] = last
    return table


def _csr(layout: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """[LH, n_rows, n_cols] bool → (row offsets [LH*n_rows + 1], column
    indices), int32; row ``lh*n_rows + i`` lists its active columns in
    ascending order."""
    rows = layout.reshape(-1, layout.shape[-1])
    row_ptr = np.zeros(rows.shape[0] + 1, np.int64)
    np.cumsum(rows.sum(axis=1), out=row_ptr[1:])
    return row_ptr.astype(np.int32), np.nonzero(rows)[1].astype(np.int32)


def _padded_rows(layout: np.ndarray, device) -> List[Tuple[torch.Tensor,
                                                           torch.Tensor]]:
    """For each row i of a [LH, n_rows, n_cols] layout: (indices [LH, A],
    valid [LH, A]) of its active columns, padded with column 0 (not valid)
    to the longest list A of the row over the layout heads; used by the
    plain versions to gather only active blocks."""
    LH, n_rows, _ = layout.shape
    out = []
    for i in range(n_rows):
        lists = [np.nonzero(layout[lh, i])[0] for lh in range(LH)]
        A = max(len(c) for c in lists)
        idx = np.zeros((LH, A), np.int64)
        valid = np.zeros((LH, A), bool)
        for lh, c in enumerate(lists):
            idx[lh, :len(c)] = c
            valid[lh, :len(c)] = True
        out.append((torch.from_numpy(idx).to(device),
                    torch.from_numpy(valid).to(device)))
    return out


class BlockSparseTables:
    """The active-block lists of one block layout, on one device.

    ``layout`` is the bool ``[LH, nq, nk]`` layout (LH is 1 when every
    head shares it); ``row_ptr``/``cols`` list each (layout head, q-block)
    row's active k-blocks and ``row_ptr_t``/``cols_t`` each (layout head,
    k-block) row's active q-blocks, as int32 tensors on ``device``."""

    def __init__(self, layout: np.ndarray, block: int, device):
        self.layout = layout
        self.block = int(block)
        self.num_layout_heads, self.nq, self.nk = layout.shape
        self.device = torch.device(device)
        layout_t = np.ascontiguousarray(layout.transpose(0, 2, 1))
        self._layout_t = layout_t
        to = lambda a: torch.from_numpy(a).to(self.device)
        row_ptr, cols = _csr(layout)
        row_ptr_t, cols_t = _csr(layout_t)
        self.row_ptr, self.cols = to(row_ptr), to(cols)
        self.row_ptr_t, self.cols_t = to(row_ptr_t), to(cols_t)
        self._rows = None

    def active_blocks(self, num_heads: int) -> int:
        """Active (q-block, k-block) pairs summed over ``num_heads`` heads."""
        n = int(self.layout.sum())
        return n * num_heads if self.num_layout_heads == 1 else n

    def density(self) -> float:
        return float(self.layout.mean())

    def padded_rows(self):
        """(q-block rows, k-block rows of the transposed layout) for the
        plain versions, built on first use."""
        if self._rows is None:
            self._rows = (_padded_rows(self.layout, self.device),
                          _padded_rows(self._layout_t, self.device))
        return self._rows


#: (layout shape, layout bytes, block, device) → BlockSparseTables
_TABLE_CACHE: Dict[tuple, BlockSparseTables] = {}


def prepare_layout(layout, block: int, num_heads: int,
                   device) -> BlockSparseTables:
    """The cached :class:`BlockSparseTables` of a 2-D ``[nq, nk]`` or
    ``[LH, nq, nk]`` layout for ``num_heads`` heads (LH is 1 or
    ``num_heads``; a layout whose heads are all equal is kept as one)."""
    layout = np.asarray(layout).astype(bool)
    if layout.ndim == 2:
        layout = layout[None]
    if layout.ndim != 3:
        raise ValueError(f"layout must be [nq, nk] or [heads, nq, nk], got "
                         f"shape {layout.shape}")
    if layout.shape[0] not in (1, num_heads):
        raise ValueError(f"layout heads {layout.shape[0]} != tensor heads "
                         f"{num_heads}")
    if layout.shape[0] > 1 and (layout == layout[:1]).all():
        layout = layout[:1]
    layout = np.ascontiguousarray(layout)
    device = torch.device(device)
    key = (layout.shape, layout.tobytes(), int(block), str(device))
    tables = _TABLE_CACHE.get(key)
    if tables is None:
        tables = BlockSparseTables(layout, block, device)
        _TABLE_CACHE[key] = tables
    return tables


def _check_layout(name, q, tables):
    B, H, S, _ = q.shape
    blk = tables.block
    if tables.nq * blk < S or tables.nk * blk < S:
        raise ValueError(f"{name}: a [{tables.nq}, {tables.nk}] layout of "
                         f"block {blk} does not cover S={S}")
    if tables.num_layout_heads not in (1, H):
        raise ValueError(f"{name}: layout heads {tables.num_layout_heads} "
                         f"!= tensor heads {H}")


def _check_kernel_inputs(name, tensors, tables, stats=()):
    """What the CUDA kernels take: contiguous, 16-byte aligned float32 or
    bfloat16 ``[B, H, S, hd]`` tensors of one dtype on one CUDA device with
    hd in ``KERNEL_HEAD_DIMS``, a block in {16, 32, 64, 128} and the
    layout's lists on
    that device; contiguous float32 ``[B, H, S]`` row statistics."""
    first = tensors[0]
    dev = first.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not {dev}")
    if first.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: float32 or bfloat16 inputs, not "
                         f"{first.dtype}")
    if first.dim() != 4 or first.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: the kernel takes [B, H, S, hd] with hd in "
                         f"{KERNEL_HEAD_DIMS}, got {tuple(first.shape)}")
    if tables.block not in _KERNEL_BLOCKS:
        raise ValueError(f"{name}: the kernel supports block in "
                         f"{_KERNEL_BLOCKS}, got {tables.block}")
    if tables.row_ptr.device != dev:
        raise ValueError(f"{name}: layout tables on {tables.row_ptr.device}, "
                         f"inputs on {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != first.dtype:
            raise ValueError(f"{name}: inputs must share device and dtype")
        if tuple(t.shape) != tuple(first.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(first.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             f"aligned")
    B, H, S, _ = first.shape
    for t in stats:
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (B, H, S) or not t.is_contiguous()):
            raise ValueError(f"{name}: lse/delta must be contiguous float32 "
                             f"[{B}, {H}, {S}] on {dev}")


def _stream(t: torch.Tensor) -> int:
    return get_accelerator().current_stream(t.device).cuda_stream


def _scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# --------------------------------------------------------------------- #
# Plain PyTorch versions (float32 math, active blocks only)
# --------------------------------------------------------------------- #
def _blocks(x, n, block):
    """[B, H, S, ...] float32, zero-padded to n*block rows, viewed as
    [B, H, n, block, ...]."""
    B, H, S = x.shape[:3]
    x = x.float()
    if n * block > S:
        pad = x.new_zeros((B, H, n * block - S) + tuple(x.shape[3:]))
        x = torch.cat([x, pad], dim=2)
    return x.view((B, H, n, block) + tuple(x.shape[3:]))


def _gather(xb, idx, H):
    """Blocks ``idx`` ([LH, A]) of every head from [B, H, n, block, ...]
    → [B, H, A, block, ...]."""
    heads = torch.arange(H, device=xb.device)[:, None]
    return xb[:, heads, idx.expand(H, -1)]


def _slot_mask(idx, valid, block, S, H):
    """[H, A*block]: valid list slots whose positions lie below S."""
    pos = idx[..., None] * block + torch.arange(block, device=idx.device)
    ok = valid[..., None] & (pos < S)
    return ok.expand(H, -1, -1).flatten(1), valid[..., None].expand(
        H, -1, block).flatten(1)


def block_sparse_fwd_reference(q, k, v, tables: BlockSparseTables,
                               scale: Optional[float] = None):
    """Plain version of :func:`block_sparse_fwd`: per q-block, the softmax
    over its active k-blocks in float32 (keys ≥ S at -1e30, a row with no
    active block O = 0 and LSE = -1e30) → (O in q's dtype, LSE
    ``[B, H, S]`` float32)."""
    _check_layout("block_sparse_fwd_reference", q, tables)
    scale = _scale(q, scale)
    B, H, S, hd = q.shape
    blk = tables.block
    out = q.new_zeros((B, H, S, hd), dtype=torch.float32)
    lse = q.new_full((B, H, S), _NEG_INF, dtype=torch.float32)
    kb, vb = _blocks(k, tables.nk, blk), _blocks(v, tables.nk, blk)
    rows, _ = tables.padded_rows()
    for i in range(-(-S // blk)):
        idx, valid = rows[i]
        if idx.shape[1] == 0:
            continue
        r0, r1 = i * blk, min(S, (i + 1) * blk)
        qi = q[:, :, r0:r1].float()
        kg, vg = _gather(kb, idx, H), _gather(vb, idx, H)
        s = torch.einsum("bhqd,bhakd->bhqak", qi, kg).flatten(-2) * scale
        key_ok, slot_ok = _slot_mask(idx, valid, blk, S, H)
        s = torch.where(key_ok[:, None], s, _NEG_INF)
        s = torch.where(slot_ok[:, None], s, -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(m == -math.inf, _NEG_INF, m)     # only padded slots
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        l = torch.where(l == 0.0, 1.0, l)
        out[:, :, r0:r1] = torch.einsum("bhqn,bhnd->bhqd", p / l,
                                        vg.flatten(2, 3))
        lse[:, :, r0:r1] = (m + torch.log(l)).squeeze(-1)
    return out.to(q.dtype), lse


def block_sparse_bwd_dq_reference(q, k, v, do, lse, delta,
                                  tables: BlockSparseTables,
                                  scale: Optional[float] = None):
    """Plain version of :func:`block_sparse_bwd_dq`: per q-block, P =
    exp(S·scale − LSE) over its active k-blocks (0 for keys ≥ S), dS =
    P∘(dO·Vᵀ − δ)·scale, dQ = dS·K."""
    _check_layout("block_sparse_bwd_dq_reference", q, tables)
    scale = _scale(q, scale)
    B, H, S, hd = q.shape
    blk = tables.block
    dq = q.new_zeros((B, H, S, hd), dtype=torch.float32)
    kb, vb = _blocks(k, tables.nk, blk), _blocks(v, tables.nk, blk)
    rows, _ = tables.padded_rows()
    for i in range(-(-S // blk)):
        idx, valid = rows[i]
        if idx.shape[1] == 0:
            continue
        r0, r1 = i * blk, min(S, (i + 1) * blk)
        kg = _gather(kb, idx, H).flatten(2, 3)
        vg = _gather(vb, idx, H).flatten(2, 3)
        s = torch.einsum("bhqd,bhnd->bhqn", q[:, :, r0:r1].float(), kg)
        key_ok, _ = _slot_mask(idx, valid, blk, S, H)
        p = torch.where(key_ok[:, None],
                        torch.exp(s * scale - lse[:, :, r0:r1, None]), 0.0)
        dp = torch.einsum("bhqd,bhnd->bhqn", do[:, :, r0:r1].float(), vg)
        ds = p * (dp - delta[:, :, r0:r1, None]) * scale
        dq[:, :, r0:r1] = torch.einsum("bhqn,bhnd->bhqd", ds, kg)
    return dq.to(q.dtype)


def block_sparse_bwd_dkv_reference(q, k, v, do, lse, delta,
                                   tables: BlockSparseTables,
                                   scale: Optional[float] = None):
    """Plain version of :func:`block_sparse_bwd_dkv`: per k-block, over the
    q-blocks of its transposed-layout row (query rows ≥ S add nothing), dV
    = Pᵀ·dO and dK = dSᵀ·Q."""
    _check_layout("block_sparse_bwd_dkv_reference", q, tables)
    scale = _scale(q, scale)
    B, H, S, hd = q.shape
    blk = tables.block
    dk = q.new_zeros((B, H, S, hd), dtype=torch.float32)
    dv = torch.zeros_like(dk)
    qb, dob = _blocks(q, tables.nq, blk), _blocks(do, tables.nq, blk)
    lseb = _blocks(lse[..., None], tables.nq, blk)[..., 0]
    deltab = _blocks(delta[..., None], tables.nq, blk)[..., 0]
    _, rows_t = tables.padded_rows()
    for j in range(-(-S // blk)):
        idx, valid = rows_t[j]
        if idx.shape[1] == 0:
            continue
        r0, r1 = j * blk, min(S, (j + 1) * blk)
        qg = _gather(qb, idx, H).flatten(2, 3)
        dog = _gather(dob, idx, H).flatten(2, 3)
        lseg = _gather(lseb, idx, H).flatten(2, 3)
        deltag = _gather(deltab, idx, H).flatten(2, 3)
        row_ok, _ = _slot_mask(idx, valid, blk, S, H)
        st = torch.einsum("bhkd,bhnd->bhkn", k[:, :, r0:r1].float(), qg)
        p = torch.where(row_ok[:, None],
                        torch.exp(st * scale - lseg[:, :, None]), 0.0)
        dpt = torch.einsum("bhkd,bhnd->bhkn", v[:, :, r0:r1].float(), dog)
        ds = p * (dpt - deltag[:, :, None]) * scale
        dv[:, :, r0:r1] = torch.einsum("bhkn,bhnd->bhkd", p, dog)
        dk[:, :, r0:r1] = torch.einsum("bhkn,bhnd->bhkd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------- #
# K16 / K17: forward
# --------------------------------------------------------------------- #
def block_sparse_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     tables: BlockSparseTables,
                     scale: Optional[float] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-sparse attention over ``[B, H, S, hd]`` q, k, v → (O
    ``[B, H, S, hd]``, LSE ``[B, H, S]`` float32).

    Replaces ``_bs_kernel``. On CUDA: ``csrc/block_sparse_attention_fwd.cu``.
    Bound on the H100: operations, 4·hd flops per (query, key) pair of an
    active block and head at 989 TFLOP/s in bf16."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return block_sparse_fwd_reference(q, k, v, tables, scale)
    return run_padded(_fwd_launch, (q, k, v), 1, tables, scale)


def _fwd_launch(q, k, v, tables, scale):
    _check_kernel_inputs("block_sparse_fwd", (q, k, v), tables)
    _check_layout("block_sparse_fwd", q, tables)
    B, H, S, hd = q.shape
    LH = tables.num_layout_heads
    o = torch.empty_like(q)
    lse = torch.empty(B, H, S, dtype=torch.float32, device=q.device)
    err = kernel_function("block_sparse_attention_fwd",
                          "block_sparse_fwd_launch", _FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), tables.row_ptr.data_ptr(), tables.cols.data_ptr(),
        B, S, H, hd, LH, tables.nq, tables.block, scale,
        DTYPE_CODES[q.dtype], _stream(q))
    check_launch("block_sparse_fwd", err)
    block_sparse_fwd.launches += 1
    return o, lse


block_sparse_fwd.launches = 0


def block_sparse_fwd_nolse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           tables: BlockSparseTables,
                           scale: Optional[float] = None) -> torch.Tensor:
    """O of :func:`block_sparse_fwd` without the LSE (the inference primal:
    the LSE is a write no caller reads when no gradient is taken).

    Replaces ``_bs_kernel_nolse``. On CUDA:
    ``csrc/block_sparse_attention_fwd.cu``. Bound: as K16."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return block_sparse_fwd_reference(q, k, v, tables, scale)[0]
    return run_padded(_fwd_nolse_launch, (q, k, v), 1, tables, scale)


def _fwd_nolse_launch(q, k, v, tables, scale):
    _check_kernel_inputs("block_sparse_fwd_nolse", (q, k, v), tables)
    _check_layout("block_sparse_fwd_nolse", q, tables)
    B, H, S, hd = q.shape
    LH = tables.num_layout_heads
    o = torch.empty_like(q)
    err = kernel_function("block_sparse_attention_fwd",
                          "block_sparse_fwd_nolse_launch", _FWD_NOLSE_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        tables.row_ptr.data_ptr(), tables.cols.data_ptr(), B, S, H, hd, LH,
        tables.nq, tables.block, scale, DTYPE_CODES[q.dtype], _stream(q))
    check_launch("block_sparse_fwd_nolse", err)
    block_sparse_fwd_nolse.launches += 1
    return o


block_sparse_fwd_nolse.launches = 0


# --------------------------------------------------------------------- #
# K18: dQ
# --------------------------------------------------------------------- #
def block_sparse_bwd_dq(q, k, v, do, lse, delta, tables: BlockSparseTables,
                        scale: Optional[float] = None) -> torch.Tensor:
    """dQ of :func:`block_sparse_fwd` from the saved LSE and δ.

    Replaces ``_bs_dq_kernel``. On CUDA: ``csrc/block_sparse_attention_bwd.cu``.
    Bound: operations, 6·hd flops per active pair and head."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return block_sparse_bwd_dq_reference(q, k, v, do, lse, delta, tables,
                                             scale)
    return run_padded(_dq_launch, (q, k, v, do), 1, lse, delta, tables,
                      scale)


def _dq_launch(q, k, v, do, lse, delta, tables, scale):
    _check_kernel_inputs("block_sparse_bwd_dq", (q, k, v, do), tables,
                         (lse, delta))
    _check_layout("block_sparse_bwd_dq", q, tables)
    B, H, S, hd = q.shape
    LH = tables.num_layout_heads
    dq = torch.empty_like(q)
    err = kernel_function("block_sparse_attention_bwd",
                          "block_sparse_bwd_dq_launch", _DQ_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        tables.row_ptr.data_ptr(), tables.cols.data_ptr(), B, S, H, hd, LH,
        tables.nq, tables.block, scale, DTYPE_CODES[q.dtype], _stream(q))
    check_launch("block_sparse_bwd_dq", err)
    block_sparse_bwd_dq.launches += 1
    return dq


block_sparse_bwd_dq.launches = 0


# --------------------------------------------------------------------- #
# K19: dK, dV
# --------------------------------------------------------------------- #
def block_sparse_bwd_dkv(q, k, v, do, lse, delta, tables: BlockSparseTables,
                         scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV) of :func:`block_sparse_fwd` from the saved LSE and δ,
    walking the transposed layout.

    Replaces ``_bs_dkv_kernel``. On CUDA:
    ``csrc/block_sparse_attention_bwd.cu`` (bf16 at blocks 64 and 128: TMA
    + wgmma, P^T and dS^T rounded to bf16 in registers; float32 and blocks
    16 and 32: the exact tile kernel). Bound: operations, 8·hd flops per
    active pair and head."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return block_sparse_bwd_dkv_reference(q, k, v, do, lse, delta, tables,
                                              scale)
    return run_padded(_dkv_launch, (q, k, v, do), 2, lse, delta, tables,
                      scale)


def _dkv_launch(q, k, v, do, lse, delta, tables, scale):
    _check_kernel_inputs("block_sparse_bwd_dkv", (q, k, v, do), tables,
                         (lse, delta))
    _check_layout("block_sparse_bwd_dkv", q, tables)
    B, H, S, hd = q.shape
    LH = tables.num_layout_heads
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = kernel_function("block_sparse_attention_bwd",
                          "block_sparse_bwd_dkv_launch", _DKV_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        tables.row_ptr_t.data_ptr(), tables.cols_t.data_ptr(), B, S, H, hd,
        LH, tables.nk, tables.block, scale, DTYPE_CODES[q.dtype], _stream(q))
    check_launch("block_sparse_bwd_dkv", err)
    block_sparse_bwd_dkv.launches += 1
    return dk, dv


block_sparse_bwd_dkv.launches = 0


# --------------------------------------------------------------------- #
# Public API
# --------------------------------------------------------------------- #
class _BlockSparseAttention(torch.autograd.Function):
    """The reference's ``_bs_attn`` custom VJP (forward rule and backward
    rule)."""

    @staticmethod
    def forward(ctx, q, k, v, tables, scale):
        o, lse = block_sparse_fwd(q, k, v, tables, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.scale = tables, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)            # [B, H, S]
        dq = block_sparse_bwd_dq(q, k, v, do, lse, delta, ctx.tables,
                                 ctx.scale)
        dk, dv = block_sparse_bwd_dkv(q, k, v, do, lse, delta, ctx.tables,
                                      ctx.scale)
        return dq, dk, dv, None, None


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           tables: BlockSparseTables,
           scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention over prepared tables: the no-LSE forward
    when no gradient will be taken, else the differentiable Function."""
    scale = _scale(q, scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _BlockSparseAttention.apply(q, k, v, tables, scale)
    return block_sparse_fwd_nolse(q, k, v, tables, scale)


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           layout, block: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse attention over ``[B, H, S, hd]`` with a ``[nq, nk]``
    or per-head ``[H, nq, nk]`` block layout (a single-head layout
    broadcasts to H; ``nq·block`` and ``nk·block`` must cover S; the
    output is ``[B, H, S, hd]``). Differentiable: the backward runs the dQ
    and dK/dV kernels over the same layout. The layout's active-block
    lists are built once per layout content, block and device."""
    tables = prepare_layout(layout, block, q.shape[1], q.device)
    return attend(q, k, v, tables, scale)

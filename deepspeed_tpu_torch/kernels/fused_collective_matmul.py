"""Fused compute + collective matmuls for the PyTorch port (counterpart of
``deepspeed_tpu/kernels/fused_collective_matmul.py``; T3, arXiv:2401.16677,
and EQuARX, arXiv:2506.17615).

Three kernels, written by hand in CUDA C++ for Hopper, replace the JAX
module's Pallas kernels:

  * :func:`shard_major_matmul` — K11 (``csrc/collective_matmul.cu``),
    replacing ``_matmul_kernel``: ``x @ w`` with float32 sums, its output
    tiles walked shard-major so that shard s's rows complete before shard
    s+1's start. It produces the operand of :func:`matmul_reduce_scatter`'s
    epilogue exchange and consumes :func:`all_gather_matmul`'s gathered
    weight on the full-precision edge;
  * :func:`_gathered_dequant_matmul` — K12 (``csrc/collective_matmul.cu``),
    replacing the kernel of ``_gathered_dequant_matmul``: ``x`` against n
    gathered int8/int4 weight shards, each unpacked and dequantized into
    shared memory and its k-slice's float32 product added to the running
    sum, the prologue of :func:`all_gather_matmul` on a quantized wire;
  * :func:`rmsnorm_matmul` — K4 (``csrc/rmsnorm_matmul.cu``), replacing
    ``_rmsnorm_matmul_kernel``: ``rms_norm(x, scale, eps) @ w`` with the
    normalised activations never written to device memory. Its backward
    is autograd of the reference composition
    (:func:`rmsnorm_matmul_reference`), as the JAX package's custom VJP
    is; the backward's products stay ``torch.matmul`` (cuBLAS), as the
    reference leaves them to XLA.

The collectives are the facade's (``deepspeed_tpu_torch.comm``) over the
world, the port's data axis, and the quantized edges ride the fused wire
(``runtime/comm/fused_wire.py``: K9a/K9b, K10b). The JAX ``impl`` seam is
not carried over: on a CUDA tensor a wrapper launches its kernel or
raises; on a CPU tensor it runs its plain version, which the CPU tests
hold against the JAX kernels in interpret mode. Each wrapper counts its
launches in ``<wrapper>.launches``. The plain float32 products run with
TF32 off (``torch.set_float32_matmul_precision("highest")`` while they
run), as the reference's float32 dots are.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from .. import comm
from ..accelerator import get_accelerator
from ..ops.op_builder.builder import DTYPE_CODES, check_launch, kernel_function
from ..ops.quantizer.quantizer import _ftz, _unpack_wire, quant_pack_wire
from ..runtime.comm.fused_wire import _exchange_mean, group_count, inv_n

_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
_P, _I = ctypes.c_void_p, ctypes.c_int
_LIB = "collective_matmul"
_MATMUL_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _P]
# x, wire, scales, out, M, N, k_shard, n_shards, groups, group_size, bits,
# stream
_GATHERED_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]


@contextlib.contextmanager
def _full_float32():
    """float32 products in full float32 (no TF32), and bfloat16 products
    summed in float32 throughout (no reduced-precision split-K reduction),
    while the block runs."""
    before = torch.get_float32_matmul_precision()
    flags = torch.backends.cuda.matmul
    reduced = flags.allow_bf16_reduced_precision_reduction
    torch.set_float32_matmul_precision("highest")
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)
        flags.allow_bf16_reduced_precision_reduction = reduced


def matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with float32 accumulation, output in the promoted input
    dtype (the JAX ``matmul_reference``); bfloat16 products go to
    ``torch.matmul``, which accumulates in float32, and float32 ones run
    without TF32."""
    out_dtype = torch.promote_types(x.dtype, w.dtype)
    with _full_float32():
        return torch.matmul(x.to(out_dtype), w.to(out_dtype))


def _largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= cap (the JAX kernel's tile
    sizes; the CUDA kernel masks its ragged tiles instead)."""
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def _check_cuda_operands(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: operands on {t.device} and {dev}")


# --------------------------------------------------------------------- #
# K11: the shard-major tiled matmul (the epilogue's producing kernel)
# --------------------------------------------------------------------- #
def shard_major_matmul(x: torch.Tensor, w: torch.Tensor, n_shards: int
                       ) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` → ``[M, N]`` in promote(x, w), float32 sums,
    its output tiles walked shard-major: shard s's rows
    ``[s·M/n, (s+1)·M/n)`` complete before any tile of shard s+1 starts,
    so the trailing reduce-scatter can take each shard as it completes.
    ``M`` must divide by ``n_shards``. The kernel's tiles are 128 x 128.

    Replaces ``_matmul_kernel`` (K11). Bound on the H100: operations,
    2·M·K·N at 989 TFLOP/s in bf16 (67 TFLOP/s in float32)."""
    M, K = x.shape
    if w.dim() != 2 or w.shape[0] != K:
        raise ValueError(f"shard_major_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if n_shards < 1 or M % n_shards:
        raise ValueError(f"rows {M} not divisible by {n_shards} shards")
    if x.device.type == "cpu":
        return matmul_reference(x, w)
    name = "shard_major_matmul"
    _check_cuda_operands(name, x, w)
    dtype = torch.promote_types(x.dtype, w.dtype)
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: float32 or bfloat16, not {dtype}")
    N = w.shape[1]
    if K % 8 or N % 8:
        raise ValueError(f"{name}: the kernel needs K and N multiples of 8, "
                         f"got {K}, {N}")
    x = x.to(dtype).contiguous()
    w = w.to(dtype).contiguous()
    y = torch.empty(M, N, dtype=dtype, device=x.device)
    err = kernel_function(_LIB, "shard_major_matmul_launch", _MATMUL_ARGS)(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, N, n_shards,
        DTYPE_CODES[dtype],
        get_accelerator().current_stream(x.device).cuda_stream)
    check_launch(name, err)
    shard_major_matmul.launches += 1
    return y


shard_major_matmul.launches = 0


# --------------------------------------------------------------------- #
# (a) reduce-scatter epilogue
# --------------------------------------------------------------------- #
def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, axes,
                          wire_bits: int = 0, group_size: int = 256,
                          n: Optional[int] = None) -> torch.Tensor:
    """``mean-reduce-scatter(x @ w)`` over the world along rows, the matmul
    walked shard-major (K11) so the exchange is the kernel's epilogue.

    → this rank's ``[M/n, N]`` mean partition. ``wire_bits`` 8/4 exchange
    it on the fused quantized wire (K9a/K9b on this rank's product, the
    all-to-all of wire bytes, K10b on the receive side); 0 is the
    full-precision reduce-scatter, ``psum_scatter(y) / n`` (a multiply by
    fl(1/n), as XLA compiles it)."""
    n = group_count(axes) if n is None else n
    M, N = x.shape[0], w.shape[1]
    if M % max(n, 1):
        raise ValueError(f"rows {M} not divisible by group size {n}")
    y = shard_major_matmul(x, w, max(n, 1))
    if n <= 1:
        return y
    if wire_bits:
        flat = y.reshape(-1).to(torch.float32)         # layout-only hop
        chunk = flat.numel() // n                      # one shard's block
        if chunk % group_size:
            raise ValueError(
                f"per-shard block of {chunk} elements not divisible by "
                f"quantization group_size={group_size}; pick N so that "
                f"(M/n)·N aligns (production shapes are 128-multiples)")
        wv, s = quant_pack_wire(flat, wire_bits, group_size)
        mine = _exchange_mean(wv, s, wire_bits, n)
        return mine.reshape(M // n, N).to(y.dtype)
    return comm.reduce_scatter_tensor(y) * inv_n(n)


# --------------------------------------------------------------------- #
# (b) all-gather prologue: K12
# --------------------------------------------------------------------- #
def unpack_dequant_wire_values(w: torch.Tensor, scales: torch.Tensor,
                               bits: int) -> torch.Tensor:
    """Wire bytes ``[g, W]`` and scales ``[g, 1]`` → float32 values
    ``[g, group_size]`` (the quantizer's unpack plus the scale multiply),
    K12's in-kernel dequantize written plainly."""
    return _unpack_wire(w, bits).to(torch.float32) * _ftz(
        scales.to(torch.float32))


def _gathered_dequant_matmul_reference(x, w_wire, s_wire, wire_bits,
                                       k_shard, N, out_dtype):
    """Plain version of K12: per shard, dequantize its weight block and add
    its k-slice's float32 product to the running sum."""
    n = w_wire.shape[0]
    acc = torch.zeros(x.shape[0], N, dtype=torch.float32, device=x.device)
    with _full_float32():
        for r in range(n):
            vals = unpack_dequant_wire_values(w_wire[r], s_wire[r], wire_bits)
            w_r = vals.reshape(-1)[:k_shard * N].reshape(k_shard, N)
            xk = x[:, r * k_shard:(r + 1) * k_shard].to(torch.float32)
            acc = acc + torch.matmul(xk, w_r)
    return acc.to(out_dtype)


def _gathered_dequant_matmul(x: torch.Tensor, w_wire: torch.Tensor,
                             s_wire: torch.Tensor, wire_bits: int,
                             k_shard: int, N: int,
                             out_dtype: torch.dtype) -> torch.Tensor:
    """``x [M, n·k_shard]`` against n gathered weight shards on the wire
    (``w_wire [n, g, W]`` int8, ``s_wire [n, g, 1]`` float32): per shard,
    unpack and dequantize its ``[k_shard, N]`` block (weight (k, c) is
    element k·N + c of the shard's padded flat) and add its float32
    product with ``x``'s k-slice to the running sum. → ``[M, N]`` in
    ``out_dtype``.

    Replaces the kernel of ``_gathered_dequant_matmul`` (K12). Bound on
    the H100: operations, 2·M·(n·k_shard)·N float32 FMAs at 67 TFLOP/s
    (exact float32 products, as the reference's dot: no TF32, no bf16
    rounding of the dequantized weight)."""
    n, groups, W = w_wire.shape
    group_size = W if wire_bits == 8 else 2 * W
    if wire_bits not in (4, 8):
        raise ValueError(f"wire_bits must be 4 or 8, got {wire_bits}")
    if x.shape[1] != n * k_shard or groups * group_size < k_shard * N:
        raise ValueError(f"_gathered_dequant_matmul: x {tuple(x.shape)} "
                         f"against {n} shards of [{k_shard}, {N}] on a "
                         f"wire of {groups} groups of {group_size}")
    if tuple(s_wire.shape) != (n, groups, 1):
        raise ValueError(f"_gathered_dequant_matmul: scales must be "
                         f"[{n}, {groups}, 1], got {tuple(s_wire.shape)}")
    if x.device.type == "cpu":
        return _gathered_dequant_matmul_reference(
            x, w_wire, s_wire, wire_bits, k_shard, N, out_dtype)
    name = "_gathered_dequant_matmul"
    _check_cuda_operands(name, x, w_wire, s_wire)
    if w_wire.dtype != torch.int8 or s_wire.dtype != torch.float32:
        raise ValueError(f"{name}: the wire is int8 and its scales float32")
    M = x.shape[0]
    x32 = x.to(torch.float32).contiguous()
    out = torch.empty(M, N, dtype=torch.float32, device=x.device)
    err = kernel_function(_LIB, "gathered_dequant_matmul_launch",
                          _GATHERED_ARGS)(
        x32.data_ptr(), w_wire.contiguous().data_ptr(),
        s_wire.contiguous().data_ptr(), out.data_ptr(), M, N, k_shard, n,
        groups, group_size, wire_bits,
        get_accelerator().current_stream(x.device).cuda_stream)
    check_launch(name, err)
    _gathered_dequant_matmul.launches += 1
    return out.to(out_dtype)


_gathered_dequant_matmul.launches = 0


def all_gather_matmul(x: torch.Tensor, w_shard: torch.Tensor, axes,
                      wire_bits: int = 0, group_size: int = 256,
                      n: Optional[int] = None) -> torch.Tensor:
    """``x @ all_gather(w_shard)`` with the gather as the matmul's
    prologue. ``w_shard`` is this rank's ``[K/n, N]`` row block of the
    weight. Full precision: the gathered weight feeds K11. ``wire_bits``
    8/4: this rank's shard is quantized and packed (K9a/K9b), the wire
    all-gathered, and K12 dequantizes each shard as it consumes it."""
    n = group_count(axes) if n is None else n
    k_shard, N = w_shard.shape
    if n <= 1:
        return shard_major_matmul(x, w_shard, 1)
    if wire_bits:
        wv, s = quant_pack_wire(w_shard.reshape(-1), wire_bits, group_size)
        w_all = comm.all_gather_into_tensor(wv).view(n, *wv.shape)
        s_all = comm.all_gather_into_tensor(s).view(n, *s.shape)
        return _gathered_dequant_matmul(
            x, w_all, s_all, wire_bits, k_shard, N,
            torch.promote_types(x.dtype, w_shard.dtype))
    w_full = comm.all_gather_into_tensor(w_shard.contiguous())
    return shard_major_matmul(x, w_full, 1)


def rms_normaliser(x: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version of K4's bfloat16 pre-pass (``rms_rows_kernel``): each
    row's ``rsqrt(mean(x²) + eps)`` in float32, cast to x's dtype, as
    ``models/transformer.py rms_norm`` computes it. → ``[..., 1]``."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return torch.rsqrt(var + eps).to(x.dtype)


def _normalize(x: torch.Tensor, scale: torch.Tensor,
               eps: float) -> torch.Tensor:
    """``models/transformer.py rms_norm``: the variance in float32, the
    normaliser cast to x's dtype before the products."""
    return (x * rms_normaliser(x, eps)) * scale


def rmsnorm_matmul_reference(x: torch.Tensor, scale: torch.Tensor,
                             w: torch.Tensor, eps: float) -> torch.Tensor:
    """The unfused composition (``rms_norm`` then the projection) the
    kernel is held against.

    Replaces ``_rmsnorm_matmul_kernel`` (K4) with
    ``csrc/rmsnorm_matmul.cu``."""
    return matmul_reference(_normalize(x, scale, eps), w)


def rmsnorm_matmul_fwd(x2: torch.Tensor, scale: torch.Tensor,
                       w: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's forward on ``x2 [M, D]``, ``scale [D]``, ``w [D, F]``
    → ``[M, F]``; the plain composition for CPU tensors.

    Replaces ``_rmsnorm_matmul_kernel``. Bound on the H100: operations,
    2·M·D·F flops at 989 TFLOP/s in bf16. On CUDA, bf16 runs in two
    launches counted as one call: a pre-pass writes each row's normaliser
    once (:func:`rms_normaliser`'s float32 sum and rounding) to a workspace
    this wrapper allocates, then a kernel fed by TMA through a 4-stage
    shared-memory ring runs wgmma on 128 x 256 output tiles, normalising
    each raw x fragment in registers on its way to the tensor cores.
    float32 keeps an exact CUDA-core kernel (wgmma has no full-float32
    mode)."""
    if x2.device.type == "cpu":
        return rmsnorm_matmul_reference(x2, scale, w, eps)
    M, D = x2.shape
    F = w.shape[1]
    name = "rmsnorm_matmul"
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not "
                         f"{x2.device}")
    for t in (scale, w):
        if t.device != x2.device or t.dtype != x2.dtype:
            raise ValueError(f"{name}: x, scale and w must share device and "
                             f"dtype")
    if x2.dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: float32 or bfloat16, not {x2.dtype}")
    if tuple(scale.shape) != (D,) or w.dim() != 2 or w.shape[0] != D:
        raise ValueError(f"{name}: x [M, {D}], scale [{D}], w [{D}, F]; got "
                         f"{tuple(scale.shape)}, {tuple(w.shape)}")
    if D % 8 or F % 8:
        raise ValueError(f"{name}: the kernel needs D and F multiples of 8, "
                         f"got {D}, {F}")
    for t in (x2, scale, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: inputs must be contiguous and 16-byte "
                             f"aligned")
    y = torch.empty(M, F, dtype=x2.dtype, device=x2.device)
    rows = torch.empty(M, dtype=torch.float32, device=x2.device)
    err = kernel_function(name, "rmsnorm_matmul_launch", _ARGS)(
        x2.data_ptr(), scale.data_ptr(), w.data_ptr(), y.data_ptr(),
        rows.data_ptr(), M, D, F, float(eps), DTYPE_CODES[x2.dtype],
        get_accelerator().current_stream(x2.device).cuda_stream)
    check_launch(name, err)
    rmsnorm_matmul_fwd.launches += 1
    return y


rmsnorm_matmul_fwd.launches = 0


class _RMSNormMatmul(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the reference
    composition (the JAX ``_rmsnorm_matmul_bwd``), with the projection's
    two products written out so that its unused forward product is not
    recomputed."""

    @staticmethod
    def forward(ctx, x2, scale, w, eps):
        ctx.save_for_backward(x2, scale, w)
        ctx.eps = eps
        return rmsnorm_matmul_fwd(x2, scale, w, eps)

    @staticmethod
    def backward(ctx, g):
        x2, scale, w = ctx.saved_tensors
        with torch.enable_grad():
            xs = x2.detach().requires_grad_()
            ss = scale.detach().requires_grad_()
            h = _normalize(xs, ss, ctx.eps)
        dw = matmul_reference(h.detach().t(), g) \
            if ctx.needs_input_grad[2] else None
        dx, ds = torch.autograd.grad(h, (xs, ss), matmul_reference(g, w.t()))
        return dx, ds, dw, None


def rmsnorm_matmul(x: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """``rms_norm(x, scale, eps) @ w`` in one kernel, differentiable.

    ``x`` may carry leading batch dims; its last dim contracts with
    ``w [D, F]``. → ``[..., F]``."""
    lead = x.shape[:-1]
    D = x.shape[-1]
    out = _RMSNormMatmul.apply(x.reshape(-1, D).contiguous(),
                               scale.reshape(D).contiguous(), w.contiguous(),
                               float(eps))
    return out.reshape(*lead, w.shape[1])


# --------------------------------------------------------------------- #
# Analytic cost
# --------------------------------------------------------------------- #
def matmul_costs(M: int, K: int, N: int,
                 dtype_bytes: int = 4) -> Tuple[float, float]:
    """(flops, device-memory bytes) of one ``[M, K] @ [K, N]``."""
    flops = 2.0 * M * K * N
    bytes_ = float(dtype_bytes) * (M * K + K * N + M * N)
    return flops, bytes_

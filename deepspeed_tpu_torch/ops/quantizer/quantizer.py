"""Group-wise symmetric int8/int4 quantization for the PyTorch port
(counterpart of ``deepspeed_tpu/ops/quantizer/quantizer.py``).

Six kernels, written by hand in CUDA C++ for Hopper
(``csrc/quantizer.cu``), replace the JAX package's Pallas kernels:

  * :func:`quantize_int8` — K8a, replacing ``_quant8_kernel``;
  * :func:`dequantize_int8` — K8b, replacing ``_dequant8_kernel``;
  * :func:`quant_pack_wire` with ``bits=8`` — K9a, replacing
    ``_quant_pack8_kernel`` (K8a's math, written as the int8 wire);
  * :func:`quant_pack_wire` with ``bits=4`` — K9b, replacing
    ``_quant_pack4_kernel`` (scale ``max|x| * fl(1/7)``, clip ±7, the
    half-split nibble pack);
  * :func:`unpack_dequant_wire` — K10a, replacing the kernel inside the
    reference's ``unpack_dequant_wire`` (int8 and half-split int4);
  * :func:`unpack_dequant_mean` — K10b, replacing the kernel inside the
    reference's ``unpack_dequant_mean``: the receive side of the quantized
    reduce-scatter, n peers' wires dequantized and averaged in one pass;
  * :func:`wire_residual` — K10a's variant for LoCo's error feedback,
    replacing the reference's ``x - unpack_dequant_wire(w, s)``: what the
    wire did not carry, ``fma(-q, s, x)`` an element.

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version beside it (``*_reference``), which the
CPU tests hold against the Pallas kernels in interpret mode, byte for
byte, and ``chip_smoke.py`` holds against the kernel on the card, bit for
bit. Each wrapper counts its launches in ``<wrapper>.launches``.

The bytes equal the JAX package's, so quantized weights, DSKV1 frames and
gradient wires cross between the packages. The rules that takes, in the
kernels and in the plain versions alike:

  * the scale is ``max|x| * fl(1/q_max)``: XLA folds the reference's
    division by the constant into that multiply; a zero scale becomes 1;
  * ``q = rint(x / scale)`` by IEEE division, ties to even, clipped to
    ``±q_max``; a NaN quotient gives 0;
  * NaN propagates through the max: a group holding a NaN gets scale NaN
    and every q 0, one holding an infinity scale inf and every q 0;
  * subnormal inputs, scales and results are flushed to zero, as the
    reference's CPU arithmetic flushes them;
  * the mean over peers (K10b) is ``q_0·s_0``, then ``fma(q_r, s_r, acc)``
    for r = 1..n-1 in peer order, times ``fl(1/n)``: XLA compiles the
    reference's ``sum(axis=0) / n`` to exactly that (measured against
    interpret mode at n = 2, 3, 4, 5).

Inputs may have any float dtype and shape; they are flattened and the
tail group zero-padded, giving q int8 ``[groups, group_size]`` and scales
float32 ``[groups, 1]``. The kernels read float32, bfloat16 and float16
directly (the reference's cast to float32 is exact for them).

The legacy interleaved int4 pair (:func:`quantize_int4`,
:func:`dequantize_int4`) is plain jnp in the reference, run eagerly by
``quantize_params``; here it is plain PyTorch on the tensor's own device,
and its scale is an IEEE division by 7, as the eager reference computes
it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ...accelerator import get_accelerator
from ..op_builder.builder import check_launch, kernel_function

_LIB = "quantizer"
_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = {
    # x, n, group_size, groups, q, scales, dtype, stream
    "quantize_int8_launch": [_P, _N, _I, _N, _P, _P, _I, _P],
    "quant_pack_wire8_launch": [_P, _N, _I, _N, _P, _P, _I, _P],
    "quant_pack_wire4_launch": [_P, _N, _I, _N, _P, _P, _I, _P],
    # q, scales, group_size, n, out, out_dtype, stream
    "dequantize_int8_launch": [_P, _P, _I, _N, _P, _I, _P],
    # w, scales, bits, group_size, n, out, out_dtype, stream
    "unpack_dequant_wire_launch": [_P, _P, _I, _I, _N, _P, _I, _P],
    # x, w, scales, bits, group_size, n, out, stream
    "wire_residual_launch": [_P, _P, _P, _I, _I, _N, _P, _P],
    # w, scales, bits, npeers, groups, group_size, inv_n, add, out, stream
    "unpack_dequant_mean_launch": [_P, _P, _I, _I, _N, _I, ctypes.c_float,
                                   _P, _P, _P],
}
#: element-type codes of ``enum DType`` in ``csrc/quantizer.cu``
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_FLT_MIN = torch.finfo(torch.float32).tiny


def launcher(fn: str):
    """The ``extern "C"`` launcher ``fn`` of ``csrc/quantizer.cu``, built
    on first use."""
    return kernel_function(_LIB, fn, ARGTYPES[fn])


def wire_width(bits: int, group_size: int) -> int:
    """Wire bytes per group (int8: one byte per value; int4: two values
    per byte)."""
    return group_size if bits == 8 else group_size // 2


# --------------------------------------------------------------------- #
# Shared plain math
# --------------------------------------------------------------------- #
def _ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormals → 0 (NaN and infinities stay)."""
    return x.masked_fill(x.abs() < _FLT_MIN, 0.0)


def _float_groups(x: torch.Tensor, group_size: int) -> torch.Tensor:
    """x flattened to a float32 copy [groups, group_size], the tail group
    zero-padded."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    if x.numel() == 0:
        raise ValueError("cannot quantize an empty tensor")
    flat = x.reshape(-1).to(torch.float32, copy=True)
    pad = -flat.numel() % group_size
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, group_size)


def _quantize_groups(x: torch.Tensor, group_size: int, q_max: int,
                     ieee_scale: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The quantize of every kernel and of the legacy int4 pair:
    → (q int8 [groups, group_size] unpacked, scales f32 [groups, 1]).

    ``ieee_scale`` divides ``max|x|`` by ``q_max`` (the eager legacy int4);
    otherwise it multiplies by ``fl(1/q_max)`` (the Pallas bodies)."""
    xg = _float_groups(x, group_size)                    # a copy: in place
    xg.masked_fill_(xg.abs() < _FLT_MIN, 0.0)            # subnormals → 0
    amax = xg.abs().amax(dim=1, keepdim=True)           # NaN propagates
    qm = torch.full_like(amax, float(q_max))
    scale = amax / qm if ieee_scale else amax * (torch.ones_like(qm) / qm)
    scale = scale.masked_fill(scale < _FLT_MIN, 1.0)    # 0 and subnormal → 1
    # expanded so that the division is an elementwise IEEE one even with a
    # single group (PyTorch may multiply by the reciprocal of a scalar)
    r = xg.div_(scale.expand_as(xg)).round_()
    r = r.masked_fill_(torch.isnan(r), 0.0).clamp_(-q_max, q_max)
    return r.to(torch.int8), scale


def _dequantize_groups(q: torch.Tensor, scales: torch.Tensor, shape,
                       dtype: torch.dtype) -> torch.Tensor:
    """q int8 [groups, group_size] unpacked, × flushed scales in float32,
    cut to ``shape``, cast to ``dtype``."""
    out = q.to(torch.float32).mul_(_ftz(scales.to(torch.float32)).expand_as(q))
    flat = out.reshape(-1)
    if shape is not None:
        n = _out_count(shape, q.shape[0], q.shape[1])
        flat = flat[:n].reshape(tuple(int(d) for d in shape))
    return _cast(flat, dtype)


#: the quiet NaN a float32 NaN becomes in each 16-bit type, as the
#: reference's conversion writes it: (positive, negative) bit patterns
_QUIET_NAN16 = {torch.bfloat16: (0x7FC0, -0x40),
                torch.float16: (0x7E00, -0x200)}


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 → ``dtype`` rounding to nearest even; a NaN keeps its sign
    and becomes the quiet NaN of a 16-bit type (PyTorch's own casts write
    other NaN bits on each device)."""
    out = x.to(dtype)
    if dtype not in _QUIET_NAN16:
        return out
    nan = torch.isnan(x).nonzero(as_tuple=True)
    if nan[0].numel():
        pos, neg = (torch.tensor(b, dtype=torch.int16, device=x.device)
                    for b in _QUIET_NAN16[dtype])
        out.view(torch.int16)[nan] = torch.where(torch.signbit(x[nan]), neg,
                                                 pos)
    return out


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _pack_half_split(q: torch.Tensor) -> torch.Tensor:
    """int4 values [groups, group_size] → wire bytes [groups, group_size/2]:
    element i in the low nibble, i + group_size/2 in the high one."""
    half = q.shape[1] // 2
    return ((q[:, :half] & 0x0F) | ((q[:, half:] & 0x0F) << 4)).to(torch.int8)


def _unpack_wire(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Wire bytes [groups, W] → int8 values [groups, group_size]: identity
    for int8; sign-extended half-split nibbles for int4."""
    if bits == 8:
        return w
    lo = torch.bitwise_left_shift(w, 4).to(torch.int8) >> 4
    hi = w >> 4                                  # arithmetic: keeps the sign
    return torch.cat([lo, hi], dim=1)


_FMA_ROWS_ELEMS = 1 << 22          # elements a float64 step of _fma holds


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once (``fmaf``), for a product that is
    exact in float64 (two float32 values, or an int8 one and a float32).
    ``a``, ``b`` and ``c`` have one shape, of at least one dim; → float32
    of that shape.

    The sum is taken in float64 and rounded to odd there (TwoSum gives its
    error; an inexact sum with an even last bit moves one ulp toward the
    error), which makes the final rounding to float32 a correct one: 53
    bits hold the 24 of float32 and two more. Rows along dim 0 go a few
    million elements at a time, so the float64 temporaries stay small."""
    out = torch.empty(c.shape, dtype=torch.float32, device=c.device)
    step = max(1, _FMA_ROWS_ELEMS // max(1, c[0].numel()))
    for i in range(0, c.shape[0], step):
        sl = slice(i, i + step)
        p = a[sl].to(torch.float64) * b[sl].to(torch.float64)
        c64 = c[sl].to(torch.float64)
        s = p + c64
        bb = s - p
        err = (p - (s - bb)) + (c64 - bb)
        fix = torch.isfinite(s) & (err != 0)
        bits = s.view(torch.int64)
        fix &= (bits & 1) == 0
        up = torch.where((err > 0) == (s > 0), 1, -1).to(torch.int64)
        out[sl] = torch.where(fix, bits + up, bits).view(torch.float64)
    return out


# --------------------------------------------------------------------- #
# CUDA launch helpers
# --------------------------------------------------------------------- #
def _cuda_input(name: str, x: torch.Tensor) -> torch.Tensor:
    """x as a contiguous float32/bfloat16/float16 CUDA tensor; raises on
    any other device."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not "
                         f"{x.device}")
    if not x.is_floating_point():
        raise ValueError(f"{name}: needs a floating-point tensor, got "
                         f"{x.dtype}")
    if x.dtype not in DTYPES:
        x = x.to(torch.float32)      # the reference's astype(float32)
    return x.contiguous()


def _check_wire(name: str, w: torch.Tensor, scales: torch.Tensor,
                dtype: torch.dtype):
    """Raise unless w is int8 and scales float32 [groups, 1] on one CUDA
    device, and dtype is one the kernel writes. → (w, scales, stream)."""
    if w.device.type != "cuda":
        raise ValueError(f"{name}: runs on CUDA or CPU tensors, not "
                         f"{w.device}")
    if w.dtype != torch.int8 or w.dim() != 2:
        raise ValueError(f"{name}: q must be int8 [groups, W], got {w.dtype} "
                         f"{tuple(w.shape)}")
    if scales.device != w.device or scales.dtype != torch.float32 \
            or scales.numel() != w.shape[0]:
        raise ValueError(f"{name}: scales must be float32 [{w.shape[0]}, 1] "
                         f"on {w.device}, got {scales.dtype} "
                         f"{tuple(scales.shape)} on {scales.device}")
    if dtype not in DTYPES:
        raise ValueError(f"{name}: writes float32, bfloat16 or float16, not "
                         f"{dtype}")
    stream = get_accelerator().current_stream(w.device).cuda_stream
    return w.contiguous(), scales.contiguous(), stream


def _out_count(shape, groups: int, group_size: int) -> int:
    n = groups * group_size if shape is None else _numel(shape)
    if n > groups * group_size:
        raise ValueError(f"shape {tuple(shape)} holds more than the "
                         f"{groups * group_size} quantized values")
    return n


def _launch_quantize(name: str, fn: str, x: torch.Tensor, group_size: int,
                     width: int = 0):
    """Launch a quantizer writing ``[groups, width or group_size]`` int8
    and ``[groups, 1]`` float32 scales."""
    x = _cuda_input(name, x)
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    n = x.numel()
    if n == 0:
        raise ValueError("cannot quantize an empty tensor")
    groups = -(-n // group_size)
    q = torch.empty(groups, width or group_size, dtype=torch.int8,
                    device=x.device)
    s = torch.empty(groups, 1, dtype=torch.float32, device=x.device)
    stream = get_accelerator().current_stream(x.device).cuda_stream
    err = launcher(fn)(x.data_ptr(), n, group_size, groups, q.data_ptr(),
                       s.data_ptr(), DTYPES[x.dtype], stream)
    check_launch(name, err)
    return q, s


# --------------------------------------------------------------------- #
# K8a / K8b: int8 quantize and dequantize
# --------------------------------------------------------------------- #
def quantize_int8_reference(x: torch.Tensor, group_size: int = 256
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K8a. → (q int8 [groups, group_size], scales f32
    [groups, 1])."""
    return _quantize_groups(x, group_size, 127)


def quantize_int8(x: torch.Tensor, group_size: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any float dtype and shape) → (q int8 [groups, group_size],
    scales f32 [groups, 1]); flattens and zero-pads the tail group.

    Replaces ``_quant8_kernel`` (K8a). Bound on the H100: bytes, the input
    read once, q and the scales written once, at 3.35 TB/s."""
    if x.device.type == "cpu":
        return quantize_int8_reference(x, group_size)
    out = _launch_quantize("quantize_int8", "quantize_int8_launch", x,
                           group_size)
    quantize_int8.launches += 1
    return out


quantize_int8.launches = 0


def dequantize_int8_reference(q: torch.Tensor, scales: torch.Tensor,
                              shape=None, dtype=torch.float32
                              ) -> torch.Tensor:
    """Plain version of K8b."""
    return _dequantize_groups(q, scales, shape, dtype)


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, shape=None,
                    dtype=torch.float32) -> torch.Tensor:
    """(q int8 [groups, group_size], scales f32 [groups, 1]) → q · scale in
    float32, the first ``prod(shape)`` values reshaped to ``shape`` (all of
    them, flat, without one), cast to ``dtype``.

    Replaces ``_dequant8_kernel`` (K8b). The kernel writes ``dtype`` and
    only the kept values, so no float32 copy of the whole tensor is made.
    Bound on the H100: bytes, q and the scales read once, the output
    written once."""
    if q.device.type == "cpu":
        return dequantize_int8_reference(q, scales, shape, dtype)
    q, scales, stream = _check_wire("dequantize_int8", q, scales, dtype)
    groups, group_size = q.shape
    n = _out_count(shape, groups, group_size)
    out = torch.empty(n, dtype=dtype, device=q.device)
    err = launcher("dequantize_int8_launch")(
        q.data_ptr(), scales.data_ptr(), group_size, n, out.data_ptr(),
        DTYPES[dtype], stream)
    check_launch("dequantize_int8", err)
    dequantize_int8.launches += 1
    return out if shape is None else out.view(tuple(int(d) for d in shape))


dequantize_int8.launches = 0


# --------------------------------------------------------------------- #
# Legacy interleaved int4 (plain in the reference too)
# --------------------------------------------------------------------- #
def quantize_int4(x: torch.Tensor, group_size: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (packed int8 [groups, group_size/2], scales f32 [groups, 1]):
    element 2i in the low nibble, 2i+1 in the high one. Plain PyTorch on
    x's device; the scale is ``max|x| / 7`` by IEEE division."""
    if group_size % 2:
        raise ValueError(f"int4 needs an even group_size, got {group_size}")
    q, scale = _quantize_groups(x, group_size, 7, ieee_scale=True)
    packed = (q[:, 0::2] & 0x0F) | ((q[:, 1::2] & 0x0F) << 4)
    return packed.to(torch.int8), scale


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor, shape=None,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_int4`, plain PyTorch on the tensors'
    device."""
    lo = torch.bitwise_left_shift(packed, 4).to(torch.int8) >> 4
    hi = packed >> 4
    q = torch.stack([lo, hi], dim=2).reshape(packed.shape[0], -1)
    return _dequantize_groups(q, scales, shape, dtype)


# --------------------------------------------------------------------- #
# K9a / K10a: the fused wire
# --------------------------------------------------------------------- #
def _quant_pack4_reference(x: torch.Tensor, group_size: int = 256
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9b (``_quant_pack4_kernel``): scale ``max|x| *
    fl(1/7)``, clip ±7, half-split nibble pack. → (wire int8 [groups,
    group_size/2], scales f32 [groups, 1])."""
    if group_size % 2:
        raise ValueError(f"int4 needs an even group_size, got {group_size}")
    q, scale = _quantize_groups(x, group_size, 7)
    return _pack_half_split(q), scale


def quant_pack_wire_reference(x: torch.Tensor, bits: int,
                              group_size: int = 256
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K9a (``bits=8``) and K9b (``bits=4``)."""
    if bits == 4:
        return _quant_pack4_reference(x, group_size)
    if bits != 8:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return _quantize_groups(x, group_size, 127)


def quant_pack_wire(x: torch.Tensor, bits: int, group_size: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) → (wire int8 [groups, wire_width], scales f32
    [groups, 1]) in one kernel; flattens and zero-pads the tail group.

    ``bits=8`` replaces ``_quant_pack8_kernel`` (K9a): K8a's math, so the
    int8 wire equals :func:`quantize_int8`'s bytes. ``bits=4`` replaces
    ``_quant_pack4_kernel`` (K9b): scale ``max|x| * fl(1/7)``, clip ±7,
    byte j of a group holding q[j] in its low nibble and q[j + G/2] in
    its high one. Bound on the H100: bytes, the input read once and the
    wire and scales written once. ``.launches`` counts K9a,
    ``.launches4`` K9b."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if x.device.type == "cpu":
        return quant_pack_wire_reference(x, bits, group_size)
    if bits == 8:
        out = _launch_quantize("quant_pack_wire", "quant_pack_wire8_launch",
                               x, group_size)
        quant_pack_wire.launches += 1
        return out
    if group_size % 2:
        raise ValueError(f"int4 needs an even group_size, got {group_size}")
    out = _launch_quantize("quant_pack_wire", "quant_pack_wire4_launch", x,
                           group_size, width=group_size // 2)
    quant_pack_wire.launches4 += 1
    return out


quant_pack_wire.launches = 0
quant_pack_wire.launches4 = 0


def unpack_dequant_wire_reference(w: torch.Tensor, scales: torch.Tensor,
                                  bits: int, shape=None,
                                  dtype=torch.float32) -> torch.Tensor:
    """Plain version of K10a."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return _dequantize_groups(_unpack_wire(w, bits), scales, shape, dtype)


def unpack_dequant_wire(w: torch.Tensor, scales: torch.Tensor, bits: int,
                        shape=None, dtype=torch.float32) -> torch.Tensor:
    """(wire [groups, W], scales [groups, 1]) → values: unpack (int8: the
    identity; int4: sign-extended half-split nibbles) and dequantize in
    one kernel, cut to ``shape`` and cast to ``dtype``. The inverse of
    :func:`quant_pack_wire`.

    Replaces the kernel inside ``unpack_dequant_wire`` (K10a), both
    widths. Bound on the H100: bytes, the wire and the scales read once,
    the output written once."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w.device.type == "cpu":
        return unpack_dequant_wire_reference(w, scales, bits, shape, dtype)
    w, scales, stream = _check_wire("unpack_dequant_wire", w, scales, dtype)
    groups, W = w.shape
    group_size = W if bits == 8 else 2 * W
    n = _out_count(shape, groups, group_size)
    out = torch.empty(n, dtype=dtype, device=w.device)
    err = launcher("unpack_dequant_wire_launch")(
        w.data_ptr(), scales.data_ptr(), bits, group_size, n,
        out.data_ptr(), DTYPES[dtype], stream)
    check_launch("unpack_dequant_wire", err)
    unpack_dequant_wire.launches += 1
    return out if shape is None else out.view(tuple(int(d) for d in shape))


unpack_dequant_wire.launches = 0


def wire_residual_reference(x: torch.Tensor, w: torch.Tensor,
                            scales: torch.Tensor, bits: int) -> torch.Tensor:
    """Plain version of :func:`wire_residual`: :func:`_fma`, then a
    subnormal result flushed to the zero of its sign."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    q = _unpack_wire(w, bits)
    s = _ftz(scales.to(torch.float32)).expand(q.shape)
    r = _fma(-q, s, x.reshape(q.shape).to(torch.float32)).reshape(-1)
    return torch.where(r.abs() < _FLT_MIN, r * 0, r)


def wire_residual(x: torch.Tensor, w: torch.Tensor, scales: torch.Tensor,
                  bits: int) -> torch.Tensor:
    """LoCo's residual, what the wire did not carry: ``x - q·s`` per
    element rounded once, float32 flat. ``x`` is float32 of the wire's
    ``groups * group_size`` values (the quantizer's padded input), ``(w,
    scales)`` its wire as :func:`unpack_dequant_wire` reads it.

    K10a's variant: the reference's ``x - unpack_dequant_wire(w, s)``
    compiles (XLA on the CPU) to ``fma(-q, s, x)`` with a subnormal result
    flushed to the zero of its sign, and the kernel computes exactly that. Bound on
    the H100: bytes, x, the wire and the scales read once, the float32
    residual written once."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    n = w.numel() * (8 // bits)                  # groups * group_size
    if x.numel() != n:
        raise ValueError(f"wire_residual: x must hold the wire's {n} values, "
                         f"got {tuple(x.shape)}")
    if w.device.type == "cpu":
        return wire_residual_reference(x, w, scales, bits)
    w, scales, stream = _check_wire("wire_residual", w, scales,
                                    torch.float32)
    group_size = w.shape[1] * (8 // bits)
    if x.device != w.device or x.dtype != torch.float32:
        raise ValueError(f"wire_residual: x must be float32 on {w.device}, "
                         f"got {x.dtype} on {x.device}")
    x = x.contiguous()
    out = torch.empty(n, dtype=torch.float32, device=w.device)
    err = launcher("wire_residual_launch")(
        x.data_ptr(), w.data_ptr(), scales.data_ptr(), bits, group_size, n,
        out.data_ptr(), stream)
    check_launch("wire_residual", err)
    wire_residual.launches += 1
    return out


wire_residual.launches = 0


def unpack_dequant_mean_reference(w: torch.Tensor, scales: torch.Tensor,
                                  bits: int, n: int,
                                  add: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain version of K10b: peer 0's values, then each next peer's
    product fused into the running sum (:func:`_fma`), times fl(1/n), and
    ``add`` fused into that last multiply when given."""
    _check_mean_args(w, scales, bits, n, add)
    acc = None
    for r in range(n):
        q = _unpack_wire(w[r], bits)
        s = _ftz(scales[r].to(torch.float32)).expand(q.shape)
        acc = q.to(torch.float32) * s if acc is None else _fma(q, s, acc)
        acc = _ftz(acc)
    inv_n = (torch.ones((), dtype=torch.float32, device=acc.device) / n
             ).expand(acc.shape)
    if add is None:
        return _ftz(acc * inv_n).reshape(-1)
    return _ftz(_fma(acc, inv_n, add.to(torch.float32).view(acc.shape))
                ).reshape(-1)


def _check_mean_args(w, scales, bits, n, add=None):
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if w.dim() != 3 or w.shape[0] != n or w.dtype != torch.int8:
        raise ValueError(f"unpack_dequant_mean: wire must be int8 [{n}, "
                         f"groups, W], got {w.dtype} {tuple(w.shape)}")
    if tuple(scales.shape) != (n, w.shape[1], 1):
        raise ValueError(f"unpack_dequant_mean: scales must be [{n}, "
                         f"{w.shape[1]}, 1], got {tuple(scales.shape)}")
    G = w.shape[2] if bits == 8 else 2 * w.shape[2]
    if add is not None and add.numel() != w.shape[1] * G:
        raise ValueError(f"unpack_dequant_mean: add must hold "
                         f"{w.shape[1] * G} values, got {add.numel()}")


def unpack_dequant_mean(w: torch.Tensor, scales: torch.Tensor, bits: int,
                        n: int, add: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Fused unpack + dequant + mean over the peer axis: (wire
    ``[n, groups, W]``, scales ``[n, groups, 1]``) → float32
    ``[groups * group_size]``.

    The receive side of a quantized reduce-scatter: each of the ``n``
    peers sent a quantized copy of this rank's partition; one pass
    dequantizes and averages them without writing the n float32 copies.
    ``add`` (float32, one value an output) is added in the same rounding
    as the multiply by fl(1/n), as XLA fuses the reference's mean with
    LoCo's following ``+ server_error``. Replaces the kernel inside
    ``unpack_dequant_mean`` (K10b). Bound on the H100: bytes, the n wires
    and scales (and ``add``) read once, the float32 mean written once."""
    if w.device.type == "cpu":
        return unpack_dequant_mean_reference(w, scales, bits, n, add)
    _check_mean_args(w, scales, bits, n, add)
    if scales.dtype != torch.float32 or scales.device != w.device:
        raise ValueError("unpack_dequant_mean: scales must be float32 on "
                         f"{w.device}")
    w, scales = w.contiguous(), scales.contiguous()
    groups, W = w.shape[1], w.shape[2]
    group_size = W if bits == 8 else 2 * W
    out = torch.empty(groups * group_size, dtype=torch.float32,
                      device=w.device)
    if add is not None:
        if add.device != w.device or add.dtype != torch.float32:
            raise ValueError("unpack_dequant_mean: add must be float32 on "
                             f"{w.device}")
        add = add.contiguous()
    inv_n = float(torch.ones((), dtype=torch.float32) / n)
    stream = get_accelerator().current_stream(w.device).cuda_stream
    err = launcher("unpack_dequant_mean_launch")(
        w.data_ptr(), scales.data_ptr(), bits, n, groups, group_size, inv_n,
        None if add is None else add.data_ptr(), out.data_ptr(), stream)
    check_launch("unpack_dequant_mean", err)
    unpack_dequant_mean.launches += 1
    return out


unpack_dequant_mean.launches = 0


# --------------------------------------------------------------------- #
# Dispatch
# --------------------------------------------------------------------- #
def get_quant_fns(bits: int):
    """(quantize, dequantize) pair for a bit width — the one dispatch
    table (the legacy quantized allreduce, weight-only serving and the
    Quantizer class)."""
    if bits == 4:
        return quantize_int4, dequantize_int4
    if bits == 8:
        return quantize_int8, dequantize_int8
    raise ValueError(f"bits must be 4 or 8, got {bits}")


class Quantizer:
    """Reference binding-class shape (deepspeed/ops/quantizer/quantizer.py)."""

    def __init__(self, q_bits: int = 8, group_size: int = 256):
        if q_bits not in (4, 8):
            raise ValueError(f"q_bits must be 4 or 8, got {q_bits}")
        self.q_bits = q_bits
        self.group_size = group_size

    def quantize(self, x: torch.Tensor):
        return get_quant_fns(self.q_bits)[0](x, self.group_size)

    def dequantize(self, q: torch.Tensor, scales: torch.Tensor, shape=None,
                   dtype: torch.dtype = torch.float32):
        return get_quant_fns(self.q_bits)[1](q, scales, shape, dtype)

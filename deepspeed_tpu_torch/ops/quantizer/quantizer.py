"""Group-wise symmetric int8/int4 quantization for the PyTorch port
(counterpart of ``deepspeed_tpu/ops/quantizer/quantizer.py``).

Four kernels, written by hand in CUDA C++ for Hopper
(``csrc/quantizer.cu``), replace the JAX package's Pallas kernels:

  * :func:`quantize_int8` — K8a, replacing ``_quant8_kernel``;
  * :func:`dequantize_int8` — K8b, replacing ``_dequant8_kernel``;
  * :func:`quant_pack_wire` with ``bits=8`` — K9a, replacing
    ``_quant_pack8_kernel`` (K8a's math, written as the int8 wire);
  * :func:`unpack_dequant_wire` — K10a, replacing the kernel inside the
    reference's ``unpack_dequant_wire`` (int8 and half-split int4).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor
it runs the plain PyTorch version beside it (``*_reference``), which the
CPU tests hold against the Pallas kernels in interpret mode, byte for
byte, and ``chip_smoke.py`` holds against the kernel on the card, bit for
bit. Each wrapper counts its launches in ``<wrapper>.launches``.

The bytes equal the JAX package's, so quantized weights and DSKV1 frames
cross between the packages. The rules that takes, in the kernels and in
the plain versions alike:

  * the scale is ``max|x| * fl(1/q_max)``: XLA folds the reference's
    division by the constant into that multiply; a zero scale becomes 1;
  * ``q = rint(x / scale)`` by IEEE division, ties to even, clipped to
    ``±q_max``; a NaN quotient gives 0;
  * NaN propagates through the max: a group holding a NaN gets scale NaN
    and every q 0, one holding an infinity scale inf and every q 0;
  * subnormal inputs and scales are flushed to zero, as the reference's
    CPU arithmetic flushes them.

Inputs may have any float dtype and shape; they are flattened and the
tail group zero-padded, giving q int8 ``[groups, group_size]`` and scales
float32 ``[groups, 1]``. The kernels read float32, bfloat16 and float16
directly (the reference's cast to float32 is exact for them).

The legacy interleaved int4 pair (:func:`quantize_int4`,
:func:`dequantize_int4`) is plain jnp in the reference, run eagerly by
``quantize_params``; here it is plain PyTorch on the tensor's own device,
and its scale is an IEEE division by 7, as the eager reference computes
it. The int4 wire quantizer (K9b) and the dequantize-mean of the
quantized reduce-scatter (K10b) serve only paths with more than one
device: they raise ``NotImplementedError`` (ROADMAP M8). A plain K9b,
:func:`_quant_pack4_reference`, makes int4 wire bytes for K10a's tests.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...accelerator import get_accelerator
from ..op_builder.builder import check_launch, kernel_function

_LIB = "quantizer"
_P, _N, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
ARGTYPES = {
    # x, n, group_size, groups, q, scales, dtype, stream
    "quantize_int8_launch": [_P, _N, _I, _N, _P, _P, _I, _P],
    "quant_pack_wire8_launch": [_P, _N, _I, _N, _P, _P, _I, _P],
    # q, scales, group_size, n, out, out_dtype, stream
    "dequantize_int8_launch": [_P, _P, _I, _N, _P, _I, _P],
    # w, scales, bits, group_size, n, out, out_dtype, stream
    "unpack_dequant_wire_launch": [_P, _P, _I, _I, _N, _P, _I, _P],
}
#: element-type codes of ``enum DType`` in ``csrc/quantizer.cu``
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

_FLT_MIN = torch.finfo(torch.float32).tiny
_M8 = ("is reached only from the paths with more than one device "
       "(quantized collectives); it is not ported yet: ROADMAP M8")


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


def _launch_quantize(name: str, fn: str, x: torch.Tensor, group_size: int):
    x = _cuda_input(name, x)
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    n = x.numel()
    if n == 0:
        raise ValueError("cannot quantize an empty tensor")
    groups = -(-n // group_size)
    q = torch.empty(groups, group_size, dtype=torch.int8, device=x.device)
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
    """Plain version of K9a (``bits=8``)."""
    if bits == 4:
        raise NotImplementedError(f"quant_pack_wire(bits=4) (K9b) {_M8}")
    if bits != 8:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    return _quantize_groups(x, group_size, 127)


def quant_pack_wire(x: torch.Tensor, bits: int, group_size: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape) → (wire int8 [groups, wire_width], scales f32
    [groups, 1]) in one kernel; flattens and zero-pads the tail group.

    ``bits=8`` replaces ``_quant_pack8_kernel`` (K9a): K8a's math, so the
    int8 wire equals :func:`quantize_int8`'s bytes. ``bits=4`` (K9b)
    raises ``NotImplementedError`` (ROADMAP M8). Bound on the H100: bytes,
    as K8a."""
    if x.device.type == "cpu":
        return quant_pack_wire_reference(x, bits, group_size)
    if bits == 4:
        raise NotImplementedError(f"quant_pack_wire(bits=4) (K9b) {_M8}")
    if bits != 8:
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = _launch_quantize("quant_pack_wire", "quant_pack_wire8_launch", x,
                           group_size)
    quant_pack_wire.launches += 1
    return out


quant_pack_wire.launches = 0


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


def unpack_dequant_mean(w: torch.Tensor, scales: torch.Tensor, bits: int,
                        n: int) -> torch.Tensor:
    """The receive side of the quantized reduce-scatter (K10b): not ported
    (ROADMAP M8)."""
    raise NotImplementedError(f"unpack_dequant_mean (K10b) {_M8}")


# --------------------------------------------------------------------- #
# Dispatch
# --------------------------------------------------------------------- #
def get_quant_fns(bits: int):
    """(quantize, dequantize) pair for a bit width — the one dispatch
    table (weight-only serving and the Quantizer class)."""
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

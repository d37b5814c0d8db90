"""The port's int8/int4 quantizers against the JAX package's, on the CPU.

The plain versions of K8a (``quantize_int8``), K9a (``quant_pack_wire``,
8 bits), K8b (``dequantize_int8``) and K10a (``unpack_dequant_wire``, both
widths) are held against the Pallas kernels, run in interpret mode as the
JAX package's own tests run them, BYTE FOR BYTE: q and the scales'
float32 bits, and the dequantized values' bits. The tolerance is zero,
because quantized weights and DSKV1 frames cross between the packages.

Each input is an edge batch: ordinary groups, an all-zero group, values
planted on exact half quantization steps (ties go to even), a group of
subnormals (flushed: scale 1, q 0), a group holding a NaN (scale NaN,
q 0), one holding an infinity (scale inf, q 0), and a tail off the group
grid (zero-padded).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.quantizer import quantizer as jq
from deepspeed_tpu_torch.ops.quantizer import quantizer as tq

pytestmark = pytest.mark.torch_port

GROUP_SIZES = (2, 64, 256, 1000, 1024)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
INV127 = np.float32(1) / np.float32(127)

ZERO, HALF, SUBNORMAL, NAN, INF = 1, 2, 3, 4, 5   # group index in the batch


def edge_batch(gs, seed=0):
    """float32 [6 * gs + gs // 3 + 1]: the groups above, then the tail."""
    rng = np.random.default_rng(seed + gs)
    normal = rng.standard_normal(gs).astype(np.float32)
    zero = np.zeros(gs, np.float32)
    amax = np.float32(127.0) * np.float32(2.0 ** int(rng.integers(-3, 4)))
    step = amax * INV127
    k = rng.integers(-126, 126, gs).astype(np.float32) + np.float32(0.5)
    half = (k * step).astype(np.float32)
    half[0] = amax
    subnormal = np.where(rng.random(gs) < 0.5, -3e-39, 3e-39).astype(
        np.float32)
    nan = rng.standard_normal(gs).astype(np.float32)
    nan[gs // 2] = np.nan
    inf = rng.standard_normal(gs).astype(np.float32)
    inf[-1] = np.inf
    tail = rng.standard_normal(gs // 3 + 1).astype(np.float32)
    return np.concatenate([normal, zero, half, subnormal, nan, inf, tail])


def both(x32, dtype):
    """The same values as a JAX array and a CPU tensor of ``dtype``, bit
    for bit (the 16-bit types travel by their bits)."""
    jdt, tdt = DTYPES[dtype]
    jx = jnp.asarray(x32).astype(jdt)
    arr = np.asarray(jx)
    if dtype == "bf16":
        tx = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        tx = torch.from_numpy(arr.copy())
    return jx, tx


def bits(t):
    """Raw bits of a tensor or array, for exact comparison (NaN too)."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        t = t.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
            t.element_size()])
        return t.numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def assert_same(port, ref, what):
    p, r = bits(port), bits(ref)
    if p != r:
        pa = np.frombuffer(p, np.uint8)
        ra = np.frombuffer(r, np.uint8)
        n = min(len(pa), len(ra))
        raise AssertionError(f"{what}: {len(p)} vs {len(r)} bytes, "
                             f"{int((pa[:n] != ra[:n]).sum())} differ")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("gs", GROUP_SIZES)
def test_int8_quantize_matches_pallas(gs, dtype):
    """Plain K8a and K9a against ``quantize_int8`` and
    ``quant_pack_wire(bits=8)`` in interpret mode: identical q and scale
    bits; the edge groups follow the reference's rules."""
    jx, tx = both(edge_batch(gs), dtype)
    q, s = tq.quantize_int8(tx, gs)
    jqv, jsv = jq.quantize_int8(jx, gs)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == tuple(jqv.shape) and tuple(s.shape) == (
        q.shape[0], 1)
    assert_same(q, jqv, "K8a q")
    assert_same(s, jsv, "K8a scales")
    w, ws = tq.quant_pack_wire(tx, 8, gs)
    jw, jws = jq.quant_pack_wire(jx, 8, gs)
    assert_same(w, jw, "K9a wire")
    assert_same(ws, jws, "K9a scales")
    assert torch.equal(w, q) and bits(ws) == bits(s)

    s = s[:, 0]
    assert s[ZERO] == 1.0 and not q[ZERO].any()
    assert s[SUBNORMAL] == 1.0 and not q[SUBNORMAL].any()
    assert torch.isnan(s[NAN]) and not q[NAN].any()
    assert torch.isinf(s[INF]) and not q[INF].any()
    n = tx.numel()
    assert not q.reshape(-1)[n:].any()                 # the zero-padded tail


def _quantized(gs, dtype):
    jx, tx = both(edge_batch(gs), dtype)
    return jq.quantize_int8(jx, gs), tx


@pytest.mark.parametrize("gs", (64, 1000))
def test_int8_dequantize_matches_pallas(gs):
    """Plain K8b against ``dequantize_int8`` in interpret mode, on the
    reference's own q and scales, flat and cut to ``shape``, in float32,
    bfloat16 and float16: identical bits (NaN included)."""
    (jqv, jsv), tx = _quantized(gs, "f32")
    q = torch.from_numpy(np.asarray(jqv).copy())
    s = torch.from_numpy(np.asarray(jsv).copy())
    assert_same(tq.dequantize_int8(q, s), jq.dequantize_int8(jqv, jsv),
                "K8b flat f32")
    shape = (tx.numel() // 7, 7)
    for jdt, tdt in DTYPES.values():
        out = tq.dequantize_int8(q, s, shape=shape, dtype=tdt)
        ref = jq.dequantize_int8(jqv, jsv, shape=shape, dtype=jdt)
        assert out.dtype == tdt and tuple(out.shape) == shape
        assert_same(out, ref, f"K8b {tdt}")


@pytest.mark.parametrize("bits_", (8, 4))
@pytest.mark.parametrize("gs", (2, 256, 1000))
def test_unpack_dequant_wire_matches_pallas(gs, bits_):
    """Plain K10a against ``unpack_dequant_wire`` in interpret mode on the
    reference's wire bytes; for int4 the private plain K9b writes the same
    bytes as ``_quant_pack4_kernel``."""
    jx, tx = both(edge_batch(gs), "f32")
    jw, jsv = jq.quant_pack_wire(jx, bits_, gs)
    if bits_ == 4:
        w, s = tq._quant_pack4_reference(tx, gs)
        assert_same(w, jw, "K9b wire")
        assert_same(s, jsv, "K9b scales")
    w = torch.from_numpy(np.asarray(jw).copy())
    s = torch.from_numpy(np.asarray(jsv).copy())
    assert w.shape[1] == tq.wire_width(bits_, gs)
    shape = (tx.numel(),)
    out = tq.unpack_dequant_wire(w, s, bits_, shape=shape)
    assert_same(out, jq.unpack_dequant_wire(jw, jsv, bits_, shape=shape),
                f"K10a int{bits_}")
    assert_same(tq.unpack_dequant_wire(w, s, bits_, dtype=torch.bfloat16),
                jq.unpack_dequant_wire(jw, jsv, bits_, dtype=jnp.bfloat16),
                f"K10a int{bits_} bf16")


@pytest.mark.parametrize("dtype", ("f32", "bf16"))
@pytest.mark.parametrize("gs", (2, 64, 256, 1024))
def test_legacy_int4_matches_jax(gs, dtype):
    """The interleaved int4 pair (plain jnp in the reference, run eagerly:
    its scale is an IEEE division by 7) bit for bit, both directions."""
    jx, tx = both(edge_batch(gs), dtype)
    p, s = tq.quantize_int4(tx, gs)
    jp, js = jq.quantize_int4(jx, gs)
    assert p.shape == (jp.shape[0], gs // 2)
    assert_same(p, jp, "int4 packed")
    assert_same(s, js, "int4 scales")
    shape = (tx.numel(),)
    assert_same(tq.dequantize_int4(p, s, shape=shape),
                jq.dequantize_int4(jp, js, shape=shape), "int4 dequant")
    assert_same(tq.dequantize_int4(p, s, dtype=torch.bfloat16),
                jq.dequantize_int4(jp, js, dtype=jnp.bfloat16),
                "int4 dequant bf16")


def test_single_element_and_off_grid_tail():
    """n = 1 (one group, mostly padding) and a 3-element tail of 256."""
    for x in (np.array([0.3], np.float32),
              np.random.default_rng(3).standard_normal(515).astype(
                  np.float32)):
        jx, tx = both(x, "f32")
        q, s = tq.quantize_int8(tx)
        jqv, jsv = jq.quantize_int8(jx)
        assert q.shape == (-(-x.size // 256), 256)
        assert_same(q, jqv, "q")
        assert_same(s, jsv, "scales")
        out = tq.dequantize_int8(q, s, shape=x.shape)
        assert_same(out, jq.dequantize_int8(jqv, jsv, shape=x.shape), "dq")
    assert q.reshape(-1)[515:].abs().sum() == 0


def test_rounding_rules():
    """The scale is max|x| * fl(1/127) (not an IEEE division by 127); x /
    scale is an IEEE division, and exact ties round to even."""
    amax = np.float32(0.9)
    x = np.zeros(256, np.float32)
    x[0] = amax
    step = amax * INV127
    k = np.arange(-120, 120, 2, dtype=np.float32)[:255 // 2] + np.float32(0.5)
    x[1:1 + k.size] = k * step
    quot = x[1:1 + k.size] / step                      # IEEE, as the kernel
    ties = quot == k
    assert ties.sum() > 20
    q, s = tq.quantize_int8(torch.from_numpy(x))
    assert s.numpy().tobytes() == np.float32(amax * INV127).tobytes()
    got = q.numpy()[0, 1:1 + k.size]
    np.testing.assert_array_equal(got[ties], np.rint(k[ties]))   # to even
    assert (np.abs(got[ties]) % 2 == 0).all()


def test_dispatch_quantizer_and_wire_width():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    assert tq.get_quant_fns(8) == (tq.quantize_int8, tq.dequantize_int8)
    assert tq.get_quant_fns(4) == (tq.quantize_int4, tq.dequantize_int4)
    with pytest.raises(ValueError, match="bits"):
        tq.get_quant_fns(5)
    assert tq.wire_width(8, 256) == 256 and tq.wire_width(4, 256) == 128
    assert tq.wire_width(8, 256) == jq.wire_width(8, 256)
    assert tq.wire_width(4, 1000) == jq.wire_width(4, 1000)
    for bits_, tol in ((8, 0.01), (4, 0.2)):
        qz = tq.Quantizer(q_bits=bits_, group_size=64)
        q, s = qz.quantize(x)
        assert q.shape == (8, 64 if bits_ == 8 else 32)
        back = qz.dequantize(q, s, shape=(8, 64))
        assert back.shape == (8, 64)
        assert float((back - x).abs().max() / x.abs().max()) < tol
    with pytest.raises(ValueError):
        tq.Quantizer(q_bits=3)


def test_int4_wire_and_mean_raise_not_implemented():
    """K9b and K10b raised ``NotImplementedError`` (ROADMAP M8) until the
    quantized gradient wire was ported. Now neither raises it: on CPU
    tensors both run their plain versions and count no launch, and an
    argument they cannot take raises ``ValueError``."""
    x = torch.linspace(-1, 1, 512)
    before = (tq.quant_pack_wire.launches4, tq.unpack_dequant_mean.launches)
    w, s = tq.quant_pack_wire(x, 4)
    pw, ps = tq._quant_pack4_reference(x)
    assert w.shape == (2, 128) and torch.equal(w, pw) and torch.equal(s, ps)
    assert torch.equal(tq.quant_pack_wire_reference(x, 4)[0], w)
    mean = tq.unpack_dequant_mean(torch.stack([w, w]), torch.stack([s, s]),
                                  4, 2)
    assert_same(mean, tq.unpack_dequant_wire(w, s, 4), "K10b of equal peers")
    assert (tq.quant_pack_wire.launches4,
            tq.unpack_dequant_mean.launches) == before
    with pytest.raises(ValueError, match="even"):
        tq.quant_pack_wire(x, 4, 3)
    with pytest.raises(ValueError, match="wire"):
        tq.unpack_dequant_mean(torch.stack([w, w]), torch.stack([s, s]), 4, 3)


def test_bad_arguments_raise():
    x = torch.ones(10)
    with pytest.raises(ValueError, match="group_size"):
        tq.quantize_int8(x, 0)
    with pytest.raises(ValueError, match="empty"):
        tq.quantize_int8(torch.ones(0))
    with pytest.raises(ValueError, match="even"):
        tq.quantize_int4(x, 3)
    with pytest.raises(ValueError, match="bits"):
        tq.quant_pack_wire(x, 5)
    q, s = tq.quantize_int8(x, 4)
    with pytest.raises(ValueError, match="more than"):
        tq.dequantize_int8(q, s, shape=(13,))
    with pytest.raises(ValueError, match="bits"):
        tq.unpack_dequant_wire(q, s, 2)


def test_wrappers_refuse_a_device_they_cannot_serve():
    """A wrapper runs its plain version only for CPU tensors (counting no
    launch) and its kernel only for CUDA ones; any other device raises
    instead of being computed elsewhere."""
    launches = [f.launches for f in (tq.quantize_int8, tq.dequantize_int8,
                                     tq.quant_pack_wire,
                                     tq.unpack_dequant_wire)]
    x = torch.randn(300)
    q, s = tq.quantize_int8(x)
    tq.dequantize_int8(q, s)
    w, ws = tq.quant_pack_wire(x, 8)
    tq.unpack_dequant_wire(w, ws, 8)
    assert [f.launches for f in (tq.quantize_int8, tq.dequantize_int8,
                                 tq.quant_pack_wire,
                                 tq.unpack_dequant_wire)] == launches
    meta = torch.empty(300, device="meta")
    qm = torch.empty(2, 256, dtype=torch.int8, device="meta")
    sm = torch.empty(2, 1, device="meta")
    for call in (lambda: tq.quantize_int8(meta),
                 lambda: tq.quant_pack_wire(meta, 8),
                 lambda: tq.dequantize_int8(qm, sm),
                 lambda: tq.unpack_dequant_wire(qm, sm, 8)):
        with pytest.raises(ValueError, match="runs on CUDA or CPU tensors"):
            call()

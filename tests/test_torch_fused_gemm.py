"""The port's fused compute + collective matmuls (K11, K12) and
``runtime/comm/fused_gemm.py`` against the JAX package's, on the CPU.

  * the plain K11 (``shard_major_matmul``) and K12
    (``_gathered_dequant_matmul``) against the Pallas kernels in interpret
    mode. Tolerances: float32 sums over K in another order, |err| <=
    K·2^-23 of the sum of the products' magnitudes (``|x| @ |w|``); for
    bfloat16 outputs, one bfloat16 ulp (2^-8 relative) on top;
  * ``matmul_reduce_scatter``, ``all_gather_matmul`` (wire 0, 8 and 4),
    ``gemm_reduce_scatter``, ``gemm_all_gather_matmul`` and
    ``fused_gemm_allreduce`` on gloo worlds of 2, 3 and 4 ranks against
    the JAX functions (``impl="pallas"``: the kernels in interpret mode)
    under ``shard_map`` on n simulated CPU devices. The inputs are small
    integers, so every product and sum of the matmuls is exact in float32
    and the inputs of the exchanges are identical on both sides: those
    results are held bit for bit. The one exception is the quantized
    prologue (K12 on dequantized, non-integer weights), held within the
    float32 tolerance above;
  * the refusals: the JAX ``ValueError``s of ``matmul_reduce_scatter``,
    and ``NotImplementedError`` naming M6 (the overlap window cache,
    ``predict_fused_gemm_bytes``) and M9 (axes other than data).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.kernels import fused_collective_matmul as jfcm
from deepspeed_tpu.ops.quantizer import quantizer as jq
from deepspeed_tpu.runtime.comm import fused_gemm as jfg
from deepspeed_tpu.runtime.topology import (
    TopologyConfig,
    compat_shard_map,
    initialize_mesh,
    reset_topology,
)
from deepspeed_tpu_torch.kernels import fused_collective_matmul as tfcm
from deepspeed_tpu_torch.launcher import run_local_world
from deepspeed_tpu_torch.runtime.comm import fused_gemm as tfg
from deepspeed_tpu_torch.runtime.comm import fused_wire as tfw
from tests.test_torch_world import run_calls

pytestmark = pytest.mark.torch_port

WORLDS = (2, 3, 4)
AXES = ("data",)
M, K, N = 48, 32, 64            # M % n == 0 and (M/n)·N % 64 == 0 for n <= 4
KS = 16                         # the prologue's rows of weight per rank


def _t(a):
    return torch.from_numpy(np.array(a))


def _within(got, ref, terms, what, extra_rel=0.0):
    """|got - ref| <= k·2^-23·terms + extra_rel·|ref| elementwise."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    k = terms[1]
    limit = k * 2.0 ** -23 * terms[0] + extra_rel * np.abs(ref) + 1e-30
    worst = float((np.abs(got - ref) / limit).max())
    assert worst <= 1.0, f"{what}: error {worst:.3f} x its limit"


# --------------------------------------------------------------------- #
# K11 and K12, plain versions against interpret mode
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ("f32", "bf16"))
@pytest.mark.parametrize("n_shards", (1, 2, 4))
def test_shard_major_matmul_matches_pallas(n_shards, dtype):
    rng = np.random.default_rng(n_shards)
    x = rng.standard_normal((64, 96)).astype(np.float32)
    w = rng.standard_normal((96, 80)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    ref = jfcm.shard_major_matmul(jx, jw, n_shards, block_m=16, block_n=16)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(tdt)
    tw = _t(np.asarray(jw.astype(jnp.float32))).to(tdt)
    before = tfcm.shard_major_matmul.launches
    out = tfcm.shard_major_matmul(tx, tw, n_shards)
    assert tfcm.shard_major_matmul.launches == before      # CPU: no kernel
    assert out.dtype == tdt and tuple(out.shape) == tuple(ref.shape)
    terms = (np.abs(np.asarray(jx, np.float32)) @
             np.abs(np.asarray(jw, np.float32)), 96)
    _within(out.float().numpy(), np.asarray(ref.astype(jnp.float32)), terms,
            f"K11 {dtype}", extra_rel=2.0 ** -8 if dtype == "bf16" else 0.0)


@pytest.mark.parametrize("bits_", (8, 4))
@pytest.mark.parametrize("n", (2, 3))
def test_gathered_dequant_matmul_matches_pallas(n, bits_):
    """Plain K12 against the interpret-mode kernel on the reference's own
    wire bytes; a shard's weight off the group grid (k·N % 256 != 0)."""
    rng = np.random.default_rng(10 * n + bits_)
    k, n_cols, rows = 24, 40, 36
    x = rng.standard_normal((rows, n * k)).astype(np.float32)
    wires = [jq.quant_pack_wire(jnp.asarray(
        rng.standard_normal(k * n_cols).astype(np.float32)), bits_, 256)
        for _ in range(n)]
    jw = jnp.stack([a for a, _ in wires])
    js = jnp.stack([b for _, b in wires])
    ref = jfcm._gathered_dequant_matmul(jnp.asarray(x), jw, js, bits_, k,
                                        n_cols, jnp.float32)
    out = tfcm._gathered_dequant_matmul(_t(x), _t(jw), _t(js), bits_, k,
                                        n_cols, torch.float32)
    w_abs = sum(np.abs(np.asarray(jfcm.unpack_dequant_wire_values(
        jw[r], js[r], bits_)).reshape(-1)[:k * n_cols].reshape(k, n_cols))
        for r in range(n))
    _within(out.numpy(), np.asarray(ref), (np.abs(x).max() * w_abs.sum(0),
                                           n * k), f"K12 n={n} int{bits_}")
    vals = tfcm.unpack_dequant_wire_values(_t(jw[0]), _t(js[0]), bits_)
    np.testing.assert_array_equal(
        vals.numpy(), np.asarray(jfcm.unpack_dequant_wire_values(
            jw[0], js[0], bits_)))


def test_largest_divisor_and_costs_match_jax():
    for n, cap in ((96, 256), (100, 7), (13, 4), (4096, 512)):
        assert tfcm._largest_divisor(n, cap) == jfcm._largest_divisor(n, cap)
    assert tfcm.matmul_costs(64, 32, 16, 2) == jfcm.matmul_costs(64, 32, 16,
                                                                 2)


# --------------------------------------------------------------------- #
# The fused edges on gloo worlds against the JAX functions
# --------------------------------------------------------------------- #
def _cases(n):
    rng = np.random.default_rng(200 + n)

    def ints(*shape):
        return rng.integers(-3, 4, shape).astype(np.float32)

    w = np.stack([ints(K, N)] * n)                 # replicated weight
    x = ints(n, M, K)
    xp = ints(n, 24, n * KS)
    ws = ints(n, KS, N)
    g = ints(n, 37, 29)
    out = []
    for bits_ in (0, 8, 4):
        out.append(dict(name=f"mrs-int{bits_}",
                        fn="kernels.fused_collective_matmul:"
                           "matmul_reduce_scatter",
                        jfn=jfcm.matmul_reduce_scatter, args=[x, w],
                        kw=dict(wire_bits=bits_, group_size=64),
                        jkw=dict(wire_bits=bits_, group_size=64,
                                 impl="pallas"), exact=True))
        out.append(dict(name=f"agm-int{bits_}",
                        fn="kernels.fused_collective_matmul:all_gather_matmul",
                        jfn=jfcm.all_gather_matmul, args=[xp, ws],
                        kw=dict(wire_bits=bits_, group_size=64),
                        jkw=dict(wire_bits=bits_, group_size=64,
                                 impl="pallas"), exact=bits_ == 0))
    for bits_ in (0, 4):
        out.append(dict(name=f"fgar-int{bits_}",
                        fn="runtime.comm.fused_gemm:fused_gemm_allreduce",
                        jfn=jfg.fused_gemm_allreduce, args=[g],
                        kw=dict(wire_bits=bits_, group_size=64),
                        jkw=dict(wire_bits=bits_, group_size=64),
                        exact=True))
    out.append(dict(name="gemm-rs-int4",
                    fn="runtime.comm.fused_gemm:gemm_reduce_scatter",
                    jfn=jfg.gemm_reduce_scatter, args=[x, w],
                    kw=dict(wire_bits=4, group_size=64),
                    jkw=dict(wire_bits=4, group_size=64, impl="pallas"),
                    exact=True))
    out.append(dict(name="gemm-agm-int8",
                    fn="runtime.comm.fused_gemm:gemm_all_gather_matmul",
                    jfn=jfg.gemm_all_gather_matmul, args=[xp, ws],
                    kw=dict(wire_bits=8, group_size=64),
                    jkw=dict(wire_bits=8, group_size=64, impl="pallas"),
                    exact=False))
    return out


def _shard_mapped(topo, c):
    def body(*xs):
        return c["jfn"](*[a[0] for a in xs], AXES, **c["jkw"])[None]

    return jax.jit(compat_shard_map(
        body, topo.mesh, in_specs=(P("data"),) * len(c["args"]),
        out_specs=P("data"), manual_axes={"data"}))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request, tmp_path_factory):
    """One gloo world of n for the module, and the JAX outputs on n
    simulated devices."""
    n = request.param
    cases = _cases(n)
    calls = [(c["fn"], c["args"], dict(c["kw"], axes=AXES), {})
             for c in cases]
    pool = ThreadPoolExecutor(1)
    port = pool.submit(run_local_world, run_calls, n, (calls,),
                       store_dir=str(tmp_path_factory.mktemp("world")))
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:n],
                           force=True)
    try:
        ref = [np.asarray(_shard_mapped(topo, c)(
            *[jnp.asarray(a) for a in c["args"]])) for c in cases]
    finally:
        reset_topology()
        pool.shutdown(wait=True)
    return n, cases, port.result(), ref


def test_fused_edges_match_jax(world):
    """Each rank's result against the JAX function's at its data index:
    bit for bit where the matmul is exact; the quantized prologue within
    the float32 tolerance of its sums."""
    n, cases, port, ref = world
    for i, c in enumerate(cases):
        for r in range(n):
            got, record = port[r][i]
            want = ref[i][r]
            assert got.shape == want.shape and got.dtype == want.dtype, \
                (c["name"], got.shape, want.shape)
            if c["exact"]:
                assert got.tobytes() == want.tobytes(), (c["name"], r)
            else:
                xs = c["args"][0][r]
                _within(got, want, (np.abs(xs).sum(1, keepdims=True)
                                    * np.abs(want).max() + 1.0,
                                    xs.shape[1]), f"{c['name']} rank {r}")


def test_quantized_edges_put_int8_on_the_wire(world):
    """The quantized edges' payload collectives carry int8; the full-
    precision edges carry float32."""
    n, cases, port, _ = world
    for i, c in enumerate(cases):
        ops = {(e["op"], e["dtype"]) for e in port[0][i][1]}
        if c["name"].endswith("int0"):
            assert all(dt == "float32" for _, dt in ops), c["name"]
        elif c["name"].startswith(("mrs", "gemm-rs", "fgar")):
            assert ("all_to_all_single", "int8") in ops, c["name"]
        else:
            assert ("all_gather_into_tensor", "int8") in ops, c["name"]


# --------------------------------------------------------------------- #
# Refusals
# --------------------------------------------------------------------- #
def test_refusals_match_jax_and_name_their_items():
    x = torch.ones(5, 8)
    w = torch.ones(8, 64)
    with pytest.raises(ValueError, match="not divisible"):
        tfcm.matmul_reduce_scatter(x, w, AXES, n=2)
    with pytest.raises(ValueError, match="not divisible"):
        tfcm.shard_major_matmul(x, w, 2)
    with pytest.raises(ValueError, match="group_size"):
        tfcm.matmul_reduce_scatter(torch.ones(2, 8), torch.ones(8, 8), AXES,
                                   wire_bits=8, n=2)
    with pytest.raises(ValueError, match="not divisible"):
        jfcm.matmul_reduce_scatter(jnp.ones((5, 8)), jnp.ones((8, 64)), AXES,
                                   n=2)
    with pytest.raises(NotImplementedError, match="M6"):
        tfg.gemm_all_gather_matmul(x, w, AXES, window_cache=object(),
                                   gather_fn=lambda p: p)
    with pytest.raises(NotImplementedError, match="M6"):
        tfg.predict_fused_gemm_bytes(1 << 20, "int8", 2)
    with pytest.raises(NotImplementedError, match="M9"):
        tfw.group_count(("tensor",))
    assert tfg.FUSED_GEMM == jfg.FUSED_GEMM


def test_a_world_of_one_is_the_plain_matmul():
    """At n = 1 the edges are K11 alone (the JAX ``shard_major_matmul(x,
    w, 1)``), and the leaf seam returns its input."""
    rng = np.random.default_rng(7)
    x = _t(rng.integers(-3, 4, (8, 16)).astype(np.float32))
    w = _t(rng.integers(-3, 4, (16, 24)).astype(np.float32))
    ref = x @ w
    for out in (tfcm.matmul_reduce_scatter(x, w, ()),
                tfcm.all_gather_matmul(x, w, ()),
                tfg.gemm_reduce_scatter(x, w, AXES),
                tfg.gemm_all_gather_matmul(x, w, AXES, wire_bits=8)):
        assert torch.equal(out, ref)
    g = torch.randn(3, 5)
    assert tfg.fused_gemm_allreduce(g, AXES, wire_bits=4) is g


@pytest.mark.parametrize("K,N", ((72, 45), (61, 80), (13, 7)))
def test_padded_matmul_operands_match_unpadded_and_pallas(K, N):
    """``padded_matmul_operands`` (what K11's CUDA path calls: K and N
    zero-padded to multiples of 8) with the product sliced back to N,
    against the unpadded plain version (bit for bit: the padded K adds +0
    products) and the JAX ``shard_major_matmul`` in interpret mode."""
    rng = np.random.default_rng(K + N)
    x = rng.standard_normal((32, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    tx, tw = _t(x), _t(w)
    xp, wp, n = tfcm.padded_matmul_operands(tx, tw)
    assert n == N and xp.shape[1] % 8 == 0 and wp.shape == (xp.shape[1],
                                                            -(-N // 8) * 8)
    out = tfcm.matmul_reference(xp, wp)[:, :N]
    unpadded = tfcm.matmul_reference(tx, tw)
    np.testing.assert_allclose(out.numpy(), unpadded.numpy(), rtol=1e-6,
                               atol=1e-5)
    ref = jfcm.shard_major_matmul(jnp.asarray(x), jnp.asarray(w), 2,
                                  block_m=16, block_n=16)
    terms = (np.abs(x) @ np.abs(w), K)
    _within(out.numpy(), np.asarray(ref), terms, "K11 padded")


# --------------------------------------------------------------------- #
# K12's walk and staging (csrc/collective_matmul.cu), emulated
# --------------------------------------------------------------------- #
K12_TILE, K12_STAGE, K12_RUN = 128, 16, 8    # gd::kBN, gd::kBK, a run


def _biased(u):
    """uint8 values b → float32 2^23 + b, built from bits as the kernel's
    byte permute builds them (0x4B000000 | b)."""
    return (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)


def _k12_stage_weight(wire, scales, bits, gs, k, N, shard_offset):
    """One shard's weight [k, N] as the kernel stages it from its wire
    (``wire`` int8 [groups, W] flat in memory at byte ``shard_offset`` of
    the stacked wires, ``scales`` [groups, 1]): each thread's run of 8
    columns of a row (tile columns n0 + 8j) finds its group with one
    division; a run inside one group (int4: one half of it) whose bytes
    start 8-byte aligned is read as 8 bytes and turned to floats as
    2^23 + (b ^ 0x80) − (2^23 + 128) (int8) or 2^23 + (nibble ^ 8) −
    (2^23 + 8) (int4), times the flushed scale; any other run element by
    element. → (weight, fast runs, element-wise runs)."""
    flat = wire.reshape(-1)
    W = wire.shape[1]
    half = gs // 2
    s = scales.reshape(-1).astype(np.float32)
    s = np.where(np.abs(s) < np.float32(1.17549435e-38), np.float32(0), s)
    out = np.zeros((k, N), np.float32)
    fast = slow = 0
    for kk in range(k):
        for c0 in range(0, -(-N // K12_TILE) * K12_TILE, K12_RUN):
            if c0 >= N:
                continue
            e0 = kk * N + c0
            g, p0 = divmod(e0, gs)
            mode, off = 0, None
            if c0 + K12_RUN <= N:
                if bits == 8 and p0 + 8 <= gs:
                    mode, off = 1, g * W + p0
                elif bits == 4 and p0 + 8 <= half:
                    mode, off = 1, g * W + p0
                elif bits == 4 and p0 >= half and p0 + 8 <= gs:
                    mode, off = 2, g * W + p0 - half
            if mode and (shard_offset + off) % 8 == 0:
                b = flat[off:off + 8].view(np.uint8)
                if bits == 8:
                    q = _biased(b ^ np.uint8(0x80)) - np.float32(8388736.0)
                else:
                    nib = (b >> 4) if mode == 2 else (b & np.uint8(0xF))
                    q = _biased(nib ^ np.uint8(8)) - np.float32(8388616.0)
                out[kk, c0:c0 + 8] = q * s[g]
                fast += 1
                continue
            slow += 1
            for c in range(c0, min(c0 + K12_RUN, N)):
                gg, p = divmod(kk * N + c, gs)
                if bits == 8:
                    qv = int(flat[gg * W + p])
                elif p < half:
                    qv = (int(flat[gg * W + p]) << 28 & 0xFFFFFFFF)
                    qv = (qv ^ 0x80000000) - 0x80000000 >> 28
                else:
                    qv = int(flat[gg * W + p - half]) >> 4
                out[kk, c] = np.float32(qv) * s[gg]
    return out, fast, slow


def _k12_walk(x, weights, k):
    """out as the kernel sums it: per shard, its k in 16-deep stages, each
    element's sum in k order (float32; the card fuses each product into
    its sum), then out = 0 + shard 0's sum, out += each next shard's, in
    shard order (the running sum lives in out)."""
    out = None
    for r, w in enumerate(weights):
        xr = x[:, r * k:(r + 1) * k]
        part = np.zeros((x.shape[0], w.shape[1]), np.float32)
        for k0 in range(0, -(-k // K12_STAGE) * K12_STAGE, K12_STAGE):
            for kk in range(k0, min(k0 + K12_STAGE, k)):
                part = part + np.outer(xr[:, kk], w[kk]).astype(np.float32)
        out = np.float32(0) + part if out is None else out + part
    return out


@pytest.mark.parametrize("x_dtype", ("f32", "bf16"))
@pytest.mark.parametrize("bits_,gs,k,n_cols,n", (
    (4, 200, 100, 136, 3),      # rows straddle groups; int4 halves of 100
    (8, 200, 100, 136, 3),
    (4, 256, 100, 136, 2),      # k·N off the group grid
    (8, 256, 72, 203, 3),       # N odd: runs off 8-byte alignment
    (4, 200, 72, 203, 2),
    (8, 256, 24, 40, 2),
))
def test_k12_walk_and_staging_emulation(bits_, gs, k, n_cols, n, x_dtype):
    """K12's staging of the wire (``_k12_stage_weight``: the run-wise
    group lookup and byte-to-float conversion, element by element where
    a run crosses a group, an int4 half or 8-byte alignment) equals the
    JAX ``unpack_dequant_wire_values`` bit for bit, and its walk
    (``_k12_walk``) stays within n·k·2^-23 of the terms (|x| @ |W|) of
    the JAX ``_gathered_dequant_matmul`` in interpret mode; x float32 or
    bf16 values (the kernel widens bf16 exactly)."""
    rng = np.random.default_rng(1000 * bits_ + gs + k + n_cols + n)
    rows = 150                                  # off the 128-row tile
    x = rng.standard_normal((rows, n * k)).astype(np.float32)
    if x_dtype == "bf16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    wires = [jq.quant_pack_wire(jnp.asarray(
        rng.standard_normal(k * n_cols).astype(np.float32)), bits_, gs)
        for _ in range(n)]
    jw = jnp.stack([a for a, _ in wires])
    js = jnp.stack([b for _, b in wires])
    weights, fast, slow = [], 0, 0
    for r in range(n):
        w_r, f, s_ = _k12_stage_weight(
            np.asarray(jw[r]), np.asarray(js[r]), bits_, gs, k, n_cols,
            r * jw.shape[1] * jw.shape[2])
        want = np.asarray(jfcm.unpack_dequant_wire_values(
            jw[r], js[r], bits_)).reshape(-1)[:k * n_cols].reshape(k, n_cols)
        np.testing.assert_array_equal(w_r.view(np.uint32),
                                      want.view(np.uint32))
        weights.append(w_r)
        fast, slow = fast + f, slow + s_
    # runs cross int4 halves of 100 and rows of odd N, and only those
    assert fast > 0
    assert (slow > 0) == ((bits_ == 4 and gs // 2 % 8 != 0)
                          or n_cols % 8 != 0)
    got = _k12_walk(x, weights, k)
    ref = jfcm._gathered_dequant_matmul(jnp.asarray(x), jw, js, bits_, k,
                                        n_cols, jnp.float32)
    terms = np.abs(x).astype(np.float64) @ np.abs(
        np.concatenate(weights)).astype(np.float64)
    limit = n * k * 2.0 ** -23 * terms + 1e-30
    worst = float((np.abs(got.astype(np.float64) - np.asarray(ref))
                   / limit).max())
    assert worst <= 1.0, f"K12 walk: {worst:.3f} x n·k·2^-23 of the terms"

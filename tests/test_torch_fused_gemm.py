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

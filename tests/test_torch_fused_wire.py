"""The port's quantized gradient wire (qgZ) against the JAX package's, on
the CPU.

  * the plain K9b (``quant_pack_wire(bits=4)``) and K10b
    (``unpack_dequant_mean``) against the Pallas kernels in interpret mode,
    byte for byte and bit for bit, on edge batches (a zero group,
    half-step ties, subnormals, a NaN and an infinity group, a tail off
    the group grid), K10b at n = 2, 3 and 4 peers; LoCo's residual
    (``wire_residual``, K10a's variant) against the reference's jitted
    ``x - unpack_dequant_wire(w, s)``, bit for bit;
  * ``fused_wire``'s three functions and ``comm_path.quantized_allreduce``
    (fused and legacy, int8 and int4, with and without LoCo) on gloo
    worlds of 2, 3 and 4 ranks against the JAX functions under
    ``shard_map`` on the first n of the 8 simulated CPU devices, on the
    same per-rank inputs: bit for bit, outputs and LoCo residuals, with
    leaves smaller than n·group_size and off its grid (padding);
  * the facade's record: int8 wire bytes on the all-to-all and the
    all-gather, float32 only in the scale sidecars.

Tolerance zero throughout: the same bytes leave the quantizer on both
sides, and the peers' mean is computed in the same order
(``unpack_dequant_mean``'s documented rule).
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from deepspeed_tpu.ops.quantizer import quantizer as jq
from deepspeed_tpu.runtime import comm_path as jcp
from deepspeed_tpu.runtime.comm import fused_wire as jfw
from deepspeed_tpu.runtime.topology import (
    TopologyConfig,
    compat_shard_map,
    initialize_mesh,
    reset_topology,
)
from deepspeed_tpu_torch.launcher import run_local_world
from deepspeed_tpu_torch.ops.quantizer import quantizer as tq
from deepspeed_tpu_torch.runtime.comm_path import loco_partition_size
from tests.test_torch_quantizer import assert_same, both, edge_batch
from tests.test_torch_world import run_calls

pytestmark = pytest.mark.torch_port

WORLDS = (2, 3, 4)
AXES = ("data",)
SHAPES = ((37, 29), (100,))                  # off the grid, < n·G


# --------------------------------------------------------------------- #
# K9b and K10b
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", ("f32", "bf16", "f16"))
@pytest.mark.parametrize("gs", (2, 64, 256, 1000, 1024))
def test_int4_wire_quantize_matches_pallas(gs, dtype):
    """Plain K9b against ``quant_pack_wire(bits=4)`` in interpret mode:
    identical wire bytes and scale bits; the edge groups follow the
    rules (zero and subnormal: scale 1, NaN: scale NaN, inf: scale inf,
    every nibble 0 in those groups)."""
    jx, tx = both(edge_batch(gs), dtype)
    w, s = tq.quant_pack_wire(tx, 4, gs)
    jw, js = jq.quant_pack_wire(jx, 4, gs)
    assert w.shape == (jw.shape[0], gs // 2)
    assert_same(w, jw, "K9b wire")
    assert_same(s, js, "K9b scales")
    s = s[:, 0]
    assert s[1] == 1.0 and s[3] == 1.0 and not w[1].any() and not w[3].any()
    assert torch.isnan(s[4]) and torch.isinf(s[5])
    assert not w[4].any() and not w[5].any()


@pytest.mark.parametrize("bits_", (4, 8))
@pytest.mark.parametrize("gs", (2, 64, 256, 1000))
@pytest.mark.parametrize("n", (2, 3, 4))
def test_unpack_dequant_mean_matches_pallas(n, gs, bits_):
    """Plain K10b against ``unpack_dequant_mean`` in interpret mode on n
    peers' edge-batch wires (the reference's own bytes), bit for bit: the
    peers summed in order with each product fused into its add, then the
    multiply by fl(1/n)."""
    wires = [jq.quant_pack_wire(both(edge_batch(gs, seed=r) * (r + 1),
                                     "f32")[0], bits_, gs)
             for r in range(n)]
    jw = jnp.stack([w for w, _ in wires])
    js = jnp.stack([s for _, s in wires])
    ref = jq.unpack_dequant_mean(jw, js, bits_, n)
    out = tq.unpack_dequant_mean(torch.from_numpy(np.asarray(jw).copy()),
                                 torch.from_numpy(np.asarray(js).copy()),
                                 bits_, n)
    assert out.shape == ref.shape
    assert_same(out, ref, f"K10b n={n} int{bits_}")


@pytest.mark.parametrize("bits_", (4, 8))
@pytest.mark.parametrize("gs", (2, 64, 256, 1000))
def test_wire_residual_matches_jitted_reference(gs, bits_):
    """Plain LoCo residual (``wire_residual``) against the reference's
    ``x - unpack_dequant_wire(w, s)`` under ``jit`` (the Pallas kernels in
    interpret mode, as ``fused_quantized_allreduce`` computes it), bit for
    bit: on a group of ordinary values with subnormals among them, whose
    residuals the reference flushes to zero where ``x`` alone would keep
    them, then the edge batch zero-padded to the group grid."""
    rng = np.random.default_rng(7 + gs)
    mixed = rng.standard_normal(gs).astype(np.float32)
    mixed[::2] = np.float32(2e-39)
    x = np.concatenate([mixed, edge_batch(gs)])
    x = np.concatenate([x, np.zeros((-x.size) % gs, np.float32)])

    @jax.jit
    def ref(x):
        w, s = jq.quant_pack_wire(x, bits_, gs)
        return w, s, x - jq.unpack_dequant_wire(w, s, bits_)

    jw, js, jr = ref(jnp.asarray(x))
    before = tq.wire_residual.launches
    got = tq.wire_residual(torch.from_numpy(x),
                           torch.from_numpy(np.asarray(jw).copy()),
                           torch.from_numpy(np.asarray(js).copy()), bits_)
    assert got.shape == (x.size,) and tq.wire_residual.launches == before
    assert_same(got, jr, f"residual int{bits_}")
    assert not got[:gs:2].any()                    # the subnormals flushed


def test_wire_residual_refuses_what_it_cannot_serve():
    """The residual's wrapper runs its kernel only for CUDA tensors: any
    other device raises instead of being computed elsewhere, as do a bit
    width other than 4 or 8 and an ``x`` that is not the wire's padded
    length."""
    qm = torch.empty(2, 128, dtype=torch.int8, device="meta")
    sm = torch.empty(2, 1, device="meta")
    with pytest.raises(ValueError, match="runs on CUDA or CPU tensors"):
        tq.wire_residual(torch.empty(512, device="meta"), qm, sm, 4)
    w, s = tq.quant_pack_wire(torch.randn(512), 4)
    with pytest.raises(ValueError, match="bits"):
        tq.wire_residual(torch.randn(512), w, s, 2)
    with pytest.raises(ValueError, match="512 values"):
        tq.wire_residual(torch.randn(500), w, s, 4)


def test_fma_rounds_once():
    """``_fma`` is a correctly rounded fmaf: against float64 arithmetic on
    cases where a separate product and sum round differently."""
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, 20000).astype(np.int8)
    s = rng.random(20000).astype(np.float32) * np.float32(3e-3)
    c = (rng.standard_normal(20000) * 0.3).astype(np.float32)
    got = tq._fma(torch.from_numpy(q), torch.from_numpy(s),
                  torch.from_numpy(c)).numpy()
    exact = q.astype(np.float64) * s.astype(np.float64) + c
    # the exact sum fits in float64 here, so one rounding of it is the fma
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    two = (q.astype(np.float32) * s + c).astype(np.float32)
    assert (got != two).sum() > 0          # the cases do tell them apart


# --------------------------------------------------------------------- #
# The wire on gloo worlds against the JAX functions under shard_map
# --------------------------------------------------------------------- #
def _cases(n):
    """The world's cases: dicts of ``name``, the port's ``fn``, the JAX
    ``jfn``, per-rank positional ``args`` and keyword ``rank_kw`` arrays,
    ``kw`` (port) and ``jkw`` (JAX), and ``n_out`` outputs."""
    rng = np.random.default_rng(100 + n)
    out = []

    def per_rank(shape, scale=1.0):
        mags = np.float32(scale) * (1 + np.arange(n, dtype=np.float32))
        return (rng.standard_normal((n,) + shape).astype(np.float32)
                * mags.reshape((n,) + (1,) * len(shape)))

    def case(name, fn, jfn, args, kw, jkw=None, rank_kw=None, n_out=1):
        out.append(dict(name=name, fn=fn, jfn=jfn, args=args, kw=kw,
                        jkw=kw if jkw is None else jkw,
                        rank_kw=rank_kw or {}, n_out=n_out))

    for shape in SHAPES:
        for bits_ in (4, 8):
            g = per_rank(shape)
            sent = bits_ == 4
            case(f"rs{shape}-int{bits_}-sent{sent}",
                 "runtime.comm.fused_wire:fused_quantized_reduce_scatter",
                 jfw.fused_quantized_reduce_scatter, [g],
                 dict(bits=bits_, group_size=64, return_sent=sent),
                 n_out=2 if sent else 1)
            tdt, jdt = ((torch.bfloat16, jnp.bfloat16) if bits_ == 4
                        else (torch.float32, jnp.float32))
            case(f"ag{shape}-int{bits_}-{tdt}",
                 "runtime.comm.fused_wire:fused_quantized_all_gather",
                 jfw.fused_quantized_all_gather, [g],
                 dict(bits=bits_, group_size=64, out_dtype=tdt),
                 dict(bits=bits_, group_size=64, out_dtype=jdt))
            per = loco_partition_size(int(np.prod(shape)), n, 64)
            errs = {"error": per_rank(shape, 0.01),
                    "server_error": per_rank((per,), 0.01)}
            for fused in (True, False):
                for loco in (False, True):
                    case(f"qar{shape}-int{bits_}-fused{fused}-loco{loco}",
                         "runtime.comm_path:quantized_allreduce",
                         jcp.quantized_allreduce, [g],
                         dict(bits=bits_, group_size=64, fused=fused),
                         rank_kw=errs if loco else None,
                         n_out=3 if loco else 1)
    # an edge batch (NaN, inf, zero, subnormal groups) through the wire
    case("qar-edge-int4", "runtime.comm.fused_wire:fused_quantized_allreduce",
         jfw.fused_quantized_allreduce,
         [np.stack([edge_batch(64, seed=r) for r in range(n)])],
         dict(bits=4, group_size=64))
    return out


def _shard_mapped(topo, c):
    """The JAX function of case ``c`` under ``shard_map`` over the data
    axis: each device's row in, each output with a leading row out."""
    names = list(c["rank_kw"])

    def body(*xs):
        res = c["jfn"](xs[0][0], AXES, **c["jkw"],
                       **{k: x[0] for k, x in zip(names, xs[1:])})
        if not isinstance(res, tuple):
            res = (res,)
        res = tuple(r[None] for r in res if r is not None)
        return res if c["n_out"] > 1 else res[0]

    n_in = 1 + len(names)
    spec = P("data") if c["n_out"] == 1 else (P("data"),) * c["n_out"]
    return jax.jit(compat_shard_map(body, topo.mesh,
                                    in_specs=(P("data"),) * n_in,
                                    out_specs=spec, manual_axes={"data"}))


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"world{n}")
def world(request, tmp_path_factory):
    """One gloo world of n for the module: every case's port outputs and
    records, and the JAX outputs on n simulated devices."""
    n = request.param
    cases = _cases(n)
    calls = [(c["fn"], c["args"], dict(c["kw"], axes=AXES), c["rank_kw"])
             for c in cases]
    # the port's world runs in its own processes while JAX compiles here
    pool = ThreadPoolExecutor(1)
    port = pool.submit(run_local_world, run_calls, n, (calls,),
                       store_dir=str(tmp_path_factory.mktemp("world")))
    topo = initialize_mesh(TopologyConfig(), devices=jax.devices()[:n],
                           force=True)
    try:
        ref = []
        for c in cases:
            res = _shard_mapped(topo, c)(
                *[jnp.asarray(a) for a in c["args"]],
                *[jnp.asarray(a) for a in c["rank_kw"].values()])
            ref.append(tuple(np.asarray(r).astype(np.float32)
                             if r.dtype == jnp.bfloat16 else np.asarray(r)
                             for r in (res if c["n_out"] > 1 else (res,))))
    finally:
        reset_topology()
        pool.shutdown(wait=True)
    return n, cases, port.result(), ref


def _outputs(port, r, i):
    """Case i's outputs on rank r, the absent LoCo residuals dropped."""
    out, _ = port[r][i]
    if not isinstance(out, tuple):
        return (out,)
    return tuple(o for o in out if o is not None)


def test_wire_matches_jax_bit_for_bit(world):
    """Every case, each rank's outputs against the JAX function's at its
    data index, bit for bit (bfloat16 outputs compared as their exact
    float32 values)."""
    n, cases, port, ref = world
    for i, c in enumerate(cases):
        for r in range(n):
            got = _outputs(port, r, i)
            assert len(got) == c["n_out"], c["name"]
            for k, (g, want) in enumerate(zip(got, ref[i])):
                want = want[r]
                assert g.shape == want.shape and g.dtype == want.dtype, \
                    (c["name"], k, g.shape, want.shape, g.dtype, want.dtype)
                assert_same(torch.from_numpy(np.ascontiguousarray(g)), want,
                            f"{c['name']} rank {r} output {k}")


def test_every_rank_gets_the_same_mean(world):
    """Stage 2's all-gather hands every rank the same bytes: the
    allreduced leaf is bit-identical across ranks."""
    n, cases, port, _ = world
    for i, c in enumerate(cases):
        if c["name"].startswith("qar"):
            first = _outputs(port, 0, i)[0].tobytes()
            for r in range(1, n):
                assert _outputs(port, r, i)[0].tobytes() == first, c["name"]


def test_wire_is_int8_in_the_record(world):
    """qgZ's collectives carry int8 wire bytes; float32 rides only as the
    scale sidecar (one float per group), never as a payload."""
    n, cases, port, _ = world
    for i, c in enumerate(cases):
        if not c["name"].startswith(("qar", "rs")):
            continue
        record = port[0][i][1]
        ops = [(e["op"], e["dtype"]) for e in record]
        assert ("all_to_all_single", "int8") in ops, c["name"]
        if c["name"].startswith("qar"):
            assert ("all_gather_into_tensor", "int8") in ops, c["name"]
        int8 = max(e["bytes"] for e in record if e["dtype"] == "int8")
        for e in record:
            if e["dtype"] != "int8":
                assert e["dtype"] == "float32" and e["bytes"] * 8 <= int8, \
                    (c["name"], e)

"""The port's weight-only quantization API and KV shipping against the JAX
package's, on the CPU in float32.

Quantization (``inference/quantization``): on ``TransformerConfig.tiny``
converted from the JAX params, ``quantize_params`` picks the same leaves
with the same meta and the same bytes (int8 through the plain K8a, int4
through the legacy pair), ``dequantize_params`` gives the same bits, and
``quantized_memory_bytes`` the same count; a JAX quantized tree converted
to tensors dequantizes in the port to the JAX package's values. The three
checks of the JAX package's own weight-only tests are mirrored.

KV shipping (``inference/v2/kv_ship``): DSKV1 frames built from the same
rows are byte-identical between the packages and each decodes the
other's; ``export_kv`` rows match the JAX engine's within 1e-5 (two
frameworks' float32 forwards over two layers); an fp32-shipped prefix
continues with the greedy tokens of an uninterrupted run and of the JAX
engine's own continuation, into pages of 8 and 16 tokens; the int8 wire
continues as the fp32 one does and stays within half a quantization step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jquant
from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine
from deepspeed_tpu.inference.v2 import kv_ship as jship
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch import (
    CausalLM,
    InferenceEngineV2,
    RaggedInferenceEngineConfig,
    TransformerConfig,
)
from deepspeed_tpu_torch.inference import quantization as tquant
from deepspeed_tpu_torch.inference.v2 import kv_ship as tship
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                qparams_from_numpy)
from deepspeed_tpu_torch.models.transformer import forward
from deepspeed_tpu_torch.ops.quantizer import quantizer as tq

pytestmark = pytest.mark.torch_port

PROMPT = [3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 6]
ENGINE = dict(max_tokens=32, max_seqs=4, max_ctx=64)
STEPS = 6


@pytest.fixture(scope="module")
def weights():
    cfg = jax_tf.TransformerConfig.tiny()
    params = jax_tf.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and "__q__" not in v:
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        x = x.view({1: torch.int8, 2: torch.int16, 4: torch.int32}[
            x.element_size()]).numpy()
    return np.ascontiguousarray(np.asarray(x)).tobytes()


# --------------------------------------------------------------------- #
# Weight-only quantization
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_q8(weights):
    """The JAX package's int8 tree of the tiny model (group 64, leaves of
    1024+ elements), and its dequantized float32 params."""
    _, params, _ = weights
    qp, meta = jquant.quantize_params(params, group_size=64, min_size=1024)
    return qp, meta, jquant.dequantize_params(qp, dtype=jnp.float32)


def _port_state(weights):
    cfg = TransformerConfig.tiny()
    return params_from_numpy(weights[2], cfg)


@pytest.mark.parametrize("bits,group_size,min_size",
                         [(8, 64, 1024), (4, 64, 1024), (4, 256, 1 << 14)])
def test_quantize_params_matches_jax(weights, jax_q8, bits, group_size,
                                     min_size):
    """Same quantized-leaf set, meta, q and scale bytes, shapes and dtype
    names; dequantize_params bit for bit; the same byte count."""
    _, params, _ = weights
    if bits == 8:
        jqp, jmeta, jdq = jax_q8
    else:
        jqp, jmeta = jquant.quantize_params(params, group_size=group_size,
                                            min_size=min_size, bits=bits)
        jdq = jquant.dequantize_params(jqp, dtype=jnp.float32)
    qp, meta = tquant.quantize_params(_port_state(weights),
                                      group_size=group_size,
                                      min_size=min_size, bits=bits)
    assert meta == jmeta
    jflat = _flat(jqp)
    assert set(qp) == set(jflat)
    quantized = {k for k, v in qp.items() if isinstance(v, dict)}
    assert quantized == {k for k, v in jflat.items() if isinstance(v, dict)}
    assert len(quantized) == meta["quantized_leaves"] > 0
    for name in quantized:
        node, jnode = qp[name], jflat[name]
        assert _bits(node["__q__"]) == _bits(jnode["__q__"]), name
        assert _bits(node["__scale__"]) == _bits(jnode["__scale__"]), name
        assert node["__shape__"] == jnode["__shape__"]
        assert node["__dtype__"] == jnode["__dtype__"] == "float32"
        assert node["__bits__"] == jnode["__bits__"] == bits
    dq = tquant.dequantize_params(qp, dtype=torch.float32)
    for name, val in _flat(jdq).items():
        assert _bits(dq[name]) == _bits(val), name
    assert tquant.quantized_memory_bytes(qp) == \
        jquant.quantized_memory_bytes(jqp)


def test_jax_quantized_tree_dequantizes_in_the_port(jax_q8):
    """A JAX int8 tree, turned into numpy and then tensors leaf by leaf,
    gives the JAX package's dequantized values (float32 and bfloat16)."""
    jqp, _, jdq = jax_q8
    tree = qparams_from_numpy(jax.tree.map(np.asarray, jqp))
    node = tree["layers.q_proj.kernel"]
    assert node["__dtype__"] == "float32" and node["__bits__"] == 8
    assert isinstance(node["__shape__"], tuple)
    dq = tquant.dequantize_params(tree, dtype=torch.float32)
    for name, val in _flat(jdq).items():
        assert _bits(dq[name]) == _bits(val), name
    jbf = jquant.dequantize_params(jqp, dtype=jnp.bfloat16)
    bf = tquant.dequantize_params(tree, dtype=torch.bfloat16)
    for name, val in _flat(jbf).items():
        if isinstance(tree[name], dict):
            assert bf[name].dtype == torch.bfloat16
        assert _bits(bf[name]) == _bits(val), name
    assert tquant.quantized_memory_bytes(tree) == \
        jquant.quantized_memory_bytes(jqp)


def test_int4_halves_int8_weight_bytes():
    """Mirror of the JAX package's test: int4 stores packed nibble pairs,
    under 0.6x the int8 bytes; both dequantize close to the weights."""
    rng = np.random.default_rng(0)
    params = {"w": torch.from_numpy(
        rng.normal(size=(256, 128)).astype(np.float32))}
    q8, m8 = tquant.quantize_params(params, min_size=1024, bits=8)
    q4, m4 = tquant.quantize_params(params, min_size=1024, bits=4)
    assert m8["bits"] == 8 and m4["bits"] == 4
    assert tquant.quantized_memory_bytes(q4) < \
        tquant.quantized_memory_bytes(q8) * 0.6
    for qp, tol in ((q8, 0.03), (q4, 0.35)):
        dq = tquant.dequantize_params(qp, dtype=torch.float32)
        rel = float((dq["w"] - params["w"]).abs().max()
                    / params["w"].abs().max())
        assert rel < tol, rel


def test_quant_dequant_forward_close(weights):
    """Mirror of the JAX package's test: logits of the int8-dequantized
    tiny model within 0.15 (mean abs) of the float32 model's."""
    cfg = TransformerConfig.tiny()
    state = _port_state(weights)
    qp, meta = tquant.quantize_params(state, group_size=64, min_size=1024)
    assert meta["quantized_leaves"] > 0
    deq = tquant.dequantize_params(qp, dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, size=(2, 16)))
    with torch.no_grad():
        ref = forward(state, tokens, cfg)
        out = forward(deq, tokens, cfg)
    assert float((ref - out).abs().mean()) < 0.15


def test_memory_reduction():
    """Mirror of the JAX package's test: int8 + scales < a third of the
    float32 bytes; nested dicts keep their structure."""
    q, meta = tquant.quantize_params({"a": {"w": torch.ones(512, 512)},
                                      "b": torch.ones(8)}, min_size=1024)
    assert meta["quantized_leaves"] == 1 and torch.equal(q["b"],
                                                         torch.ones(8))
    assert tquant.quantized_memory_bytes(q) < 512 * 512 * 4 / 3


# --------------------------------------------------------------------- #
# DSKV1 frames
# --------------------------------------------------------------------- #
def _shipments(seed=0):
    """One shipment of the same numpy rows in each package; its element
    count is off the int8 group grid."""
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((2, 13, 4, 16)).astype(np.float32)
    rows[1, 3] *= 40.0                           # groups of other scales
    meta = dict(tokens=[int(t) for t in rng.integers(0, 256, 13)],
                num_layers=2, num_kv_heads=2, head_dim=16, src_block_size=8)
    return (jship.KVShipment(wire="fp32", rows=rows, **meta),
            tship.KVShipment(wire="fp32", rows=torch.from_numpy(rows.copy()),
                             **meta))


@pytest.mark.parametrize("wire", ["fp32", "int8"])
def test_dskv1_frames_cross_both_ways(wire):
    jsh, tsh = _shipments()
    frame = tship.to_wire(tsh, wire)
    assert frame == jship.to_wire(jsh, wire)
    assert frame[:5] == tship.MAGIC == jship.MAGIC
    ours = tship.from_wire(frame, device="cpu")
    theirs = jship.from_wire(frame)
    assert ours.tokens == theirs.tokens == jsh.tokens
    assert (ours.num_layers, ours.num_kv_heads, ours.head_dim,
            ours.src_block_size, ours.wire) == \
        (theirs.num_layers, theirs.num_kv_heads, theirs.head_dim,
         theirs.src_block_size, theirs.wire)
    assert ours.rows.dtype == torch.float32
    assert _bits(ours.rows) == _bits(np.asarray(theirs.rows, np.float32))
    if wire == "fp32":
        assert _bits(ours.rows) == _bits(jsh.rows)
    b64 = tship.to_b64(tsh, wire)
    assert b64 == jship.to_b64(jsh, wire)
    assert _bits(tship.from_b64(b64, device="cpu").rows) == _bits(ours.rows)


def test_int8_wire_error_bounded():
    """Within half a quantization step of the float32 rows, elementwise,
    against the scales the wire carried; and lossy (the bound works)."""
    _, tsh = _shipments(1)
    back = tship.from_wire(tship.to_wire(tsh, "int8"), device="cpu")
    diff = (back.rows - tsh.rows).abs().reshape(-1)
    _, scales = tq.quant_pack_wire(tsh.rows, 8, tship.INT8_GROUP)
    bound = tship.int8_error_bound(scales, tship.INT8_GROUP, diff.numel())
    ref_bound = jship.int8_error_bound(scales.numpy(), 256, diff.numel())
    np.testing.assert_array_equal(bound.numpy(), ref_bound)
    assert bool((diff <= bound).all())
    assert float(diff.max()) > 0


def test_bad_frame_and_wire_raise():
    _, tsh = _shipments()
    with pytest.raises(ValueError, match="DSKV1"):
        tship.from_wire(b"not a frame at all", device="cpu")
    with pytest.raises(ValueError, match="wire"):
        tship.to_wire(tsh, "fp64")


def test_from_wire_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: device=None resolves to it")
    _, tsh = _shipments()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tship.from_wire(tship.to_wire(tsh))


# --------------------------------------------------------------------- #
# Engines
# --------------------------------------------------------------------- #
def _port_engine(weights, block_size=8, **kw):
    cfg = TransformerConfig.tiny()
    model = CausalLM(cfg, params_from_numpy(weights[2], cfg))
    return InferenceEngineV2(model, RaggedInferenceEngineConfig(
        dtype=torch.float32, block_size=block_size,
        **{**ENGINE, **kw}), device="cpu")


def _jax_engine(weights, block_size=8):
    cfg, params, _ = weights
    return jax_engine.InferenceEngineV2(
        jax_tf.CausalLM(cfg), params, jax_engine.RaggedInferenceEngineConfig(
            dtype=jnp.float32, attn_impl="gather", block_size=block_size,
            **ENGINE))


def _continue(eng, uid):
    """put the prompt's last token, then decode: → STEPS greedy tokens."""
    logits = eng.put([uid], [PROMPT[-1:]])
    seed = int(np.asarray(logits).argmax(-1)[0])
    return [seed] + [int(t) for t in
                     eng.decode_batch([uid], [seed], STEPS - 1)[:, 0]]


def _uninterrupted(eng, uid=0):
    logits = eng.put([uid], [PROMPT])
    seed = int(np.asarray(logits).argmax(-1)[0])
    return [seed] + [int(t) for t in
                     eng.decode_batch([uid], [seed], STEPS - 1)[:, 0]]


def test_export_matches_jax_engine(weights):
    eng = _port_engine(weights)
    eng.put([0], [PROMPT])
    ship = tship.export_kv(eng, 0, PROMPT)
    jeng = _jax_engine(weights)
    jeng.put([0], [PROMPT])
    jsh = jship.export_kv(jeng, 0, PROMPT)
    assert ship.n_tokens == jsh.n_tokens == len(PROMPT)
    assert ship.rows.device.type == "cpu"
    assert ship.rows.dtype == torch.float32 and ship.rows.is_contiguous()
    assert tuple(ship.rows.shape) == jsh.rows.shape == (2, len(PROMPT), 4, 16)
    np.testing.assert_allclose(ship.rows.numpy(), jsh.rows, atol=1e-5,
                               rtol=0)


@pytest.fixture(scope="module")
def jax_continuation(weights):
    """The JAX engine's own handoff: prefill prompt[:-1] with pages of 8,
    export, fp32 wire, import into pages of 16, continue."""
    src = _jax_engine(weights)
    src.put([0], [PROMPT[:-1]])
    ship = jship.from_wire(jship.to_wire(
        jship.export_kv(src, 0, PROMPT[:-1]), "fp32"))
    dst = _jax_engine(weights, block_size=16)
    assert jship.import_kv(dst, ship, uid=5)
    return _continue(dst, 5)


@pytest.mark.parametrize("dst_block_size", [8, 16])
def test_fp32_and_int8_continuation(weights, jax_continuation,
                                    dst_block_size):
    """Prefill prompt[:-1] with pages of 8, export, ship, import into pages
    of ``dst_block_size``, put the last token and decode: the fp32 wire's
    greedy stream equals the uninterrupted run's and the JAX engine's own
    continuation; the int8 wire's equals the fp32 one's."""
    ref = _uninterrupted(_port_engine(weights, dst_block_size))
    src = _port_engine(weights)
    src.put([0], [PROMPT[:-1]])
    ship = tship.export_kv(src, 0, PROMPT[:-1])
    assert ship.n_tokens == len(PROMPT) - 1
    streams = {}
    for wire in ("fp32", "int8"):
        dst = _port_engine(weights, dst_block_size)
        back = tship.from_wire(tship.to_wire(ship, wire), device="cpu")
        assert back.wire == wire
        assert tship.import_kv(dst, back, uid=9)
        seq = dst.state_manager.get_sequence(9)
        assert seq.seen_tokens == ship.n_tokens
        assert seq.input_ids == PROMPT[:-1]
        if wire == "fp32":     # the pool holds the shipped rows exactly
            again = tship.export_kv(dst, 9, PROMPT[:-1])
            assert _bits(again.rows) == _bits(ship.rows)
        streams[wire] = _continue(dst, 9)
    assert streams["fp32"] == ref == jax_continuation
    assert streams["int8"] == streams["fp32"]


def test_export_is_a_read(weights):
    """Exporting doesn't disturb the source: it keeps decoding bit-exactly
    as an engine that never exported."""
    eng = _port_engine(weights)
    logits = eng.put([0], [PROMPT])
    seed = int(logits[0].argmax())
    before = eng.state_manager.get_sequence(0).blocks[:]
    ship = tship.export_kv(eng, 0, PROMPT)
    assert ship.n_tokens == len(PROMPT)
    assert eng.state_manager.get_sequence(0).blocks == before
    toks = eng.decode_batch([0], [seed], 4)[:, 0].tolist()
    ref = _port_engine(weights)
    ref.put([0], [PROMPT])
    assert toks == ref.decode_batch([0], [seed], 4)[:, 0].tolist()


def test_import_geometry_mismatch_raises(weights):
    _, tsh = _shipments()
    bad = tship.KVShipment(tokens=tsh.tokens, num_layers=3,
                           num_kv_heads=tsh.num_kv_heads,
                           head_dim=tsh.head_dim,
                           src_block_size=tsh.src_block_size, wire="fp32",
                           rows=tsh.rows)
    eng = _port_engine(weights)
    with pytest.raises(ValueError, match="geometry mismatch"):
        tship.import_kv(eng, bad, uid=2)
    assert eng.state_manager.get_sequence(2) is None


def test_import_pool_exhaustion_rolls_back(weights):
    """A pool too small for the shipment: False, no descriptor left, every
    block still free."""
    _, tsh = _shipments()                       # 13 tokens
    eng = _port_engine(weights, block_size=8, max_seqs=1, max_ctx=8)
    free = eng.state_manager.free_blocks
    assert free * 8 < tsh.n_tokens
    assert tship.import_kv(eng, tsh, uid=4) is False
    assert eng.state_manager.get_sequence(4) is None
    assert eng.state_manager.free_blocks == free


def test_export_and_import_refuse_bad_sequences(weights):
    """An unknown uid, attested tokens shorter than the rows, and an import
    over a live sequence raise instead of shipping the wrong cache."""
    eng = _port_engine(weights)
    eng.put([0], [PROMPT])
    with pytest.raises(ValueError, match="unknown uid"):
        tship.export_kv(eng, 7, PROMPT)
    with pytest.raises(ValueError, match="shorter than rows"):
        tship.export_kv(eng, 0, PROMPT[:3])
    ship = tship.export_kv(eng, 0, PROMPT, n_tokens=4)
    assert ship.n_tokens == 4 and ship.rows.shape[1] == 4
    with pytest.raises(ValueError, match="non-fresh"):
        tship.import_kv(eng, ship, uid=0)

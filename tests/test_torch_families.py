"""The universal model families in the port against the JAX package's, on
the CPU in float32, over the reference's ``FAMILY_CASES`` table
(``tests/unit/test_universal_serving.py``: gpt2, opt, bloom, falcon7b,
falcon_new, falcon_rw, gptj, phi).

Each family's parameters come from the port's seeded initialiser with
every bias and norm scale moved off its 0/1 start (so the biases, the
LayerNorms and the lm-head bias all count), and cross to the JAX package
by name through ``models/convert.py``. One JAX ``universal_forward`` of
three token rows per family is the reference for:

  * the port's ``UniversalCausalLM`` forward;
  * the port's engine ``put`` logits over SplitFuse chunks and two decode
    steps, ``paged`` (the plain K6 on CPU tensors) and ``gather``;
  * two sequences in one ``put``;

and a second one, teacher-forced, for the greedy tokens of a fused decode
window. So no JAX engine runs per family; ``verify_decode`` on bloom and
falcon7b runs against the JAX engine (``gather``). Last, the Llama
family's ``TransformerConfig`` as the ``ArchConfig`` the engine serves it
as (``arch_of``), against the port's own llama forward.

Tolerance 2e-5 (abs and rel) on float32 logits of order 1: the two
frameworks' matmuls, norms and softmaxes differ in summation order by
~1e-6 over two layers; a wrong bias, position, slope or rotary pair moves
them by >1e-2.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine
from deepspeed_tpu.models import families as jax_families
from deepspeed_tpu_torch import InferenceEngineV2, RaggedInferenceEngineConfig
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.families import (ArchConfig,
                                                 UniversalCausalLM,
                                                 arch_of,
                                                 init_universal_params,
                                                 universal_param_shapes)
from deepspeed_tpu_torch.models.transformer import (TransformerConfig,
                                                    init_params)
from deepspeed_tpu_torch.models.transformer import forward as llama_forward

from .unit.test_universal_serving import BASE, FAMILY_CASES

pytestmark = pytest.mark.torch_port

TOL = dict(atol=2e-5, rtol=2e-5)
ENGINE = dict(max_tokens=8, max_seqs=2, max_ctx=64, block_size=8)
PROMPT = [int(t) for t in np.random.default_rng(0).integers(1, 96, 13)]
DECODE = [41, 7]                     # the two decode steps' tokens
P0, P1 = [3, 5, 7, 11, 13], [17, 19, 23]
WINDOW = 4                           # fused decode window steps


def _padded(row, n):
    """Causal logits at position i see tokens <= i only: a shorter row is
    padded at its end and read before the padding."""
    return row + [1] * (n - len(row))


@pytest.fixture(scope="module", params=sorted(FAMILY_CASES))
def family(request):
    kwargs = {**BASE, **FAMILY_CASES[request.param]}
    cfg = ArchConfig(**kwargs)
    tree = params_to_numpy(init_universal_params(
        cfg, torch.Generator().manual_seed(0), torch.float32, "cpu"))
    rng = np.random.default_rng(1)

    def perturb(node):
        for key, val in node.items():
            if isinstance(val, dict):
                perturb(val)
            elif key in ("bias", "scale"):
                node[key] = (val + rng.normal(size=val.shape) * 0.1
                             ).astype(np.float32)

    perturb(tree)
    jcfg = jax_families.ArchConfig(**kwargs)
    jparams = jax.tree.map(jnp.asarray, tree)
    seq = PROMPT + DECODE
    rows = [seq, _padded(P0, len(seq)), _padded(P1, len(seq))]
    ref = np.asarray(jax_families.universal_forward(
        jparams, jnp.asarray(rows, jnp.int32), jcfg))
    return types.SimpleNamespace(
        name=request.param, cfg=cfg, jcfg=jcfg, tree=tree, jparams=jparams,
        model=UniversalCausalLM(cfg, params_from_numpy(tree, cfg)),
        rows=rows, ref=ref)


def _engine(fam, impl="paged"):
    return InferenceEngineV2(fam.model, RaggedInferenceEngineConfig(
        dtype=torch.float32, attn_impl=impl, **ENGINE), device="cpu")


def _prefill(eng, uid, prompt):
    """``put`` in token-budget chunks → each chunk's last-token logits."""
    out = []
    for i in range(0, len(prompt), ENGINE["max_tokens"]):
        out.append(eng.put([uid], [prompt[i:i + ENGINE["max_tokens"]]])[0])
    return out


def test_forward_matches_jax(family):
    with torch.no_grad():
        got = family.model(torch.tensor(family.rows))
    assert got.shape == family.ref.shape
    np.testing.assert_allclose(got.numpy(), family.ref, **TOL)


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_engine_put_logits_match_jax(family, impl):
    eng = _engine(family, impl)
    got = _prefill(eng, 0, PROMPT)
    for tok in DECODE:
        got.append(eng.put([0], [[tok]])[0])
    positions = [7, 12, 13, 14]         # chunk ends, then the decode steps
    np.testing.assert_allclose(torch.stack(got).numpy(),
                               family.ref[0, positions], **TOL)


@pytest.mark.parametrize("impl", ["paged", "gather"])
def test_two_sequences_in_one_put(family, impl):
    logits = _engine(family, impl).put([0, 1], [P0, P1]).numpy()
    np.testing.assert_allclose(logits[0], family.ref[1, len(P0) - 1], **TOL)
    np.testing.assert_allclose(logits[1], family.ref[2, len(P1) - 1], **TOL)


def test_fused_decode_window_is_greedy(family):
    """The window's tokens are the JAX forward's argmax at every position
    of the teacher-forced stream."""
    eng = _engine(family)
    seed = int(_prefill(eng, 0, PROMPT)[-1].argmax())
    toks = [int(t) for t in eng.decode_batch([0], [seed], WINDOW)[:, 0]]
    stream = PROMPT + [seed] + toks
    ref = np.asarray(jax_families.universal_forward(
        family.jparams, jnp.asarray([stream[:-1]], jnp.int32), family.jcfg))
    assert ref[0, len(PROMPT) - 1:].argmax(-1).tolist() == [seed] + toks


# --------------------------------------------------------------------- #
# verify_decode on the ALiBi and the G = H (MQA) family, against the JAX
# engine
# --------------------------------------------------------------------- #
def _verify_scenario(eng, greedy):
    """Prefill two sequences, then two verify windows: uid 0 drafts its
    own greedy continuation (``greedy``, accepted), uid 1 always-wrong
    drafts (rejected). → what both engines must agree on."""
    sm = eng.state_manager
    eng.put([0], [P0])
    seeds = [greedy[0], int(np.asarray(eng.put([1], [P1]))[0].argmax())]
    out = []
    for w in range(2):
        drafts = [greedy[1 + 4 * w:4 + 4 * w], [(seeds[1] + 1) % 97] * 3]
        res = eng.verify_decode([0, 1], seeds, drafts)
        seeds = [acc[-1] for acc in res.accepted]
        out.append({"accepted": res.accepted, "drafted": res.drafted,
                    "accepted_draft": res.accepted_draft,
                    "emitted": res.emitted,
                    "seen": [sm.get_sequence(u).seen_tokens for u in (0, 1)],
                    "free": sm.free_blocks})
    return out


@pytest.mark.parametrize("name", ["bloom", "falcon7b"])
def test_verify_decode_matches_jax_engine(name):
    kwargs = {**BASE, **FAMILY_CASES[name]}
    cfg = ArchConfig(**kwargs)
    tree = params_to_numpy(init_universal_params(
        cfg, torch.Generator().manual_seed(2), torch.float32, "cpu"))
    model = UniversalCausalLM(cfg, params_from_numpy(tree, cfg))
    fam = types.SimpleNamespace(model=model)
    # uid 0's greedy stream: the token after P0, then a fused window
    eng = _engine(fam)
    first = int(eng.put([0], [P0])[0].argmax())
    greedy = [first] + [int(t) for t in
                        eng.decode_batch([0], [first], 8)[:, 0]]
    ref = _verify_scenario(jax_engine.InferenceEngineV2(
        jax_families.UniversalCausalLM(jax_families.ArchConfig(**kwargs)),
        jax.tree.map(jnp.asarray, tree),
        jax_engine.RaggedInferenceEngineConfig(
            dtype=jnp.float32, attn_impl="gather", **ENGINE)), greedy)
    for impl in ("paged", "gather"):
        got = _verify_scenario(_engine(fam, impl), greedy)
        assert got == ref, impl
    assert [w["accepted_draft"] for w in ref] == [3, 3]
    assert [w["accepted"][0] for w in ref] == [greedy[1:5], greedy[5:9]]


# --------------------------------------------------------------------- #
# The Llama family served as an ArchConfig
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [{}, {"tie_embeddings": True},
                                {"attn_bias": True}],
                         ids=["untied", "tied", "qkv_bias"])
def test_llama_config_as_arch_config(kw):
    """``arch_of`` maps a ``TransformerConfig`` to the family whose tree is
    the llama tree with ``ln1``/``ln2`` for ``attn_norm``/``mlp_norm``,
    and that family's plain forward is the llama forward. The norm scales
    and biases are moved off their 1/0 start, so a swapped norm or a
    dropped bias shows."""
    cfg = TransformerConfig.tiny(**kw)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         torch.float32, "cpu")
    rng = np.random.default_rng(3)
    for name, t in params.items():
        if name.endswith((".scale", ".bias")):
            t += torch.from_numpy(
                rng.normal(size=t.shape).astype(np.float32) * 0.1)
    rename = {"layers.attn_norm.scale": "layers.ln1.scale",
              "layers.mlp_norm.scale": "layers.ln2.scale"}
    state = {rename.get(n, n): t for n, t in params.items()}
    arch = arch_of(cfg)
    assert {n: tuple(t.shape) for n, t in state.items()} == \
        universal_param_shapes(arch)
    tokens = torch.tensor(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9)))
    with torch.no_grad():
        got = UniversalCausalLM(arch, state)(tokens)
        ref = llama_forward(params, tokens, cfg)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)

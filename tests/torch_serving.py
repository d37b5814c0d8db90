"""Helpers shared by the port's prefix-reuse, page-heat, KV-swap and
fault-injection tests: the tiny model's weights, both packages' engines at
one small geometry, and a helper that serves one request in the JAX
lifecycle scheduler's call order (``lifecycle.py``: ``graft_prefix`` at
admission, the whole-lifetime reservation, ``put`` of the rest of the
prompt, ``commit_prefix`` at prefill end, fused decode windows,
``commit_prefix(allow_partial=True)`` and ``flush`` at retirement).

The helper is duck-typed: it runs the JAX engine and the port's alike.
The JAX engines take the dense page-gather attention, the JAX package's
plain reference of its paged kernels (its greedy tokens are the paged
kernels' on the CPU; it compiles in half the time), while the port's run
its paged path, the kernels' plain versions on CPU tensors.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine
from deepspeed_tpu.models import transformer as jax_tf
from deepspeed_tpu_torch import (
    CausalLM,
    InferenceEngineV2,
    RaggedInferenceEngineConfig,
    TransformerConfig,
)
from deepspeed_tpu_torch.models.convert import (params_from_numpy,
                                                params_to_numpy)
from deepspeed_tpu_torch.models.transformer import init_params

BS = 8
GEOMETRY = dict(max_tokens=32, max_seqs=4, max_ctx=64, block_size=BS)
#: logits tolerance (abs and rel) between the two frameworks' float32
#: forwards over two layers, as tests/test_torch_engine.py holds them
LOGITS_TOL = 1e-4


@functools.lru_cache(maxsize=1)
def tiny_weights():
    """The tiny model's weights from a seed, as the JAX tree and as numpy
    (built once a process, read-only; the port's initialiser, which needs
    no JAX compile)."""
    tree = params_to_numpy(init_params(TransformerConfig.tiny(),
                                       torch.Generator().manual_seed(0),
                                       torch.float32, "cpu"))
    return (jax_tf.TransformerConfig.tiny(), jax.tree.map(jnp.asarray, tree),
            tree)


def jax_engine_for(weights, **kw):
    cfg, params, _ = weights
    conf = dict(GEOMETRY, dtype=jnp.float32, attn_impl="gather")
    conf.update(kw)
    return jax_engine.InferenceEngineV2(
        jax_tf.CausalLM(cfg), params,
        jax_engine.RaggedInferenceEngineConfig(**conf))


def port_engine_for(weights, **kw):
    cfg = TransformerConfig.tiny()
    model = CausalLM(cfg, params_from_numpy(weights[2], cfg))
    conf = dict(GEOMETRY, dtype=torch.float32)
    conf.update(kw)
    return InferenceEngineV2(model, RaggedInferenceEngineConfig(**conf),
                             device="cpu")


def host(x) -> np.ndarray:
    """A JAX array or a CPU tensor as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def page_rows(eng, block) -> np.ndarray:
    """Logical page ``block`` of every layer, ``[L, bs, 2*KV, hd]``."""
    nb = eng.kv.config.num_blocks
    phys = [block + layer * nb for layer in range(eng.cfg.num_layers)]
    if isinstance(eng.kv.pages, torch.Tensor):
        return eng.kv.pages[phys].numpy().copy()
    return np.asarray(eng.kv.pages[jnp.asarray(phys)])


def admit(eng, uid, prompt, max_new):
    """Admission: graft the cached prefix, then reserve the request's whole
    lifetime. → tokens grafted, or None when the pool cannot hold it."""
    matched = eng.graft_prefix(uid, prompt)
    sm = eng.state_manager
    need = min(len(prompt) + max_new, eng.config.max_ctx)
    seq = sm.get_or_create_sequence(uid)
    if not sm.maybe_allocate_kv(seq, need - seq.seen_tokens):
        if seq.blocks or seq.seen_tokens:
            sm.flush_sequence(uid)
        else:
            sm._seqs.pop(uid, None)
        return None
    return matched


def prefill(eng, uid, prompt, start):
    """``put`` prompt[start:] in token-budget chunks, then commit the full
    prompt pages. → the last chunk's logits (numpy)."""
    budget = eng.config.max_tokens
    for i in range(start, len(prompt), budget):
        logits = eng.put([uid], [prompt[i:i + budget]])
    eng.commit_prefix(uid, prompt)
    return host(logits)[0]


def decode(eng, uid, seed, n, window=4):
    """``n - 1`` tokens after ``seed`` in fused windows. → [seed, ...]."""
    out = [int(seed)]
    while len(out) < n:
        steps = min(window, n - len(out))
        toks = eng.decode_batch([uid], [out[-1]], steps)
        out.extend(int(t) for t in np.asarray(toks)[:, 0])
    return out


def retire(eng, uid, prompt):
    eng.commit_prefix(uid, prompt, allow_partial=True)
    eng.flush([uid])


def serve(eng, uid, prompt, max_new, window=4):
    """One request from admission to retirement. → dict of the grafted
    token count, the first-token logits and the greedy tokens."""
    matched = admit(eng, uid, prompt, max_new)
    assert matched is not None, f"uid {uid} does not fit the pool"
    logits = prefill(eng, uid, prompt, matched)
    tokens = decode(eng, uid, int(logits.argmax()), max_new, window)
    retire(eng, uid, prompt)
    return {"matched": matched, "logits": logits, "tokens": tokens}

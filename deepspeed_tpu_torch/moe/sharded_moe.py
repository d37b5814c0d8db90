"""Mixture-of-Experts gating, dispatch and expert MLPs for the PyTorch port
(counterpart of ``deepspeed_tpu/moe/sharded_moe.py``; reference:
``deepspeed/moe/sharded_moe.py`` top1/top2/topk gating and ``MOELayer``).

Everything here runs on one device, as the JAX package's functions do on
a mesh of one: its ``_pin_replicated`` is the identity there and has no
counterpart, and expert parallelism (``reshard_expert_params``, an
``ep_size`` above 1) is ROADMAP M9.

Routing is discrete, so the port makes the same decisions as the JAX
functions, not merely close ones:

  * top-k takes equal gate values in index order (``jax.lax.top_k``'s
    rule; ``torch.topk`` promises no order among ties), padded ``-inf``
    experts included;
  * capacity is taken choice by choice (every token's first choice before
    any token's second), within a choice in flat-token order, with the
    same float32 running counts;
  * an assignment past capacity goes to the trash row ``E*C``;
  * router logits are a float32 product of float32 tokens, with TF32 off.

The dispatch buffer, the expert products and the combine run in the
expert weights' dtype, the gate values cast to it before the multiply.
Dispatch is ``index_add_`` into zeros (no two kept assignments share a
slot, so each kept row is one exact add) and combine is ``index_select``.
The expert products are ``torch.bmm``, where the JAX package has XLA
einsums. The top-k gates draw no noise and take no generator; top-1's
``RSample`` Gumbel noise comes from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..accelerator import get_accelerator


class GateOutput(NamedTuple):
    l_aux: torch.Tensor          # load-balance loss
    combine: torch.Tensor        # [S, E, C] float32 combine weights
    dispatch: torch.Tensor       # [S, E, C] bool dispatch mask
    exp_counts: torch.Tensor     # [E] tokens routed per expert (pre-drop)


class SparseGateOutput(NamedTuple):
    """Routing as flat slot ids instead of dense ``[S, E, C]`` one-hots:
    ``slot[s, choice]`` is ``expert * C + position``, or ``E * C`` (the
    trash row) when the assignment was dropped; ``gate_val`` is its
    combine weight (0 for drops)."""
    l_aux: torch.Tensor
    slot: torch.Tensor           # [S, k] int32
    gate_val: torch.Tensor       # [S, k] float32
    exp_counts: torch.Tensor     # [E] int32
    capacity: int


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = math.ceil(num_tokens / num_experts * capacity_factor)
    return max(cap, min_capacity)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot``: float32, an index outside ``[0, n)`` is a row
    of zeros (a position past capacity when tokens are not dropped)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values,
    equal values lower index first (a stable descending sort keeps the
    index order of ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a.float() @ b.float()`` in full float32: TF32 is switched off
    for the product if the process allows it."""
    a, b = a.float(), b.float()
    flags = torch.backends.cuda.matmul
    if not (a.is_cuda and flags.allow_tf32):
        return a @ b
    flags.allow_tf32 = False
    try:
        return a @ b
    finally:
        flags.allow_tf32 = True


def _mask_padded_experts(logits: torch.Tensor,
                         num_experts_logical: Optional[int]
                         ) -> Tuple[torch.Tensor, int]:
    """Routing over a padded expert stack (:func:`pad_experts_for_ep`):
    the padding columns get ``-inf`` logits, so softmax, argmax and top-k
    equal the unpadded layer's. → (masked logits, logical expert count);
    capacity and the load-balance loss use the logical count."""
    E = logits.shape[1]
    if num_experts_logical is None or num_experts_logical >= E:
        return logits, E
    mask = torch.where(torch.arange(E, device=logits.device)
                       < num_experts_logical, 0.0, float("-inf"))
    return logits + mask[None, :], int(num_experts_logical)


def _gumbel(shape, generator: torch.Generator,
            device: torch.device) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def _top1_select(logits, noisy_gate_policy, generator):
    if noisy_gate_policy == "RSample" and generator is not None:
        logits = logits + _gumbel(logits.shape, generator, logits.device)
    return torch.argmax(logits, dim=1)


def top1gating(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4, noisy_gate_policy: Optional[str] = None,
               generator: Optional[torch.Generator] = None,
               drop_tokens: bool = True,
               num_experts_logical: Optional[int] = None) -> GateOutput:
    """Switch-style top-1 gating (reference: sharded_moe.py:183)."""
    S, E = logits.shape
    logits, n_log = _mask_padded_experts(logits, num_experts_logical)
    C = _capacity(S, n_log, capacity_factor, min_capacity)
    gates = torch.softmax(logits, dim=1)
    idx = _top1_select(logits, noisy_gate_policy, generator)
    mask = _one_hot(idx, E)

    # load-balance loss (Switch): E * sum_e mean(mask_e) * mean(gates_e)
    l_aux = (gates.mean(0) * mask.mean(0)).sum() * n_log

    pos = torch.cumsum(mask, 0) - mask                  # position in expert
    if drop_tokens:
        mask = mask * (pos < C)
    pos_in_expert = (pos * mask).sum(1).to(torch.int32)
    gate_val = (gates * mask).sum(1)
    dispatch = mask[:, :, None] * _one_hot(pos_in_expert, C)[:, None, :]
    combine = dispatch * gate_val[:, None, None]
    return GateOutput(l_aux, combine, dispatch.bool(),
                      _one_hot(idx, E).sum(0).to(torch.int32))


def topkgating(logits: torch.Tensor, k: int = 2, capacity_factor: float = 1.0,
               min_capacity: int = 4, drop_tokens: bool = True,
               normalize_weights: bool = True,
               num_experts_logical: Optional[int] = None) -> GateOutput:
    """Top-k gating (reference: sharded_moe.py:374; k = 2 is
    top2gating)."""
    S, E = logits.shape
    logits, n_log = _mask_padded_experts(logits, num_experts_logical)
    C = _capacity(S * k, n_log, capacity_factor, min_capacity)
    gates = torch.softmax(logits, dim=1)
    topk_val, topk_idx = _top_k(gates, k)
    if normalize_weights:
        topk_val = topk_val / topk_val.sum(1, keepdim=True)

    dev = logits.device
    combine = torch.zeros((S, E, C), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((S, E, C), dtype=torch.bool, device=dev)
    counts = torch.zeros(E, dtype=torch.float32, device=dev)
    ce_total = torch.zeros(E, dtype=torch.float32, device=dev)
    for choice in range(k):
        mask = _one_hot(topk_idx[:, choice], E)
        ce_total = ce_total + mask.sum(0)
        pos = torch.cumsum(mask, 0) - mask + counts[None, :]
        if drop_tokens:
            mask = mask * (pos < C)
        counts = counts + mask.sum(0)
        pos_in_expert = (pos * mask).sum(1).to(torch.int32)
        d = mask[:, :, None] * _one_hot(pos_in_expert, C)[:, None, :]
        dispatch = dispatch | d.bool()
        combine = combine + d * topk_val[:, choice][:, None, None]

    ce = ce_total / ce_total.sum().clamp_min(1.0)
    l_aux = (gates.mean(0) * ce).sum() * n_log
    return GateOutput(l_aux, combine, dispatch, ce_total.to(torch.int32))


def top2gating(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4, **kw) -> GateOutput:
    return topkgating(logits, k=2, capacity_factor=capacity_factor,
                      min_capacity=min_capacity, **kw)


# --------------------------------------------------------------------- #
# Sparse (scatter/gather) dispatch: linear in tokens
# --------------------------------------------------------------------- #
def _kept_slot(mask, pos, idx, C, E):
    """→ (kept [S] bool, slot [S] int32) of one choice's masked
    assignments; past capacity is the trash row ``E*C`` (a raw
    ``idx*C + pos`` would land in the next expert's rows)."""
    pos_in_expert = (pos * mask).sum(1).to(torch.int32)
    kept = (mask.sum(1) > 0) & (pos_in_expert < C)
    slot = torch.where(kept, idx.to(torch.int32) * C + pos_in_expert,
                       E * C)
    return kept, slot


def top1gating_sparse(logits: torch.Tensor, capacity_factor: float = 1.0,
                      min_capacity: int = 4,
                      noisy_gate_policy: Optional[str] = None,
                      generator: Optional[torch.Generator] = None,
                      drop_tokens: bool = True,
                      num_experts_logical: Optional[int] = None
                      ) -> SparseGateOutput:
    """Sparse-form top-1 gating; the decisions of :func:`top1gating`."""
    S, E = logits.shape
    logits, n_log = _mask_padded_experts(logits, num_experts_logical)
    C = _capacity(S, n_log, capacity_factor, min_capacity)
    gates = torch.softmax(logits, dim=1)
    idx = _top1_select(logits, noisy_gate_policy, generator)
    mask = _one_hot(idx, E)
    l_aux = (gates.mean(0) * mask.mean(0)).sum() * n_log

    pos = torch.cumsum(mask, 0) - mask
    if drop_tokens:
        mask = mask * (pos < C)
    gate_val = (gates * mask).sum(1)
    _, slot = _kept_slot(mask, pos, idx, C, E)
    counts = _one_hot(idx, E).sum(0).to(torch.int32)
    return SparseGateOutput(l_aux, slot[:, None], gate_val[:, None], counts,
                            C)


def topkgating_sparse(logits: torch.Tensor, k: int = 2,
                      capacity_factor: float = 1.0, min_capacity: int = 4,
                      drop_tokens: bool = True,
                      normalize_weights: bool = True,
                      valid: Optional[torch.Tensor] = None,
                      num_experts_logical: Optional[int] = None
                      ) -> SparseGateOutput:
    """Sparse-form top-k gating; the decisions of :func:`topkgating`.

    ``valid`` [S] bool: tokens marked invalid (ragged-batch padding) go
    to the trash slot and consume no expert capacity. The capacity counts
    every row of ``logits``, padding included."""
    S, E = logits.shape
    logits, n_log = _mask_padded_experts(logits, num_experts_logical)
    C = _capacity(S * k, n_log, capacity_factor, min_capacity)
    gates = torch.softmax(logits, dim=1)
    topk_val, topk_idx = _top_k(gates, k)
    if normalize_weights:
        topk_val = topk_val / topk_val.sum(1, keepdim=True)

    slots, vals = [], []
    counts = torch.zeros(E, dtype=torch.float32, device=logits.device)
    ce_total = torch.zeros(E, dtype=torch.float32, device=logits.device)
    for choice in range(k):
        idx = topk_idx[:, choice]
        mask = _one_hot(idx, E)
        if valid is not None:
            mask = mask * valid.float()[:, None]
        ce_total = ce_total + mask.sum(0)
        pos = torch.cumsum(mask, 0) - mask + counts[None, :]
        if drop_tokens:
            mask = mask * (pos < C)
        counts = counts + mask.sum(0)
        kept, slot = _kept_slot(mask, pos, idx, C, E)
        slots.append(slot)
        vals.append(torch.where(kept, topk_val[:, choice], 0.0))

    ce = ce_total / ce_total.sum().clamp_min(1.0)
    l_aux = (gates.mean(0) * ce).sum() * n_log
    return SparseGateOutput(l_aux, torch.stack(slots, 1),
                            torch.stack(vals, 1), ce_total.to(torch.int32), C)


def dispatch_sparse(slot: torch.Tensor, tokens: torch.Tensor,
                    num_experts: int, capacity: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """``[S, k]`` slots × ``[S, D]`` tokens → ``[E, C, D]`` by
    ``index_add_`` into zeros, one trash row past the end for drops."""
    D = tokens.shape[1]
    EC = num_experts * capacity
    flat = torch.zeros((EC + 1, D), dtype=dtype, device=tokens.device)
    t = tokens.to(dtype)
    for choice in range(slot.shape[1]):
        flat.index_add_(0, slot[:, choice].long(), t)
    return flat[:EC].view(num_experts, capacity, D)


def combine_sparse(slot: torch.Tensor, gate_val: torch.Tensor,
                   expert_out: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """``[S, k]`` slots and weights × ``[E, C, D]`` expert outputs →
    ``[S, D]``: a gather per choice, summed in choice order."""
    E, C, D = expert_out.shape
    flat = torch.cat([expert_out.reshape(E * C, D),
                      expert_out.new_zeros((1, D))])
    out = None
    for choice in range(slot.shape[1]):
        contrib = gate_val[:, choice, None].to(dtype) * \
            flat.index_select(0, slot[:, choice].long()).to(dtype)
        out = contrib if out is None else out + contrib
    return out


def dispatch_to_experts(dispatch: torch.Tensor, tokens: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """``[S, E, C]`` mask × ``[S, D]`` tokens → ``[E, C, D]`` (the GShard
    dispatch einsum)."""
    return torch.einsum("sec,sd->ecd", dispatch.to(dtype), tokens.to(dtype))


def combine_from_experts(combine: torch.Tensor, expert_out: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """``[S, E, C]`` weights × ``[E, C, D]`` expert outputs → ``[S, D]``."""
    return torch.einsum("sec,ecd->sd", combine.to(dtype), expert_out)


# --------------------------------------------------------------------- #
# Expert FFN + MOELayer
# --------------------------------------------------------------------- #
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_moe_params(generator: torch.Generator, hidden: int, ffn: int,
                    num_experts: int, dtype: torch.dtype = torch.float32,
                    device=None) -> Dict:
    """Gate + stacked expert FFN params (reference Experts:
    moe/experts.py:13) with the JAX package's distributions; the gate
    stays float32. Numbers come from ``generator``, which must live on
    ``device`` (``None``: CUDA); they differ from ``jax.random``'s."""
    device = get_accelerator().resolve_device(device)

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, device=device) * scale

    s1, s2 = 1.0 / math.sqrt(hidden), 1.0 / math.sqrt(ffn)
    return {
        "gate": {"kernel": normal((hidden, num_experts), s1)},
        "experts": {
            "w1": normal((num_experts, hidden, ffn), s1).to(dtype),
            "b1": torch.zeros((num_experts, ffn), dtype=dtype, device=device),
            "w2": normal((num_experts, ffn, hidden), s2).to(dtype),
            "b2": torch.zeros((num_experts, hidden), dtype=dtype,
                              device=device),
        },
    }


def moe_mlp_block(lp: Dict, tokens: torch.Tensor, k: int = 2,
                  capacity_factor: float = 2.0, dispatch_impl: str = "sparse",
                  valid: Optional[torch.Tensor] = None,
                  num_experts_logical: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mixtral-style routed SwiGLU expert MLP over flat tokens ``[T, D]``
    → (out ``[T, D]``, l_aux).

    ``lp`` is one layer's ``{"router": {"kernel": [D, E]}, "gate_proj":
    {"kernel": [E, D, F]}, "up_proj": ..., "down_proj": {"kernel": [E, F,
    D]}}``; the router runs in float32 whatever the experts' dtype."""
    if dispatch_impl not in ("sparse", "dense"):
        raise ValueError(f"dispatch_impl must be 'sparse' or 'dense', got "
                         f"{dispatch_impl!r}")
    logits_r = _f32_matmul(tokens, lp["router"]["kernel"])
    dtype = lp["gate_proj"]["kernel"].dtype
    if dispatch_impl == "sparse":
        gate_out = topkgating_sparse(logits_r, k=k,
                                     capacity_factor=capacity_factor,
                                     valid=valid,
                                     num_experts_logical=num_experts_logical)
        dispatched = dispatch_sparse(gate_out.slot, tokens,
                                     logits_r.shape[1], gate_out.capacity,
                                     dtype)
    else:
        if valid is not None:
            raise ValueError("ragged validity masks need "
                             "dispatch_impl='sparse'")
        gate_out = topkgating(logits_r, k=k, capacity_factor=capacity_factor,
                              num_experts_logical=num_experts_logical)
        dispatched = dispatch_to_experts(gate_out.dispatch, tokens, dtype)
    act = F.silu(torch.bmm(dispatched, lp["gate_proj"]["kernel"]))
    up = torch.bmm(dispatched, lp["up_proj"]["kernel"])
    eo = torch.bmm(act * up, lp["down_proj"]["kernel"])
    if dispatch_impl == "sparse":
        out = combine_sparse(gate_out.slot, gate_out.gate_val, eo, dtype)
    else:
        out = combine_from_experts(gate_out.combine, eo, dtype)
    return out, gate_out.l_aux


def moe_layer(params: Dict, x: torch.Tensor, k: int = 1,
              capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
              min_capacity: int = 4, drop_tokens: bool = True,
              noisy_gate_policy: Optional[str] = None,
              generator: Optional[torch.Generator] = None,
              training: bool = True,
              activation: Callable = _gelu_tanh,
              dispatch_impl: str = "sparse",
              num_experts_logical: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The MoE layer on ``x [..., D]`` → (out ``[..., D]``, l_aux,
    exp_counts) (reference: MOELayer.forward, sharded_moe.py:586).

    ``params`` is ``{"gate": {"kernel": [D, E]}, "experts": {"w1", "b1",
    "w2", "b2"}}`` (:func:`init_moe_params`). ``dispatch_impl``:
    "sparse" routes by flat slots (linear in tokens), "dense" by the
    GShard ``[S, E, C]`` einsums."""
    if dispatch_impl not in ("sparse", "dense"):
        raise ValueError(f"dispatch_impl must be 'sparse' or 'dense', got "
                         f"{dispatch_impl!r}")
    D = x.shape[-1]
    tokens = x.reshape(-1, D)
    logits = _f32_matmul(tokens, params["gate"]["kernel"])
    cf = capacity_factor if training else eval_capacity_factor
    w = params["experts"]
    dtype = w["w1"].dtype
    E = logits.shape[1]

    def expert_ffn(dispatched):
        h = activation(torch.bmm(dispatched, w["w1"]) + w["b1"][:, None, :])
        return torch.bmm(h, w["w2"]) + w["b2"][:, None, :]

    if dispatch_impl == "sparse":
        if k == 1:
            gate = top1gating_sparse(logits, cf, min_capacity,
                                     noisy_gate_policy, generator,
                                     drop_tokens,
                                     num_experts_logical=num_experts_logical)
        else:
            gate = topkgating_sparse(logits, k, cf, min_capacity, drop_tokens,
                                     num_experts_logical=num_experts_logical)
        dispatched = dispatch_sparse(gate.slot, tokens, E, gate.capacity,
                                     dtype)
        out = combine_sparse(gate.slot, gate.gate_val,
                             expert_ffn(dispatched), dtype)
    else:
        if k == 1:
            gate = top1gating(logits, cf, min_capacity, noisy_gate_policy,
                              generator, drop_tokens,
                              num_experts_logical=num_experts_logical)
        else:
            gate = topkgating(logits, k, cf, min_capacity, drop_tokens,
                              num_experts_logical=num_experts_logical)
        dispatched = dispatch_to_experts(gate.dispatch, tokens, dtype)
        out = combine_from_experts(gate.combine, expert_ffn(dispatched),
                                   dtype)
    return out.reshape(x.shape), gate.l_aux, gate.exp_counts


# --------------------------------------------------------------------- #
# Expert ranges and padding (the pure parts of elastic resharding)
# --------------------------------------------------------------------- #
def expert_shard_ranges(num_experts: int, ep_size: int) -> list:
    """Contiguous logical-expert ranges ``[(start, stop), ...]`` per
    expert-parallel rank, balanced (sizes differ by at most one; the
    first ``num_experts % ep_size`` ranks carry the extra expert)."""
    E, ep = int(num_experts), max(int(ep_size), 1)
    base, rem = divmod(E, ep)
    out, start = [], 0
    for r in range(ep):
        n = base + (1 if r < rem else 0)
        out.append((start, start + n))
        start += n
    return out


def placed_expert_ranges(num_experts: int, ep_size: int) -> list:
    """The logical expert rows each rank holds after
    :func:`pad_experts_for_ep` and even chunking of the padded stack
    (trailing ranks may hold only padding: an empty range)."""
    E, ep = int(num_experts), max(int(ep_size), 1)
    chunk = padded_expert_count(E, ep) // ep
    return [(min(r * chunk, E), min((r + 1) * chunk, E)) for r in range(ep)]


def padded_expert_count(num_experts: int, ep_size: int) -> int:
    """Smallest multiple of ``ep_size`` holding ``num_experts``."""
    ep = max(int(ep_size), 1)
    return -(-int(num_experts) // ep) * ep


def _pad_axis(arr: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    pad = target - arr.shape[axis]
    if pad <= 0:
        return arr
    shape = list(arr.shape)
    shape[axis] = pad
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def pad_experts_for_ep(params: Dict, ep_size: int) -> Tuple[Dict, int]:
    """Pad a stacked-expert param tree so the expert axis divides
    ``ep_size``: zero experts appended to the stacks (axis 0) and zero
    columns to the gate or router kernel (axis 1). → (padded params,
    ``num_experts_logical``), which the gates must be given, so that the
    padding routes ``-inf``. Both families: ``gate`` + ``experts``
    (:func:`moe_layer`) and ``router`` + ``*_proj`` (:func:`moe_mlp_block`).
    """
    gate_key = "gate" if "gate" in params else "router"
    if gate_key not in params:
        raise ValueError("not a MoE param tree: no 'gate' or 'router' entry")
    E = int(params[gate_key]["kernel"].shape[1])
    E_pad = padded_expert_count(E, ep_size)
    if E_pad == E:
        return params, E
    out = dict(params)
    out[gate_key] = {"kernel": _pad_axis(params[gate_key]["kernel"], 1,
                                         E_pad)}
    if "experts" in params:
        out["experts"] = {k: _pad_axis(v, 0, E_pad)
                          for k, v in params["experts"].items()}
    for k in ("gate_proj", "up_proj", "down_proj"):
        if k in params:
            out[k] = {"kernel": _pad_axis(params[k]["kernel"], 0, E_pad)}
    return out, E


def reshard_expert_params(params: Dict, topology=None):
    """Laying experts out over an expert mesh axis needs expert
    parallelism, which is not ported."""
    raise NotImplementedError(
        "resharding experts over an expert-parallel mesh is not ported yet "
        "(ROADMAP M9: MoE training and expert parallelism)")

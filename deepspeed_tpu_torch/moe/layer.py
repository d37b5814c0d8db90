"""MoE module wrapper for the PyTorch port (counterpart of
``deepspeed_tpu/moe/layer.py``; reference: deepspeed/moe/layer.py:17
``MoE``).

DeepSpeed's constructor signature, used functionally as in the JAX
package: :meth:`MoE.init_params` returns the parameter tree,
:meth:`MoE.__call__` applies it. One device only: an ``ep_size`` above 1
(expert parallelism) is ROADMAP M9. ``expert`` and ``use_rts`` are
accepted for the signature and unused, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

from ..accelerator import get_accelerator
from .sharded_moe import _gelu_tanh, init_moe_params, moe_layer


class MoE:
    def __init__(self, hidden_size: int, expert=None, num_experts: int = 1,
                 ep_size: int = 1, k: int = 1, capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 use_residual: bool = False,
                 noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True,
                 ffn_hidden_size: Optional[int] = None,
                 activation: Callable = _gelu_tanh):
        if num_experts % max(ep_size, 1) != 0:
            raise ValueError(f"num_experts({num_experts}) must divide by "
                             f"ep_size({ep_size})")
        if ep_size > 1:
            raise NotImplementedError(
                f"ep_size={ep_size}: expert parallelism is not ported yet "
                f"(ROADMAP M9: MoE training and expert parallelism)")
        self.hidden_size = hidden_size
        self.num_experts = num_experts
        self.ep_size = ep_size
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.use_residual = use_residual
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.ffn_hidden_size = ffn_hidden_size or 4 * hidden_size
        self.activation = activation

    def init_params(self, generator: torch.Generator,
                    dtype: torch.dtype = torch.float32, device=None) -> Dict:
        """The gate and experts (and with ``use_residual`` the residual
        MLP and its mixing coefficient), drawn from ``generator`` with
        the JAX package's distributions, on ``device`` (``None``: CUDA)."""
        device = get_accelerator().resolve_device(device)
        D, Fd = self.hidden_size, self.ffn_hidden_size
        moe_p = init_moe_params(generator, D, Fd, self.num_experts, dtype,
                                device)
        if not self.use_residual:
            return moe_p

        def normal(shape, fan_in):
            return (torch.randn(shape, generator=generator, device=device)
                    / math.sqrt(fan_in)).to(dtype)

        return {
            "moe": moe_p,
            "residual_mlp": {
                "w1": normal((D, Fd), D),
                "b1": torch.zeros(Fd, dtype=dtype, device=device),
                "w2": normal((Fd, D), Fd),
                "b2": torch.zeros(D, dtype=dtype, device=device),
            },
            "coefficient": {"kernel": normal((D, 2), D)},
        }

    def __call__(self, params: Dict, hidden_states: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 training: bool = True):
        """→ (output, l_aux, exp_counts), as the reference MoE.forward."""
        moe_p = params["moe"] if self.use_residual else params
        out, l_aux, counts = moe_layer(
            moe_p, hidden_states, k=self.k,
            capacity_factor=self.capacity_factor,
            eval_capacity_factor=self.eval_capacity_factor,
            min_capacity=self.min_capacity, drop_tokens=self.drop_tokens,
            noisy_gate_policy=self.noisy_gate_policy, generator=generator,
            training=training, activation=self.activation)
        if self.use_residual:
            # MoS residual (reference layer.py residual_mlp + coefficient)
            r = params["residual_mlp"]
            h = self.activation(hidden_states @ r["w1"] + r["b1"])
            res = h @ r["w2"] + r["b2"]
            coef = torch.softmax(
                hidden_states @ params["coefficient"]["kernel"], dim=-1)
            out = out * coef[..., 0:1] + res * coef[..., 1:2]
        return out, l_aux, counts

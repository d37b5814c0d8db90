"""Block-sparse attention (K16-K19) for the port (counterpart of
``deepspeed_tpu/ops/sparse_attention``)."""
from .block_sparse_kernel import (
    block_sparse_attention,
    block_sparse_bwd_dkv,
    block_sparse_bwd_dkv_reference,
    block_sparse_bwd_dq,
    block_sparse_bwd_dq_reference,
    block_sparse_fwd,
    block_sparse_fwd_nolse,
    block_sparse_fwd_reference,
    build_fetch_table,
    prepare_layout,
)
from .sparse_self_attention import BertSparseSelfAttention, SparseSelfAttention
from .sparsity_config import (
    BigBirdSparsityConfig,
    BSLongformerSparsityConfig,
    DenseSparsityConfig,
    FixedSparsityConfig,
    SparsityConfig,
    VariableSparsityConfig,
)

__all__ = ["block_sparse_attention", "block_sparse_fwd",
           "block_sparse_fwd_nolse", "block_sparse_bwd_dq",
           "block_sparse_bwd_dkv", "block_sparse_fwd_reference",
           "block_sparse_bwd_dq_reference", "block_sparse_bwd_dkv_reference",
           "build_fetch_table", "prepare_layout", "SparseSelfAttention",
           "BertSparseSelfAttention", "SparsityConfig", "DenseSparsityConfig",
           "FixedSparsityConfig", "BSLongformerSparsityConfig",
           "BigBirdSparsityConfig", "VariableSparsityConfig"]

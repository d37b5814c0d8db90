from .ragged_ops import (
    alibi_slopes,
    decode_attend_dense,
    decode_paged_attention,
    paged_kv_append,
    ragged_paged_attention,
    ragged_paged_attention_reference,
)

__all__ = ["alibi_slopes", "decode_attend_dense", "decode_paged_attention",
           "paged_kv_append", "ragged_paged_attention",
           "ragged_paged_attention_reference"]

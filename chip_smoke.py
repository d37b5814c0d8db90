#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero before the last line is printed:

  1. the card: ``nvidia-smi`` name and power limit, ``nvcc``;
  2. build the CUDA kernels from ``deepspeed_tpu_torch/csrc`` (one ``nvcc``
     per source, in parallel) and print the build time and ptxas report,
     with the registers, spills and static shared memory of the kernels
     redesigned for Hopper (``REDESIGNED``);
  3. hold each kernel against its plain PyTorch version on the card: at the
     serving path's shapes (hd 128, 8 KV heads, G 4, page 64, bf16) and on
     float32 edge batches (padding rows, zero-length rows, contexts ending
     on a page edge, a NaN-poisoned sequence); then K7's split-context
     design: the same q and K/V rows paged at 64 and at 128 must give
     bit-equal outputs, two calls bit-equal ones, on the split-edge
     lengths (0, 1, 63, 64, 65, 127, 128, 129, 1000, 2048) in bf16 and
     f32 against the plain version; NSPLIT and the live first-pass blocks
     are logged;
  4. the main path: ``InferenceEngineV2.generate`` at the full width and
     depth of ``TransformerConfig.llama3_8b()`` (random bf16 weights from a
     seeded generator), 8 prompts of 128-1024 tokens, 64 new tokens each:
     one untimed run at these shapes pays the first-touch costs, then
     ``REPEATS`` timed runs (median and spread printed); in each, both
     kernels' launch counters must rise from 0, every token must be in
     range; then one ``put`` with ``attn_impl="paged"`` and one with
     ``"gather"`` on the same batch must give finite, agreeing logits;
  5. time each serving kernel, its plain version and one PyTorch library
     call (``scaled_dot_product_attention`` on the gathered dense K/V,
     timing only) at the main path's shapes, with the L2 cache flushed
     before every timed launch, beside the card's bound;
  6. hold each training kernel against its plain version: flash attention
     forward (O, LSE), dQ and dK/dV at B 4, S 2048, H 32 (8 KV heads
     repeated), hd 128, bf16, causal, and on float32 edge batches (S 1,
     100, 257; causal and full; hd 64 and 128; G 1 and 4) and the same
     tails in bf16; the fused RMSNorm+matmul at M 8192, D 4096, F
     4096/1024/14336 in bf16 and at M 100, F 1000 in float32 and bf16;
     each elementwise against a stated limit; K4 twice bit for bit, and a
     planted fault (one 64-deep k-stage skipped) that must read at least
     10x its limit;
  7. the training path: ``initialize`` → ``DeepSpeedEngine.train_batch`` on
     ``TransformerConfig.llama3_8b()`` widths cut to 4 layers with remat
     (random float32 masters from a seeded generator, bench.py's ds_config:
     micro-batch 4, AdamW, clipping 1.0, ZeRO 0, bf16), 4 x 2048 tokens:
     first one step's loss and gradient norm against the same step with
     ``attn_impl="xla", fused_rmsnorm="off"``, then 2 untimed and 5 timed
     steps with the training kernels' counters set to 0 just before the
     timed steps and read just after; the loss must fall; one more step
     under ``torch.profiler`` gives device time by kernel and the
     device's busy share;
  8. hold each optimizer kernel against its plain version, bit for bit:
     K5 (``adam_w_mode`` on and off), K13, K14 and K15 at every leaf shape
     of the 4-layer training model and at 1, 7, 1000003 and (3, 5, 129)
     elements, weight decay on and off, over 3 successive steps;
  9. the training path again with ``FusedAdam`` (K5): its first loss
     equal to the AdamW run's bit for bit, the later ones within
     ``FUSED_LOSS_RTOL``; step time, tokens/s, TFLOP/s and the update's
     device time beside the AdamW run's;
 10. ``FusedLamb``, ``FusedLion``, ``FusedAdagrad`` engines on the same
     model, one at a time, 2 steps each: the first loss equal to
     FusedAdam's, finite losses, their kernel's counter risen from 0;
 11. checkpoint round trip at ``CKPT_LAYERS`` layer(s) of llama3-8B width:
     2 FusedAdam steps, ``save_checkpoint``, a fresh engine
     ``load_checkpoint``, 2 more steps bitwise equal to the first engine's
     uninterrupted steps 3-4; the directory read back with the port's
     ``load_universal``, then removed;
 12. time each training kernel beside its bound, its plain version and one
     PyTorch call (SDPA forward and backward; ``F.rms_norm`` plus
     ``torch.matmul``), and each optimizer kernel over every leaf of the
     4-layer model (``torch.optim.AdamW(fused=True)`` and
     ``torch.optim.Adagrad`` as the library calls of K5 and K15);
 13. (after phase 8) hold the block-sparse attention kernels K16-K19
     against their plain versions on 16 edge batches: float32 and bf16,
     block 16, 32, 64 and 128, hd 64 and 128, each layout class in turn,
     per-head layouts, an emptied q-block row (O = 0, LSE = -1e30 exactly)
     and S off the block grid;
 14. the sparse-attention path: ``SparseSelfAttention(cfg)(q, k, v,
     use_kernel=True)`` at llama3-8B attention width (B 1, H 32, S 8192,
     hd 128, bf16, block 64): under ``torch.no_grad()`` with the Fixed
     layout, K17 alone must launch, once a call; with q, k, v requiring
     grad and ``loss.backward()``, with the Fixed and the BigBird layout,
     K16, K18 and K19 once each a step; the serving output against the
     masked-dense path (8 heads at a time), the training gradients bitwise
     equal to the kernels called directly, and K16-K19 against their plain
     versions at this width;
 15. time K16-K19 at that shape beside their bound, their plain versions,
     SDPA with the expanded boolean token mask (timing only) and K1's
     causal dense forward (for scale); print the sparse results' line and
     the ``kernels`` JSON line (serving, training, optimizer, sparse and
     quantizer kernels, 18 in all);
 16. (after phase 13) hold the quantizer kernels against their plain
     versions, bit for bit (NaN equal to NaN): K8a ``quantize_int8`` and
     K9a ``quant_pack_wire(bits=8)`` (and K9a's bytes equal to K8a's), K8b
     ``dequantize_int8`` and K10a ``unpack_dequant_wire`` (int8, and int4
     from the plain K9b's bytes) to float32, bfloat16 and float16, on edge
     batches (group sizes 2, 64, 256, 1000, 1024, 4096; float32, bfloat16
     and float16 inputs, aligned and one element off; a zero, a
     half-step, a subnormal, a NaN and an infinity group and an off-grid
     tail: the zero and subnormal groups must get scale 1, the NaN group
     NaN and the infinity group inf, each with q 0); then K6 and K7 at
     page 128 against their plain versions;
 17. (after phase 5, on phase 4's model) weight-only int8 serving:
     ``quantize_params(bits=8)`` on the llama3-8B state must launch K8a
     once per quantized leaf (11: the JAX rule takes the stacked norms
     too); every leaf's q and scales bitwise equal to the plain version
     and |w - dq| <= s/2 (up to float32 rounding); ``dequantize_params``
     to bfloat16 must launch K8b once per leaf, bitwise equal to its plain
     version; ``generate`` on the dequantized weights (phase 4's prompts,
     every token in range; the share of greedy tokens equal to the bf16
     run's is printed, not gated); int8 bytes below 0.55 x bf16, int4
     (legacy plain ops on the card, no kernel launch) below 0.6 x int8;
     K8a and K8b timed on the ``[32, 4096, 14336]`` leaf;
 18. disaggregated prefill at llama3-8B width: engine P (page 64)
     prefills the 8 prompts less their last tokens; each sequence goes
     ``export_kv`` -> ``to_wire`` -> ``from_wire(device="cuda")`` ->
     ``import_kv`` into engine D (page 128) on the fp32 and the int8 wire;
     K9a and K10a must launch once per int8 shipment, the int8 wire equal
     the plain K9a's bytes and K10a's rows the plain version's, the error
     stay within ``int8_error_bound``, fp32 rows read back from D equal
     the shipped ones; D and P put the last tokens and decode: the
     fp32-shipped logits and greedy stream must equal P's bit for bit
     (the int8 stream's agreement is printed); the frame bytes and the
     hand-off of the 1,024-token prompt (export, ``to_wire``,
     ``from_wire``, import; median of 3) are printed, and K9a and K10a
     timed on its rows; the quantization results' line is printed;
 19. (last) hold the data-parallel kernels against their plain versions:
     K9b ``quant_pack_wire(bits=4)`` bit for bit on the int8 phase's edge
     batches (even group sizes) and on a 525 M-element float32 leaf of the
     embedding gradient's shape (2**20 groups at a time); K10b
     ``unpack_dequant_mean`` bit for bit on n = 2, 3, 4 peers of edge-batch
     wires (int4 and int8, with and without LoCo's addend) and on stacks of
     2 and 4 chunks of that leaf's wire; LoCo's residual (K10a's variant
     ``wire_residual``) bit for bit on the edge batches' int4 and int8
     wires and on that leaf's int4 wire; K11 ``shard_major_matmul`` at the
     down projection's shapes (x [4096, 14336] @ w [14336, 4096], bf16, 2
     shards) and float32 edges, K12 ``_gathered_dequant_matmul`` at x
     [4096, 14336] against 2 int4 and int8 shards of [7168, 4096] and an
     odd float32 edge, each within an elementwise limit set from the
     roundings' statistics (``matmul_limit``), with planted faults (a
     32-wide K tile dropped; K11's sums carried in bfloat16) read against
     the same limits and required to exceed them; each timed at those
     shapes beside its bound, its plain version and, for K11,
     ``torch.matmul`` (timing only);
 20. the data-parallel world: ``launcher.run_local_world`` spawns 2 gloo
     ranks, both on cuda:0 (NCCL takes one rank a GPU; every gloo
     collective the port uses takes CUDA tensors, none is staged through
     the host), after the parent built the kernels. Each rank:
     ``initialize`` at llama3-8B width cut to 2 layers (1.486 B params),
     bf16, AdamW, ``zero_quantized_gradients``, micro-batch 1 x 2048
     tokens a rank, 3 ``train_batch`` steps with the counters set to 0
     just before and read just after (K9b, K10b, K10a must launch), the
     ranks' parameter bits compared after every step (digests; the full
     bits after the last), step time and wire bytes from the facade's
     record; then one more backward, every leaf exchanged on the wire
     against its exact mean (``all_reduce``) within the wire's bound; the
     fused-gemm entry points ``gemm_reduce_scatter`` and
     ``gemm_all_gather_matmul`` on the down projection's shapes, wire 0, 8
     and 4 (K11 and K12 must launch; the fp edges equal K11 and the plain
     collective bit for bit, the int edges within their half-step
     bounds); then qgZ + LoCo at ``WORLD_SPEC["loco_layers"]`` layers, 2
     steps (K9b, K10b, K10a and LoCo's residual kernel must launch; the
     ranks' parameters bit-identical after every step). Each rank's peak
     memory is printed beside the card's name and power limit; the
     ``kernels`` line lists all 22 TPU kernels' ports and LoCo's residual
     variant of K10a, 23 rows;
 21. print ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
SEED = 1234
DEVICE = "cuda"
L2_FLUSH_BYTES = 256 << 20       # > the H100's 50 MB L2
REPEATS = 3                      # timed generate runs after the warm-up

# bf16 kernel checks: kernel and plain version both accumulate in float32
# and round the output to bf16 once, so they may land one bf16 ulp apart
# (<= 2**-7 of |ref|); the limit allows two ulps, plus float32
# summation-order noise near 0
BF16_RTOL = 2.0 ** -6
BF16_ATOL = 1e-5
# float32 edge batches: both sides accumulate in float32, differing only
# in summation order over <= ~500 keys
F32_ATOL = 1e-4

# training kernels, bf16 at the main shapes. Flash attention rounds P and
# dS to bf16 (relative error <= 2**-9 per term) before its second
# products, so an output may move by 2**-9 of the sum of its terms'
# magnitudes (|P|@|V|, |dS|@|K|, |dS|^T@|Q|, |P|^T@|dO|); the limit allows
# twice that on top of the two-ulp output rounding (BF16_RTOL)
FLASH_BF16_TERMS = 2.0 ** -8
# float32 edge batches: the same float32 products over <= 257 terms in
# another order, |error| <= 257 * 2**-24 of the sum of the terms'
# magnitudes < 2**-15, plus exp/log rounding
F32_TERMS = 2.0 ** -15
F32_RTOL = 1e-5
# fused RMSNorm+matmul in bf16: h = bf16(bf16(x*bf16(r))*scale) is the
# same on both sides unless the float32 normaliser r (summed in another
# order, relative error <= D*2**-24) lands on the other side of a bf16
# rounding edge; rows that close to an edge may move each h by two bf16
# ulps (2**-6 of the terms), the others only by the float32 summation
# order of the product (D*2**-24 of the terms)
K4_EDGE_TERMS = 2.0 ** -6

K6_REPLACES = "deepspeed_tpu/inference/v2/kernels/ragged_ops.py:65"
K7_REPLACES = "deepspeed_tpu/inference/v2/kernels/ragged_ops.py:381"
TRAIN_REPLACES = {
    "flash_attention_fwd":
        "deepspeed_tpu/ops/transformer/flash_attention.py:77",
    "flash_attention_bwd_dq":
        "deepspeed_tpu/ops/transformer/flash_attention.py:171",
    "flash_attention_bwd_dkv":
        "deepspeed_tpu/ops/transformer/flash_attention.py:208",
    "rmsnorm_matmul": "deepspeed_tpu/kernels/fused_collective_matmul.py:289",
}
TRAIN_SOURCES = {
    "flash_attention_fwd": "deepspeed_tpu_torch/csrc/flash_attention_fwd.cu",
    "flash_attention_bwd_dq":
        "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_attention_bwd_dkv":
        "deepspeed_tpu_torch/csrc/flash_attention_bwd.cu",
    "rmsnorm_matmul": "deepspeed_tpu_torch/csrc/rmsnorm_matmul.cu",
}
# the training main path's kernel shapes (llama3-8B widths)
FA_MAIN = dict(B=4, S=2048, H=32, KV=8, hd=128)
K4_MAIN = dict(M=8192, D=4096, Fs=(4096, 1024, 14336))
TRAIN_LAYERS = 4
WARMUP_STEPS = 2
TIMED_STEPS = 5

# optimizer kernels (K5, K13-K15). Each kernel rounds every product, sum,
# quotient and square root once, in its plain version's order (the __f*_rn
# intrinsics, which nvcc never contracts into an FMA), and the plain
# version is PyTorch's elementwise kernels, each rounding once: so the
# limit is 0 ulps, bit for bit, over OPT_STEPS successive steps
OPT_ULPS = 0
OPT_STEPS = 3
OPT_LR, OPT_WD = 3e-4, 0.1                 # the main path's
OPT_EDGE_SHAPES = ((1,), (7,), (1000003,), (3, 5, 129))
OPT_SOURCE = "deepspeed_tpu_torch/csrc/fused_optimizers.cu"
OPT_REPLACES = {
    "fused_adam": "deepspeed_tpu/ops/adam/fused_adam.py:54",
    "fused_lamb": "deepspeed_tpu/ops/lamb/fused_lamb.py:24",
    "fused_lion": "deepspeed_tpu/ops/adam/fused_adam.py:165",
    "fused_adagrad": "deepspeed_tpu/ops/adam/fused_adam.py:197",
}
# bytes per parameter, each array read once and written once: K5 reads p,
# g, m, v and writes p, m, v; K13 the same (u for p) plus the norms' and
# the final write's read of p and u and write of p; K14, K15 read p, g
# and one state, write p and the state
OPT_BYTES = {"fused_adam": 28, "fused_lamb": 40, "fused_lion": 20,
             "fused_adagrad": 20}
# float32 operations per parameter (products, sums, quotients, roots)
OPT_FLOPS = {"fused_adam": 16, "fused_lamb": 20, "fused_lion": 11,
             "fused_adagrad": 9}
F32_FLOPS = 67e12                  # H100 SXM float32, outside tensor cores
# FusedAdam against AdamW over the 7 steps of the training path: the two
# round the float32 update differently (bias corrections in float32 vs
# float64, divisions by a scalar through its reciprocal in the plain
# AdamW), so masters part by an ulp or so each step and the bf16 copies
# of weights near a rounding edge flip; 2% of a loss leaves room for
# that on a batch the model memorises, and catches a wrong update
FUSED_LOSS_RTOL = 2e-2
CKPT_LAYERS = 1                    # the checkpoint round trip's depth

# block-sparse attention (K16-K19): llama3-8B attention width at its
# max_seq_len (transformer.py:103-107), bf16
SPARSE_MAIN = dict(B=1, H=32, S=8192, hd=128, block=64)
SPARSE_CALLS = 3                   # timed serving calls after a warm-up
SPARSE_STEPS = 3                   # timed training steps per layout
SPARSE_REPLACES = {
    "block_sparse_fwd":
        "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:60",
    "block_sparse_fwd_nolse":
        "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:101",
    "block_sparse_bwd_dq":
        "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:141",
    "block_sparse_bwd_dkv":
        "deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py:172",
}
SPARSE_SOURCES = {
    "block_sparse_fwd": "deepspeed_tpu_torch/csrc/block_sparse_attention_fwd.cu",
    "block_sparse_fwd_nolse":
        "deepspeed_tpu_torch/csrc/block_sparse_attention_fwd.cu",
    "block_sparse_bwd_dq":
        "deepspeed_tpu_torch/csrc/block_sparse_attention_bwd.cu",
    "block_sparse_bwd_dkv":
        "deepspeed_tpu_torch/csrc/block_sparse_attention_bwd.cu",
}
# float32 edge batches: the kernels and the plain versions sum the same
# float32 terms over <= 1024 keys (8 blocks of 128) in another order (the
# kernels chunk by 64 keys with an online softmax), |error| <= 1024 *
# 2**-24 = 2**-14 of the sum of the terms' magnitudes; twice that covers
# the exp/log roundings
SPARSE_F32_TERMS = 2.0 ** -13
# the masked-dense path in bf16 rounds the raw scores and their scaled
# copy to bf16 (2 * |s| * 2**-9 in each scaled score, |s| <= ~7 for these
# N(0, 1) scores: a relative error of each P up to ~2**-5.2, twice that
# with the normaliser) and its probabilities (2**-9): 2**-4 of |P|@|V|
DENSE_BF16_TERMS = 2.0 ** -4
# edge layouts of the build-and-check phase, one per layout class
SPARSE_EDGE_LAYOUTS = (
    ("FixedSparsityConfig", dict(num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional")),
    ("BigBirdSparsityConfig", {}),
    ("BSLongformerSparsityConfig", dict(global_block_indices=[0, 5])),
    ("VariableSparsityConfig", dict(num_random_blocks=1,
                                    local_window_blocks=[1, 2, 4],
                                    global_block_indices=[0, 3])),
)


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------- #
def paged_inputs(torch, gen, *, KV, G, hd, ps, NB, n_pages, q_lens, kv_lens,
                 dtype, pad_tokens=0):
    """Random q and pool, distinct random pages per sequence; q_lens=None
    makes a decode batch (one query row per sequence)."""
    dev = DEVICE
    S = len(kv_lens)
    H = KV * G
    T = (S if q_lens is None else sum(q_lens)) + pad_tokens
    q = torch.randn(T, H, hd, generator=gen, device=dev, dtype=dtype)
    pages = torch.randn(n_pages, ps, 2 * KV, hd, generator=gen, device=dev,
                        dtype=dtype)
    pt = torch.randperm(n_pages - 1, generator=gen, device=dev)[:S * NB]
    pt = pt.view(S, NB).to(torch.int32).contiguous()
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    cu = None
    if q_lens is not None:
        cu = torch.tensor([0] + list(_cumsum(q_lens)), dtype=torch.int32,
                          device=dev)
    return q, pages, kvl, pt, cu


def _cumsum(xs):
    total = 0
    for x in xs:
        total += x
        yield total


def ragged_work(q_lens, kv_lens, T, H, KV, hd, NB, elem):
    """(bytes, flops) the ragged attention must move and do for this batch:
    q and out once, each sequence's K/V context once, the metadata once;
    4*hd flops per (query head, visible key) pair."""
    pairs = sum(sum(kvl - n + i + 1 for i in range(n))
                for n, kvl in zip(q_lens, kv_lens))
    ctx = sum(kvl for n, kvl in zip(q_lens, kv_lens) if n > 0)
    S = len(kv_lens)
    nbytes = (2 * T * H * hd * elem + ctx * 2 * KV * hd * elem
              + 4 * (2 * S + 1 + S * NB))
    return nbytes, 4 * hd * H * pairs


def decode_work(kv_lens, H, KV, hd, NB, elem):
    """(bytes, flops) of a decode step: q and out once, each sequence's
    K/V context once, the metadata once; 4*hd flops per (head, key)."""
    S = len(kv_lens)
    ctx = sum(kv_lens)
    nbytes = (2 * S * H * hd * elem + ctx * 2 * KV * hd * elem
              + 4 * (S + S * NB))
    return nbytes, 4 * hd * H * ctx


def bound_ms(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


_flush_buf = None


def cuda_ms(torch, fn, iters, warmup=2):
    """Median device time of ``fn`` in ms. Before every timed call a
    256 MB buffer is written, outside the timed events, so that ``fn``
    finds its inputs in HBM and not in the 50 MB L2, as the main path
    does (each layer's pages are read after the weights streamed by)."""
    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device=DEVICE)
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        _flush_buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    times = sorted(a.elapsed_time(b) for a, b in events)
    return times[len(times) // 2]


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
def phase_card(torch):
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from deepspeed_tpu_torch.ops.op_builder.builder import find_nvcc

    log(f"nvcc: {find_nvcc()}")


def ptxas_report(log_text, names):
    """{kernel: {"registers", "spill_bytes", "stack_bytes", "smem_bytes"}}
    from ``nvcc -Xptxas -v`` output, for each entry function whose mangled
    name contains one of ``names`` (instantiations merged: the largest of
    each number)."""
    import re

    out, cur = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = next((n for n in names if n in m.group(1)), None)
            if cur:
                out.setdefault(cur, {"registers": 0, "spill_bytes": 0,
                                     "stack_bytes": 0, "smem_bytes": 0})
            continue
        if cur is None:
            continue
        rec = out[cur]
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            rec["stack_bytes"] = max(rec["stack_bytes"], int(m.group(1)))
            rec["spill_bytes"] = max(rec["spill_bytes"], int(m.group(2)),
                                     int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            rec["registers"] = max(rec["registers"], int(m.group(1)))
            sm = re.search(r"(\d+) bytes smem", line)
            if sm:
                rec["smem_bytes"] = max(rec["smem_bytes"], int(sm.group(1)))
    return out


# the kernels redesigned for Hopper (split-context K7, TMA + wgmma K4), by
# source; their dynamic shared memory comes on top of ptxas's static figure
REDESIGNED = {
    "decode_paged_attention": ("decode_split_kernel", "decode_merge_kernel"),
    "rmsnorm_matmul": ("rms_rows_kernel", "rmsnorm_matmul_wgmma_kernel"),
}


def phase_build(torch):
    from deepspeed_tpu_torch.ops.op_builder import get_builder, load_kernels

    t0 = time.perf_counter()
    libs = load_kernels()
    builder = get_builder()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {builder.build_seconds:.1f} s)")
    for name, text in builder.build_log.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "wgmma" in line or "setmaxnreg" in line):
                log(f"  ptxas[{name}]: {line.strip()}")
    report = {}
    for src, names in REDESIGNED.items():
        report.update(ptxas_report(builder.build_log.get(src, ""), names))
    for name, rec in report.items():
        log(f"ptxas {name}: {rec['registers']} registers, "
            f"{rec['spill_bytes']} bytes spilled, {rec['stack_bytes']} "
            f"bytes stack, {rec['smem_bytes']} bytes static smem")
    torch.cuda.synchronize()
    return report


def _compare(torch, name, k, p, atol, rtol=0.0):
    """|k - p| <= atol + rtol*|p| elementwise; returns the max abs error."""
    check(bool(torch.isfinite(k).all()), f"{name}: non-finite kernel output")
    diff = (k.float() - p.float()).abs()
    limit = atol + rtol * p.float().abs()
    err = float(diff.max())
    worst = float((diff / limit).max())
    log(f"check {name}: max_abs_err {err:.3e}, worst err/limit {worst:.3f} "
        f"(limit atol {atol:.0e} + rtol {rtol:.3g}*|ref|)")
    check(worst <= 1.0, f"{name}: error exceeds its limit by {worst:.3f}x")
    return err


def phase_kernel_checks(torch, ops, shapes):
    """Each kernel against its plain version on the card. Returns the
    main-shape errors by kernel name."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {}
    m = shapes
    q, pages, kvl, pt, cu = paged_inputs(
        torch, gen, KV=m["KV"], G=m["G"], hd=m["hd"], ps=m["ps"], NB=m["NB"],
        n_pages=m["n_pages"], q_lens=m["k6_q_lens"],
        kv_lens=m["k6_kv_lens"], dtype=torch.bfloat16,
        pad_tokens=m["k6_pad"])
    args = (q, pages, kvl, pt, cu)
    kw = dict(num_kv_heads=m["KV"])
    errs["ragged_paged_attention"] = _compare(
        torch, "ragged_paged_attention bf16 main shapes",
        ops.ragged_paged_attention(*args, **kw),
        ops.ragged_paged_attention_reference(*args, **kw), BF16_ATOL,
        BF16_RTOL)
    m["k6_inputs"] = args
    q, pages, kvl, pt, _ = paged_inputs(
        torch, gen, KV=m["KV"], G=m["G"], hd=m["hd"], ps=m["ps"], NB=m["NB"],
        n_pages=m["n_pages"], q_lens=None, kv_lens=m["k7_kv_lens"],
        dtype=torch.bfloat16)
    args = (q, pages, kvl, pt)
    errs["decode_paged_attention"] = _compare(
        torch, "decode_paged_attention bf16 main shapes",
        ops.decode_paged_attention(*args, **kw),
        ops.decode_attend_dense(*args, **kw), BF16_ATOL, BF16_RTOL)
    m["k7_inputs"] = args
    del pages
    torch.cuda.synchronize()

    for KV, G, hd, ps in ((2, 8, 64, 16), (4, 1, 128, 64), (8, 4, 128, 64)):
        NB = 40 * 16 // ps
        n_pages = 9 * NB + 1
        q_lens = [7, 0, 1, 16, 1, 33, 0, 0]          # interior/trailing zeros
        kv_lens = [7, 0, 64, 16, 200, 100, 0, 0]     # 64, 16: page edges
        q, pages, kvl, pt, cu = paged_inputs(
            torch, gen, KV=KV, G=G, hd=hd, ps=ps, NB=NB, n_pages=n_pages,
            q_lens=q_lens, kv_lens=kv_lens, dtype=torch.float32, pad_tokens=5)
        kw = dict(num_kv_heads=KV)
        tag = f"f32 KV={KV} G={G} hd={hd} ps={ps}"
        clean = ops.ragged_paged_attention(q, pages, kvl, pt, cu, **kw)
        _compare(torch, f"ragged_paged_attention {tag}", clean,
                 ops.ragged_paged_attention_reference(q, pages, kvl, pt, cu,
                                                      **kw), F32_ATOL)
        check(bool((clean[-5:] == 0).all()), "ragged: padding rows not 0")
        poisoned = pages.clone()
        poisoned[pt[3].long()] = float("nan")        # sequence 3: rows 8..23
        out = ops.ragged_paged_attention(q, poisoned, kvl, pt, cu, **kw)
        mates = torch.cat([torch.arange(0, 8), torch.arange(24, q.shape[0])])
        check(bool(torch.equal(out[mates], clean[mates])),
              f"ragged {tag}: NaN page reached another sequence")
        check(bool(torch.isnan(out[8:24]).all()),
              f"ragged {tag}: poisoned sequence lost its NaN")

        dec_lens = [33, 0, 64, 1, 0, 500, 16, 128]
        q, pages, kvl, pt, _ = paged_inputs(
            torch, gen, KV=KV, G=G, hd=hd, ps=ps, NB=NB, n_pages=n_pages,
            q_lens=None, kv_lens=dec_lens, dtype=torch.float32)
        clean = ops.decode_paged_attention(q, pages, kvl, pt, **kw)
        _compare(torch, f"decode_paged_attention {tag}", clean,
                 ops.decode_attend_dense(q, pages, kvl, pt, **kw), F32_ATOL)
        check(bool((clean[[1, 4]] == 0).all()), "decode: kv_lens==0 rows not 0")
        poisoned = pages.clone()
        poisoned[pt[5].long()] = float("nan")
        poisoned[pt[1, 0].long()] = float("nan")     # a padding row's page
        out = ops.decode_paged_attention(q, poisoned, kvl, pt, **kw)
        mates = [0, 1, 2, 3, 4, 6, 7]
        check(bool(torch.equal(out[mates], clean[mates])),
              f"decode {tag}: NaN page reached another sequence")
        check(bool(torch.isnan(out[5]).all()),
              f"decode {tag}: poisoned sequence lost its NaN")
    torch.cuda.synchronize()
    return errs


def log_decode_split(ops, what, kv_lens, KV, NB, ps, split):
    """Log K7's first-pass geometry on a batch: NSPLIT, the kernel's own
    split count for this page table, and the splits that start inside
    their sequence's context, worked out from the lengths (input
    geometry, not a count the kernel reported)."""
    nsplit = ops.decode_split_count(NB, ps)
    live = KV * sum(-(-min(n, NB * ps) // split) for n in kv_lens)
    log(f"{what}: NSPLIT {nsplit} (kernel's split count), {live} of "
        f"{len(kv_lens) * KV * nsplit} first-pass blocks start inside their "
        f"context (from the lengths)")


def phase_decode_split_checks(torch, ops, shapes):
    """K7's split-context design on the card: the same q and K/V rows
    paged at 64 and at 128 give bit-equal outputs (split boundaries and
    sums depend on positions alone), two calls are bit-equal, and the
    split-edge lengths agree with the plain version in bf16 and f32."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    C = 2048
    split = C // ops.decode_split_count(C, 1)   # positions a split
    lens = [0, 1, split - 1, split, split + 1, 2 * split - 1, 2 * split,
            2 * split + 1, 1000, C]
    for dtype, tag, atol, rtol in ((torch.bfloat16, "bf16", BF16_ATOL,
                                    BF16_RTOL),
                                   (torch.float32, "f32", F32_ATOL, 0.0)):
        for KV, G, hd in ((8, 4, 128), (2, 8, 64)):
            S = len(lens)
            rows = torch.randn(S, C, 2 * KV, hd, generator=gen,
                               device=DEVICE).to(dtype)
            q = torch.randn(S, KV * G, hd, generator=gen,
                            device=DEVICE).to(dtype)
            kvl = torch.tensor(lens, dtype=torch.int32, device=DEVICE)
            outs = {}
            for ps in (64, 128):
                NB = C // ps
                pages = torch.randn(S * NB + 1, ps, 2 * KV, hd, generator=gen,
                                    device=DEVICE).to(dtype)
                pt = torch.randperm(S * NB, generator=gen, device=DEVICE)
                pt = pt.view(S, NB).to(torch.int32).contiguous()
                pages[pt.long()] = rows.view(S, NB, ps, 2 * KV, hd)
                kw = dict(num_kv_heads=KV)
                outs[ps] = ops.decode_paged_attention(q, pages, kvl, pt, **kw)
                if ps == 64:
                    again = ops.decode_paged_attention(q, pages, kvl, pt,
                                                       **kw)
                    check(torch.equal(again, outs[ps]),
                          f"decode {tag} KV={KV} G={G} hd={hd}: two calls "
                          f"differ")
                    _compare(torch, f"decode_paged_attention split edges "
                             f"{tag} KV={KV} G={G} hd={hd}", outs[ps],
                             ops.decode_attend_dense(q, pages, kvl, pt, **kw),
                             atol, rtol)
                log_decode_split(ops, f"  page {ps}", lens, KV, NB, ps,
                                 split)
                del pages
            check(torch.equal(outs[64], outs[128]),
                  f"decode {tag} KV={KV} G={G} hd={hd}: page 64 and page "
                  f"128 outputs differ")
            log(f"check decode {tag} KV={KV} G={G} hd={hd}: page 64 == page "
                f"128 bit for bit, two calls bit for bit")
    m = shapes
    log_decode_split(ops, "decode main shapes", m["k7_kv_lens"], m["KV"],
                     m["NB"], m["ps"], split)
    torch.cuda.synchronize()


def _run_generate(torch, ops, engine, prompts, new_tokens, vocab):
    """One ``generate`` with both launch counters set to 0 just before it
    and read just after; checks its tokens and returns its numbers."""
    seg0 = torch.cuda.memory_stats().get("segment.all.allocated", 0)
    ops.ragged_paged_attention.launches = 0
    ops.decode_paged_attention.launches = 0
    t0 = time.perf_counter()
    out = engine.generate(prompts, max_new_tokens=new_tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"ragged_paged_attention": ops.ragged_paged_attention.launches,
                "decode_paged_attention": ops.decode_paged_attention.launches}
    for name, n in launches.items():
        check(n > 0, f"main path never launched {name}")
    check(len(out) == len(prompts)
          and all(len(o) == new_tokens for o in out),
          "generate returned the wrong number of tokens")
    check(all(0 <= t < vocab for o in out for t in o),
          "generate returned a token out of range")
    st = engine.last_generate_stats
    run = {"generate_s": wall,
           "prefill_tok_per_s": st["put_tokens"] / st["put_s"],
           "decode_tok_per_s": st["window_tokens"] / st["window_s"],
           "new_segments": torch.cuda.memory_stats().get(
               "segment.all.allocated", 0) - seg0,
           **st}
    log(f"  {wall:.3f} s; prefill {run['prefill_tok_per_s']:.1f} tok/s "
        f"({st['put_tokens']} tokens in {st['put_calls']} put forwards, "
        f"{st['put_s']:.3f} s); decode {run['decode_tok_per_s']:.1f} tok/s "
        f"({st['window_tokens']} tokens in {st['window_calls']} fused "
        f"windows, {st['window_s']:.3f} s); launches {launches}; "
        f"{run['new_segments']} new allocator segments")
    return out, launches, run


def phase_main_path(torch, ops):
    import numpy as np

    from deepspeed_tpu_torch import (CausalLM, InferenceEngineV2,
                                     RaggedInferenceEngineConfig,
                                     TransformerConfig)
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = CausalLM(cfg, init_params(cfg, gen, torch.bfloat16, DEVICE))
    torch.cuda.synchronize()
    log(f"model: llama3_8b, {cfg.num_layers} layers, "
        f"{model.num_params() / 1e9:.2f} B params bf16, init "
        f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    prompt_lens = [128, 256, 384, 512, 640, 768, 896, 1024]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in prompt_lens]
    new_tokens = 64
    engine = InferenceEngineV2(model, RaggedInferenceEngineConfig(),
                               device=DEVICE)
    log(f"generate: {len(prompts)} prompts {prompt_lens}, {new_tokens} new "
        f"tokens each")
    log("warm-up (untimed; the first run at these shapes):")
    first_out, launches, first = _run_generate(
        torch, ops, engine, prompts, new_tokens, cfg.vocab_size)
    runs, same = [], True
    for i in range(REPEATS):
        log(f"timed run {i + 1}/{REPEATS}:")
        out, n, run = _run_generate(torch, ops, engine, prompts, new_tokens,
                                    cfg.vocab_size)
        check(n == launches, f"launch counts changed between runs: "
              f"{n} vs {launches}")
        runs.append(run)
        same = same and out == first_out
    log(f"greedy tokens of every timed run equal the warm-up's: {same}")

    def spread(key):
        xs = sorted(r[key] for r in runs)
        return {"median": xs[len(xs) // 2], "min": xs[0], "max": xs[-1]}

    serving = {k: spread(k) for k in ("generate_s", "prefill_tok_per_s",
                                      "decode_tok_per_s", "put_s",
                                      "window_s")}
    serving["repeats"] = REPEATS
    serving["launches_per_generate"] = launches
    serving["first_run"] = first
    log(f"median of {REPEATS}: prefill "
        f"{serving['prefill_tok_per_s']['median']:.1f} tok/s "
        f"[{serving['prefill_tok_per_s']['min']:.1f}, "
        f"{serving['prefill_tok_per_s']['max']:.1f}], decode "
        f"{serving['decode_tok_per_s']['median']:.1f} tok/s "
        f"[{serving['decode_tok_per_s']['min']:.1f}, "
        f"{serving['decode_tok_per_s']['max']:.1f}]")
    del engine
    torch.cuda.empty_cache()

    # paged vs gather on one batch, same weights, fresh engine each
    batch = [prompts[1][:100], prompts[2][:120], prompts[3][:36]]
    logits = {}
    for impl in ("paged", "gather"):
        eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            attn_impl=impl), device=DEVICE)
        logits[impl] = eng.put([0, 1, 2], batch)
        check(tuple(logits[impl].shape) == (3, cfg.vocab_size),
              f"put({impl}) logits shape {tuple(logits[impl].shape)}")
        check(bool(torch.isfinite(logits[impl]).all()),
              f"put({impl}) logits not finite")
        del eng
        torch.cuda.empty_cache()
    diff = logits["paged"] - logits["gather"]
    rel = float(diff.norm() / logits["gather"].norm())
    agree = float((logits["paged"].argmax(-1) ==
                   logits["gather"].argmax(-1)).float().mean())
    # bf16 activations (8 mantissa bits) through every layer's residual
    # stream: the two attention paths round at different places
    log(f"paged vs gather put: rel l2 err {rel:.3e} (tol 5e-2), "
        f"max abs {float(diff.abs().max()):.3e}, argmax agree {agree:.2f}")
    check(rel <= 5e-2, f"paged vs gather logits differ: rel {rel}")
    torch.cuda.synchronize()
    return launches, serving, model, prompts, first_out


def phase_timing(torch, ops, shapes, launches, errs):
    import torch.nn.functional as F

    m = shapes
    H, KV, hd = m["KV"] * m["G"], m["KV"], m["hd"]
    G = m["G"]
    kernels = []

    # K6 -------------------------------------------------------------- #
    q, pages, kvl, pt, cu = m["k6_inputs"]
    kw = dict(num_kv_heads=KV)
    ms = cuda_ms(torch, lambda: ops.ragged_paged_attention(
        q, pages, kvl, pt, cu, **kw), 20)
    plain = cuda_ms(torch, lambda: ops.ragged_paged_attention_reference(
        q, pages, kvl, pt, cu, **kw), 3, warmup=1)
    real = [(n, L, s) for s, (n, L) in
            enumerate(zip(m["k6_q_lens"], m["k6_kv_lens"])) if n > 0]
    mq = max(n for n, _, _ in real)
    Lmax = max(L for _, L, _ in real)
    qd = torch.zeros(len(real), H, mq, hd, dtype=q.dtype, device=DEVICE)
    kd = torch.zeros(len(real), H, Lmax, hd, dtype=q.dtype, device=DEVICE)
    vd = torch.zeros_like(kd)
    mask = torch.zeros(len(real), 1, mq, Lmax, dtype=torch.bool,
                       device=DEVICE)
    starts = [0] + list(_cumsum(m["k6_q_lens"]))
    for i, (n, L, s) in enumerate(real):
        qd[i, :, :n] = q[starts[s]:starts[s] + n].transpose(0, 1)
        npg = -(-L // m["ps"])
        ctx = pages[pt[s, :npg].long()].reshape(-1, 2 * KV, hd)[:L]
        kd[i, :, :L] = ctx[:, :KV].repeat_interleave(G, 1).transpose(0, 1)
        vd[i, :, :L] = ctx[:, KV:].repeat_interleave(G, 1).transpose(0, 1)
        qp = torch.arange(n, device=DEVICE)[:, None] + (L - n)
        mask[i, 0, :n, :L] = torch.arange(L, device=DEVICE)[None, :] <= qp
        mask[i, 0, n:, 0] = True                     # padded query rows
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask), 20)
    nbytes, flops = ragged_work(m["k6_q_lens"], m["k6_kv_lens"],
                                int(q.shape[0]), H, KV, hd, m["NB"], 2)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    kernels.append({
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": K6_REPLACES,
        "launches": launches["ragged_paged_attention"],
        "max_abs_err": errs["ragged_paged_attention"],
        "max_err": errs["ragged_paged_attention"],
        "atol": BF16_ATOL, "rtol": BF16_RTOL,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib,
        "shape": {"q_lens": m["k6_q_lens"], "kv_lens": m["k6_kv_lens"],
                  "T": int(q.shape[0]), "H": H, "KV": KV, "hd": hd,
                  "ps": m["ps"], "dtype": "bf16"},
        "bytes": nbytes, "flops": flops})
    del qd, kd, vd, mask

    # K7 -------------------------------------------------------------- #
    q, pages, kvl, pt = m["k7_inputs"]
    ms = cuda_ms(torch, lambda: ops.decode_paged_attention(
        q, pages, kvl, pt, **kw), 50)
    plain = cuda_ms(torch, lambda: ops.decode_attend_dense(
        q, pages, kvl, pt, **kw), 5, warmup=1)
    S = q.shape[0]
    Lmax = max(m["k7_kv_lens"])
    kd = torch.zeros(S, H, Lmax, hd, dtype=q.dtype, device=DEVICE)
    vd = torch.zeros_like(kd)
    mask = torch.zeros(S, 1, 1, Lmax, dtype=torch.bool, device=DEVICE)
    for s, L in enumerate(m["k7_kv_lens"]):
        npg = -(-L // m["ps"])
        ctx = pages[pt[s, :npg].long()].reshape(-1, 2 * KV, hd)[:L]
        kd[s, :, :L] = ctx[:, :KV].repeat_interleave(G, 1).transpose(0, 1)
        vd[s, :, :L] = ctx[:, KV:].repeat_interleave(G, 1).transpose(0, 1)
        mask[s, 0, 0, :L] = True
    qd = q[:, :, None, :].contiguous()
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask), 50)
    nbytes, flops = decode_work(m["k7_kv_lens"], H, KV, hd, m["NB"], 2)
    b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
    kernels.append({
        "name": "decode_paged_attention", "route": "cuda",
        "source": "deepspeed_tpu_torch/csrc/decode_paged_attention.cu",
        "replaces": K7_REPLACES,
        "launches": launches["decode_paged_attention"],
        "max_abs_err": errs["decode_paged_attention"],
        "max_err": errs["decode_paged_attention"],
        "atol": BF16_ATOL, "rtol": BF16_RTOL,
        "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": lib,
        "shape": {"kv_lens": m["k7_kv_lens"], "S": S, "H": H, "KV": KV,
                  "hd": hd, "ps": m["ps"], "dtype": "bf16"},
        "bytes": nbytes, "flops": flops})
    torch.cuda.synchronize()
    return kernels


# --------------------------------------------------------------------- #
# training kernels
# --------------------------------------------------------------------- #
def _compare_limit(torch, name, k, p, limit, why):
    """|k - p| <= limit elementwise (a tensor); returns the max abs error."""
    check(bool(torch.isfinite(k).all()), f"{name}: non-finite kernel output")
    diff = (k.float() - p.float()).abs()
    err = float(diff.max())
    worst = float((diff / limit).max())
    log(f"check {name}: max_abs_err {err:.3e}, worst err/limit {worst:.3f} "
        f"(limit {why})")
    check(worst <= 1.0, f"{name}: error exceeds its limit by {worst:.3f}x")
    return err


def flash_inputs(torch, gen, B, S, H, KV, hd, dtype):
    """q, do [B, S, H, hd]; k, v with KV heads repeated to H, as the model
    hands them to the kernels."""
    def rnd(h):
        return torch.randn(B, S, h, hd, generator=gen, device=DEVICE,
                           dtype=torch.float32).to(dtype)

    q, k, v, do = rnd(H), rnd(KV), rnd(KV), rnd(H)
    k = k.repeat_interleave(H // KV, dim=2).contiguous()
    v = v.repeat_interleave(H // KV, dim=2).contiguous()
    return q, k, v, do


def check_flash(torch, fa, tag, q, k, v, do, causal, terms, rtol, atol):
    """K1, K2 and K3 against their plain versions on one batch. Each
    backward kernel gets the plain forward's LSE and delta, so each check
    sees one kernel. → max abs error by kernel name."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, causal, scale)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale)
    delta = (do.float() * o_ref.float()).sum(-1).transpose(1, 2).contiguous()
    p, ds = fa.probs_and_ds(q, k, v, do, lse_ref, delta, causal, scale)

    def t(x):
        return x.float().abs()

    errs = {}
    bound = torch.einsum("bhqk,bkhd->bqhd", p.abs(), t(v))
    errs["flash_attention_fwd"] = _compare_limit(
        torch, f"flash_attention_fwd O {tag}", o, o_ref,
        atol + rtol * t(o_ref) + terms * bound,
        f"{atol:.0e} + {rtol:.3g}*|ref| + {terms:.3g}*|P|@|V|")
    _compare_limit(torch, f"flash_attention_fwd LSE {tag}", lse, lse_ref,
                   1e-4 + 1e-5 * lse_ref.abs(), "1e-4 + 1e-5*|ref|, float32")
    del o, lse
    dq_ref = fa.flash_attention_bwd_dq_reference(q, k, v, do, lse_ref, delta,
                                                 causal, scale)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse_ref, delta, causal, scale)
    bound = torch.einsum("bhqk,bkhd->bqhd", ds.abs(), t(k))
    errs["flash_attention_bwd_dq"] = _compare_limit(
        torch, f"flash_attention_bwd_dq {tag}", dq, dq_ref,
        atol + rtol * t(dq_ref) + terms * bound,
        f"{atol:.0e} + {rtol:.3g}*|ref| + {terms:.3g}*|dS|@|K|")
    del dq, dq_ref
    dk_ref, dv_ref = fa.flash_attention_bwd_dkv_reference(
        q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse_ref, delta, causal,
                                        scale)
    bound = torch.einsum("bhqk,bqhd->bkhd", ds.abs(), t(q))
    err_k = _compare_limit(
        torch, f"flash_attention_bwd_dkv dK {tag}", dk, dk_ref,
        atol + rtol * t(dk_ref) + terms * bound,
        f"{atol:.0e} + {rtol:.3g}*|ref| + {terms:.3g}*|dS|^T@|Q|")
    bound = torch.einsum("bhqk,bqhd->bkhd", p.abs(), t(do))
    err_v = _compare_limit(
        torch, f"flash_attention_bwd_dkv dV {tag}", dv, dv_ref,
        atol + rtol * t(dv_ref) + terms * bound,
        f"{atol:.0e} + {rtol:.3g}*|ref| + {terms:.3g}*|P|^T@|dO|")
    errs["flash_attention_bwd_dkv"] = max(err_k, err_v)
    return errs


def rmsnorm_matmul_limit(torch, tag, x, scale, w, eps, ref):
    """The per-row elementwise limit K4 is held to (see K4_EDGE_TERMS)
    → (limit tensor, its description)."""
    D = x.shape[1]
    r = torch.rsqrt(x.float().square().mean(-1, keepdim=True) + eps)
    h = (x * r.to(x.dtype)) * scale
    terms = h.float().abs() @ w.float().abs()
    sum_rel = D * 2.0 ** -24
    if x.dtype == torch.bfloat16:
        rb = r.bfloat16().float()
        ulp = torch.exp2(torch.floor(torch.log2(rb)) - 7)
        frac = (r - rb).abs() / ulp                     # 0 .. 0.5
        # the kernel's normaliser may differ by sum_rel/2 relative
        near = frac > 0.5 - (sum_rel / 2 + 2.0 ** -22) / 2.0 ** -8
        coef = torch.where(near, K4_EDGE_TERMS, sum_rel)
        log(f"  {tag}: {int(near.sum())} of {x.shape[0]} rows within reach "
            f"of a bf16 rounding edge of the normaliser")
        limit = BF16_ATOL + BF16_RTOL * ref.float().abs() + coef * terms
        why = (f"{BF16_ATOL:.0e} + {BF16_RTOL:.3g}*|ref| + ({sum_rel:.3g}, "
               f"or {K4_EDGE_TERMS:.3g} on edge rows)*|h|@|w|")
    else:
        coef = sum_rel + 2.0 ** -20
        limit = 1e-5 + F32_RTOL * ref.abs() + coef * terms
        why = f"1e-5 + {F32_RTOL:.0e}*|ref| + {coef:.3g}*|h|@|w|, float32"
    return limit, why


def check_rmsnorm_matmul(torch, fcm, tag, x, scale, w, eps):
    """K4 against its plain version, with a per-row limit (see
    K4_EDGE_TERMS). → max abs error."""
    ref = fcm.rmsnorm_matmul_reference(x, scale, w, eps)
    out = fcm.rmsnorm_matmul_fwd(x, scale, w, eps)
    limit, why = rmsnorm_matmul_limit(torch, tag, x, scale, w, eps, ref)
    return _compare_limit(torch, f"rmsnorm_matmul {tag}", out, ref, limit,
                          why)


K4_STAGE = 64                      # the wgmma kernel's k-stage depth (BK)


def check_rmsnorm_matmul_faults(torch, fcm, x, scale, w, eps):
    """K4 twice on the same inputs, bit for bit; and a planted fault, the
    product with one k-stage skipped (h's columns [2048, 2048 + 64)
    dropped, as a kernel that lost a stage or waited on the wrong mbarrier
    phase would compute), which must read at least 10x above the limit.
    → the fault's reading (x the limit)."""
    a = fcm.rmsnorm_matmul_fwd(x, scale, w, eps)
    b = fcm.rmsnorm_matmul_fwd(x, scale, w, eps)
    check(torch.equal(a, b), "rmsnorm_matmul: two calls differ")
    log("check rmsnorm_matmul: two calls bit for bit")
    ref = fcm.rmsnorm_matmul_reference(x, scale, w, eps)
    limit, _ = rmsnorm_matmul_limit(torch, "planted fault", x, scale, w, eps,
                                    ref)
    h = fcm._normalize(x, scale, eps)
    k0 = x.shape[1] // 2
    h[:, k0:k0 + K4_STAGE] = 0
    fault = fcm.matmul_reference(h, w)
    worst = planted_fault(torch, f"K4 with the k-stage [{k0}, "
                          f"{k0 + K4_STAGE}) skipped", fault, ref, limit)
    check(worst >= 10.0, f"K4's limit reads a skipped k-stage at only "
                         f"{worst:.2f}x, not >= 10x")
    return worst


def phase_train_kernel_checks(torch):
    """K1-K4 against their plain versions on the card. → the main-shape
    errors by kernel name."""
    from deepspeed_tpu_torch.kernels import fused_collective_matmul as fcm
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    m = FA_MAIN
    q, k, v, do = flash_inputs(torch, gen, m["B"], m["S"], m["H"], m["KV"],
                               m["hd"], torch.bfloat16)
    errs = check_flash(torch, fa, "bf16 main shapes causal", q, k, v, do,
                       True, FLASH_BF16_TERMS, BF16_RTOL, BF16_ATOL)
    del q, k, v, do
    torch.cuda.empty_cache()
    for S in (1, 100, 257):
        for causal in (True, False):
            for hd in (64, 128):
                for G in (1, 4):
                    q, k, v, do = flash_inputs(torch, gen, 2, S, 2 * G, 2,
                                               hd, torch.float32)
                    check_flash(torch, fa, f"f32 S={S} causal={causal} "
                                f"hd={hd} G={G}", q, k, v, do, causal,
                                F32_TERMS, F32_RTOL, 1e-5)
    # the same tails on the tensor-core path: S not a multiple of the
    # 64-row tiles, in bf16
    for S in (100, 257):
        for causal in (True, False):
            for hd in (64, 128):
                q, k, v, do = flash_inputs(torch, gen, 2, S, 8, 2, hd,
                                           torch.bfloat16)
                check_flash(torch, fa, f"bf16 S={S} causal={causal} hd={hd} "
                            f"G=4", q, k, v, do, causal, FLASH_BF16_TERMS,
                            BF16_RTOL, BF16_ATOL)
    # the autograd Function (GQA repeat, delta, both backward kernels)
    # against autograd of the plain attention, float32
    from deepspeed_tpu_torch.models.transformer import _xla_attention

    qkv = [torch.randn(2, 257, h, 128, generator=gen, device=DEVICE)
           .requires_grad_() for h in (8, 2, 2)]
    do = torch.randn(2, 257, 8, 128, generator=gen, device=DEVICE)
    out = fa.flash_attention(*qkv, causal=True)
    grads = torch.autograd.grad(out, qkv, do)
    ref = _xla_attention(*qkv, causal=True)
    ref_grads = torch.autograd.grad(ref, qkv, do)
    for name, a, b in zip(("O", "dQ", "dK", "dV"), (out, *grads),
                          (ref, *ref_grads)):
        b = b.detach()
        _compare_limit(torch, f"flash_attention autograd {name} f32 GQA",
                       a.detach(), b, 1e-4 + 1e-4 * b.abs(),
                       "1e-4 + 1e-4*|ref|, float32 against autograd of the "
                       "plain attention")
    del qkv, do, out, grads, ref, ref_grads

    M, D = K4_MAIN["M"], K4_MAIN["D"]
    x = torch.randn(M, D, generator=gen, device=DEVICE).bfloat16()
    scale = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)
             ).bfloat16()
    for F in K4_MAIN["Fs"]:
        w = (torch.randn(D, F, generator=gen, device=DEVICE) / math.sqrt(D)
             ).bfloat16()
        err = check_rmsnorm_matmul(torch, fcm, f"bf16 M={M} D={D} F={F}", x,
                                   scale, w, 1e-5)
        errs["rmsnorm_matmul"] = max(errs.get("rmsnorm_matmul", 0.0), err)
        if F == K4_MAIN["Fs"][0]:
            errs["rmsnorm_matmul_fault_x"] = check_rmsnorm_matmul_faults(
                torch, fcm, x, scale, w, 1e-5)
        del w
        torch.cuda.empty_cache()
    del x
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        x = torch.randn(100, D, generator=gen, device=DEVICE).to(dtype)
        scale = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)
                 ).to(dtype)
        w = (torch.randn(D, 1000, generator=gen, device=DEVICE)
             / math.sqrt(D)).to(dtype)
        check_rmsnorm_matmul(torch, fcm, f"{tag} M=100 D={D} F=1000", x,
                             scale, w, 1e-5)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return errs


# --------------------------------------------------------------------- #
# training main path
# --------------------------------------------------------------------- #
def _train_counters(opt_type="AdamW"):
    """The launch counters of the kernels a training run with ``opt_type``
    goes through: K1-K4, and the optimizer's kernel for a Fused* name."""
    from deepspeed_tpu_torch.kernels import fused_collective_matmul as fcm
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    counters = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
                "rmsnorm_matmul": fcm.rmsnorm_matmul_fwd}
    opt = _optimizer_wrappers().get(opt_type)
    if opt is not None:
        counters[opt[0]] = opt[1]
    return counters


def _optimizer_wrappers():
    """Fused* name → (kernel name, wrapper)."""
    from deepspeed_tpu_torch.ops.adam import fused_adam as fad
    from deepspeed_tpu_torch.ops.lamb import fused_lamb as fla

    return {"FusedAdam": ("fused_adam", fad.fused_adam_update),
            "FusedLamb": ("fused_lamb", fla.fused_lamb_update),
            "FusedLion": ("fused_lion", fad.fused_lion_update),
            "FusedAdagrad": ("fused_adagrad", fad.fused_adagrad_update)}


def train_engine(torch, opt_type, layers=TRAIN_LAYERS, seed=SEED):
    """``initialize`` on llama3-8B widths cut to ``layers`` with remat,
    random float32 masters from a seeded generator, bench.py's ds_config
    with ``opt_type``. → (cfg, model, engine)."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import CausalLM, TransformerConfig
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              num_layers=layers, remat=True)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    model = CausalLM(cfg, init_params(cfg, gen, torch.float32, DEVICE),
                     trainable=True)
    ds_config = {                           # bench.py's, one device
        "train_micro_batch_size_per_gpu": 4,
        "optimizer": {"type": opt_type,
                      "params": {"lr": 3e-4, "weight_decay": 0.1}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 0},
        "bf16": {"enabled": True},
    }
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=ds_config, device=DEVICE)
    return cfg, model, engine


def train_batch_tokens(torch, engine, vocab, seq=2048):
    import numpy as np

    rng = np.random.default_rng(0)
    return {"input_ids": torch.from_numpy(rng.integers(
        0, vocab, size=(engine.train_batch_size(), seq))).to(DEVICE)}


def _loss_and_grad_norm(torch, engine, batch):
    """One micro-step's loss and global gradient norm, no update."""
    engine._zero_grads()
    loss = float(engine._loss_and_backward(batch))
    norm = float(torch.stack([p.grad.float().square().sum()
                              for p in engine.params.values()]).sum().sqrt())
    engine._zero_grads()
    return loss, norm


def phase_train_main_path(torch, opt_type="AdamW", path_check=True):
    t0 = time.perf_counter()
    cfg, model, engine = train_engine(torch, opt_type)
    torch.cuda.synchronize()
    log(f"train model ({opt_type}): llama3_8b widths, {cfg.num_layers} "
        f"layers, remat, {model.num_params() / 1e9:.3f} B params float32, "
        f"init {time.perf_counter() - t0:.1f} s")
    seq = 2048
    batch = train_batch_tokens(torch, engine, cfg.vocab_size, seq)
    tokens_per_step = engine.train_batch_size() * seq

    path = None
    if path_check:
        # the same step through the kernels and the plain composition
        loss_k, norm_k = _loss_and_grad_norm(torch, engine, batch)
        model.config = dataclasses.replace(cfg, attn_impl="xla",
                                           fused_rmsnorm="off")
        loss_x, norm_x = _loss_and_grad_norm(torch, engine, batch)
        model.config = cfg
        rel_loss = abs(loss_k - loss_x) / abs(loss_x)
        rel_norm = abs(norm_k - norm_x) / abs(norm_x)
        # bf16 activations (8 significant bits) through 4 layers; the two
        # paths round at different places (P, dS and the fused h in the
        # kernels; probabilities and h in the plain composition)
        log(f"path check: loss {loss_k:.6f} (kernels) vs {loss_x:.6f} "
            f"(xla/off), rel {rel_loss:.3e} (tol 1e-2); grad norm "
            f"{norm_k:.6f} vs {norm_x:.6f}, rel {rel_norm:.3e} (tol 5e-2)")
        check(rel_loss <= 1e-2, f"path check: losses differ by {rel_loss}")
        check(rel_norm <= 5e-2, f"path check: grad norms differ by "
              f"{rel_norm}")
        path = {"loss_kernels": loss_k, "loss_xla": loss_x,
                "grad_norm_kernels": norm_k, "grad_norm_xla": norm_x}
        torch.cuda.empty_cache()

    counters = _train_counters(opt_type)
    losses = []
    for i in range(WARMUP_STEPS):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        log(f"warm-up step {i}: loss {losses[-1]:.6f}, "
            f"{time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    times = []
    for i in range(TIMED_STEPS):
        t0 = time.perf_counter()
        loss = float(engine.train_batch(batch))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        log(f"timed step {i}: loss {loss:.6f}, {times[-1]:.4f} s")
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    for name, n in launches.items():
        check(n > 0, f"training path never launched {name}")
    check(all(math.isfinite(x) for x in losses), "non-finite training loss")
    timed = losses[WARMUP_STEPS:]
    check(timed[-1] < timed[0], f"loss did not fall over the timed steps: "
          f"{timed}")
    srt = sorted(times)
    med = srt[len(srt) // 2]
    # the JAX bench's analytic flops (bench.py:360-363): 6N + lm_head per
    # token from flops_per_token, plus 3 x 12*L*D*S attention flops
    attn = 12 * cfg.num_layers * cfg.hidden_size * seq
    flops_per_token = model.flops_per_token() + 3 * attn
    tflops = flops_per_token * tokens_per_step / med / 1e12
    per_step = {n: c / TIMED_STEPS for n, c in launches.items()}
    training = {
        "optimizer": opt_type, "layers": cfg.num_layers, "seq": seq,
        "batch": engine.train_batch_size(), "tokens_per_step":
        tokens_per_step, "losses": losses,
        "step_s": {"median": med, "min": srt[0], "max": srt[-1]},
        "tokens_per_s": tokens_per_step / med,
        "achieved_tflops": tflops,
        "bf16_peak_share": tflops * 1e12 / BF16_FLOPS,
        "flops_per_token": flops_per_token,
        "max_memory_allocated_gb": peak / 1e9,
        "launches_timed_run": launches, "launches_per_step": per_step,
        "path_check": path,
    }
    log(f"training ({opt_type}): median step {med:.4f} s [{srt[0]:.4f}, "
        f"{srt[-1]:.4f}] over {TIMED_STEPS} steps; {tokens_per_step / med:.1f} tokens/s; "
        f"{tflops:.1f} TFLOP/s achieved (analytic bench.py flops), "
        f"{100 * tflops * 1e12 / BF16_FLOPS:.1f}% of the 989 TFLOP/s dense "
        f"bf16 peak (NVIDIA H100 SXM data sheet); peak memory "
        f"{peak / 1e9:.2f} GB; launches per step {per_step}")
    training["profile"] = profile_step(torch, engine, batch, med, opt_type)
    del engine, model, batch
    _free(torch)
    return launches, training


_KERNEL_GROUPS = (            # kernel-name substrings → what they are
    ("K4 rmsnorm_matmul", ("rmsnorm_matmul_kernel",
                           "rmsnorm_matmul_wgmma_kernel", "rms_rows_kernel")),
    ("K5/K13-K15 fused optimizers", ("adam_kernel", "lamb_kernel",
                                     "lion_kernel", "adagrad_kernel")),
    ("K1 flash forward", ("flash_fwd_kernel",)),
    ("K2 flash dQ", ("flash_bwd_dq_kernel",)),
    ("K3 flash dK/dV", ("flash_bwd_dkv_kernel",)),
    ("cuBLAS GEMM", ("nvjet", "gemm", "xmma", "cutlass", "sm90_")),
    ("PyTorch elementwise and reductions", ("at::native::",)),
)


def profile_step(torch, engine, batch, step_s, opt_type):
    """One more ``train_batch`` under ``torch.profiler``: device time by
    kernel, grouped, and the device's busy share of the step's wall time
    (the union of the device events' intervals; its idle share is the
    rest). CUPTI's "Command Buffer Full" records are host-side stalls of a
    full launch queue, not device work, and are counted apart. CUDA events
    around the engine's ``_apply_update`` split off the update (unscale,
    clip, optimizer) from the forward and backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    apply_update = engine._apply_update
    marks = []

    def timed_update(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        apply_update(*args, **kwargs)
        end.record()
        marks.append((start, end))

    engine._apply_update = timed_update
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.train_batch(batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        # drop the instance attribute: the engine's own method again, and
        # no reference cycle keeping the engine's tensors alive after it
        del engine._apply_update
    update_ms = marks[0][0].elapsed_time(marks[0][1])
    by_name, spans, stalls = {}, [], 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name == "Command Buffer Full":
            stalls += 1
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (end - start) / 1e3, n + 1)
    busy, reach = 0.0, None
    for start, end in sorted(spans):
        if reach is None or start > reach:
            busy += end - start
            reach = end
        elif end > reach:
            busy += end - reach
            reach = end
    busy /= 1e3
    check(spans, "the profiler recorded no device events")
    groups = {}
    for name, (ms, _) in by_name.items():
        group = next((g for g, subs in _KERNEL_GROUPS
                      if any(sub in name for sub in subs)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    total = sum(groups.values())
    log(f"profiled step: wall {1e3 * wall:.1f} ms (timed median "
        f"{1e3 * step_s:.1f} ms), device busy {busy:.1f} ms "
        f"({100 * busy / (1e3 * wall):.1f}% of wall, idle "
        f"{100 - 100 * busy / (1e3 * wall):.1f}%); {len(spans)} device "
        f"events, {stalls} launch-queue-full stalls; the update (unscale, "
        f"clip, {opt_type}) {update_ms:.1f} ms of it")
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {group}: {ms:.2f} ms ({100 * ms / max(total, 1e-9):.1f}% "
            f"of device time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        log(f"  {ms:8.2f} ms  x{n:<4d} {name[:110]}")
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "update_ms": update_ms,
            "device_events": len(spans), "queue_full_stalls": stalls,
            "groups_ms": groups,
            "top": [{"ms": ms, "count": n, "name": name[:160]}
                    for name, (ms, n) in top]}


# --------------------------------------------------------------------- #
# training kernel timing
# --------------------------------------------------------------------- #
def flash_work(B, S, H, hd, causal, products, outputs, stats_in):
    """(bytes, flops): q, k, v (+ dO) in and ``outputs`` tensors out once
    in bf16, ``stats_in`` float32 row statistics [B, H, S]; 2*hd flops per
    visible (query, key) pair, head and product."""
    pairs = S * (S + 1) // 2 if causal else S * S
    ins = 3 + (1 if products > 2 else 0)
    nbytes = (ins + outputs) * B * S * H * hd * 2 + stats_in * B * H * S * 4
    return nbytes, 2 * hd * products * B * H * pairs


def phase_train_timing(torch, launches, errs):
    import torch.nn.functional as F

    from deepspeed_tpu_torch.kernels import fused_collective_matmul as fcm
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    m = FA_MAIN
    B, S, H, hd = m["B"], m["S"], m["H"], m["hd"]
    q, k, v, do = flash_inputs(torch, gen, B, S, H, m["KV"], hd,
                               torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    lib_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 10)
    qg, kg, vg = (x.clone().requires_grad_() for x in (qt, kt, vt))
    out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
    lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), dot, retain_graph=True), 10)
    del out, qg, kg, vg
    shape = {"B": B, "S": S, "H": H, "KV": m["KV"], "hd": hd,
             "causal": True, "dtype": "bf16"}
    specs = [
        ("flash_attention_fwd",
         lambda: fa.flash_attention_fwd(q, k, v, True, scale),
         lambda: fa.flash_attention_fwd_reference(q, k, v, True, scale),
         lib_fwd, flash_work(B, S, H, hd, True, 2, 1, 0)),
        ("flash_attention_bwd_dq",
         lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True,
                                           scale),
         lambda: fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                     True, scale),
         lib_bwd, flash_work(B, S, H, hd, True, 3, 1, 2)),
        ("flash_attention_bwd_dkv",
         lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True,
                                            scale),
         lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                                      delta, True, scale),
         lib_bwd, flash_work(B, S, H, hd, True, 4, 2, 2)),
    ]
    kernels = []
    for name, kern, plain, lib, (nbytes, flops) in specs:
        ms = cuda_ms(torch, kern, 10)
        plain_ms = cuda_ms(torch, plain, 3, warmup=1)
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        kernels.append({
            "name": name, "route": "cuda", "source": TRAIN_SOURCES[name],
            "replaces": TRAIN_REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "library": ("scaled_dot_product_attention forward"
                        if name == "flash_attention_fwd" else
                        "scaled_dot_product_attention backward (dQ, dK, dV "
                        "together)"),
            "shape": shape, "bytes": nbytes, "flops": flops})
        log(f"time {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"plain {plain_ms:.3f} ms, library {lib:.4f} ms)")
        torch.cuda.empty_cache()
    del q, k, v, do, o, lse, delta, qt, kt, vt, dot
    torch.cuda.empty_cache()

    M, D = K4_MAIN["M"], K4_MAIN["D"]
    x = torch.randn(M, D, generator=gen, device=DEVICE).bfloat16()
    sc = (1 + 0.1 * torch.randn(D, generator=gen, device=DEVICE)).bfloat16()
    by_shape = []
    for Fd in K4_MAIN["Fs"]:
        w = (torch.randn(D, Fd, generator=gen, device=DEVICE) / math.sqrt(D)
             ).bfloat16()
        ms = cuda_ms(torch, lambda: fcm.rmsnorm_matmul_fwd(x, sc, w, 1e-5),
                     10)
        plain_ms = cuda_ms(torch, lambda: fcm.rmsnorm_matmul_reference(
            x, sc, w, 1e-5), 10)
        lib = cuda_ms(torch, lambda: torch.matmul(
            F.rms_norm(x, (D,), sc, 1e-5), w), 10)
        nbytes = 2 * (M * D + D + D * Fd + M * Fd)
        flops = 2 * M * D * Fd
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        by_shape.append({"M": M, "D": D, "F": Fd, "ms": ms,
                         "plain_ms": plain_ms, "library_ms": lib,
                         "bound_ms": b_ms, "bound_by": b_by,
                         "bytes": nbytes, "flops": flops})
        log(f"time rmsnorm_matmul F={Fd}: {ms:.4f} ms (bound {b_ms:.4f} ms "
            f"by {b_by}, plain {plain_ms:.4f} ms, F.rms_norm + matmul "
            f"{lib:.4f} ms; {flops / ms / 1e9:.1f} TFLOP/s)")
    main = by_shape[-1]                        # gate/up, F 14336
    kernels.append({
        "name": "rmsnorm_matmul", "route": "cuda",
        "source": TRAIN_SOURCES["rmsnorm_matmul"],
        "replaces": TRAIN_REPLACES["rmsnorm_matmul"],
        "launches": launches["rmsnorm_matmul"],
        "max_abs_err": errs["rmsnorm_matmul"], "ms": main["ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "library": "F.rms_norm + torch.matmul",
        "planted_fault_x_limit": errs.get("rmsnorm_matmul_fault_x"),
        "shape": {"M": M, "D": D, "F": main["F"], "dtype": "bf16"},
        "by_shape": by_shape, "bytes": main["bytes"],
        "flops": main["flops"]})
    torch.cuda.synchronize()
    return kernels


# --------------------------------------------------------------------- #
# optimizer kernels (K5, K13-K15) and the optimizer family's paths
# --------------------------------------------------------------------- #
def _opt_variants():
    """(kernel name, label, wrapper, plain version, state count,
    a function (step, wd) -> kwargs) for every optimizer kernel
    check, at the main path's lr."""
    from deepspeed_tpu_torch.ops.adam import fused_adam as fad
    from deepspeed_tpu_torch.ops.lamb import fused_lamb as fla

    lr = OPT_LR
    return [
        ("fused_adam", "adam_w_mode=True", fad.fused_adam_update,
         fad.fused_adam_update_reference, 2,
         lambda s, wd: dict(step=s, lr=lr, weight_decay=wd,
                            adam_w_mode=True)),
        ("fused_adam", "adam_w_mode=False", fad.fused_adam_update,
         fad.fused_adam_update_reference, 2,
         lambda s, wd: dict(step=s, lr=lr, weight_decay=wd,
                            adam_w_mode=False)),
        ("fused_lamb", "", fla.fused_lamb_update,
         fla.fused_lamb_update_reference, 2,
         lambda s, wd: dict(step=s, lr=lr, weight_decay=wd)),
        ("fused_lion", "", fad.fused_lion_update,
         fad.fused_lion_update_reference, 1,
         lambda s, wd: dict(lr=lr, weight_decay=wd)),
        ("fused_adagrad", "", fad.fused_adagrad_update,
         fad.fused_adagrad_update_reference, 1,
         lambda s, wd: dict(lr=lr, weight_decay=wd)),
    ]


def _ulps(torch, a, b):
    """Largest distance in float32 ulps between two float32 tensors (as
    ordered integers; 0 means bitwise equal)."""
    def key(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((key(a) - key(b)).abs().max())


def check_optimizer(torch, variant, shape, wd, gen):
    """One kernel against its plain version on one leaf over OPT_STEPS
    successive steps from the same inputs; the limit is 0 ulps (see
    OPT_ULPS). → max abs error."""
    name, label, kern, plain, n_state, kwargs = variant
    p = torch.randn(shape, generator=gen, device=DEVICE) * 0.02
    states = [torch.rand(shape, generator=gen, device=DEVICE) * 1e-3
              for _ in range(n_state)]
    mine = [p.clone()] + [t.clone() for t in states]
    ref = [p] + states
    for step in range(OPT_STEPS):
        g = torch.randn(shape, generator=gen, device=DEVICE) * 1e-2
        kern(mine[0], g, *mine[1:], **kwargs(step, wd))
        plain(ref[0], g, *ref[1:], **kwargs(step, wd))
    err, ulps = 0.0, 0
    for a, b in zip(mine, ref):
        check(bool(torch.isfinite(a).all()), f"{name}: non-finite output")
        err = max(err, float((a - b).abs().max()))
        ulps = max(ulps, _ulps(torch, a, b))
    log(f"check {name} {label} shape={tuple(shape)} wd={wd}: max_abs_err "
        f"{err:.3e}, {ulps} ulps (limit {OPT_ULPS})")
    check(ulps <= OPT_ULPS, f"{name} {label} {tuple(shape)}: {ulps} ulps "
          f"from its plain version")
    return err


def phase_optimizer_kernel_checks(torch):
    """K5 (both modes), K13, K14, K15 against their plain versions at the
    4-layer training model's leaves and at edge sizes, weight decay on and
    off. → max abs error by kernel name."""
    from deepspeed_tpu_torch import TransformerConfig
    from deepspeed_tpu_torch.models.transformer import param_shapes

    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              num_layers=TRAIN_LAYERS)
    leaves = sorted(set(param_shapes(cfg).values()))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    errs = {}
    for variant in _opt_variants():
        for shape in leaves + list(OPT_EDGE_SHAPES):
            for wd in (0.0, OPT_WD):
                err = check_optimizer(torch, variant, shape, wd, gen)
                errs[variant[0]] = max(errs.get(variant[0], 0.0), err)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return errs


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_fused_adam_main_path(torch, adamw):
    """The training path of ``phase_train_main_path`` with ``FusedAdam``
    (K5), beside the AdamW run: the first loss (before any update) equal
    bit for bit, the later ones within FUSED_LOSS_RTOL."""
    launches, training = phase_train_main_path(torch, "FusedAdam",
                                               path_check=False)
    check(training["losses"][0] == adamw["losses"][0],
          f"FusedAdam's first loss {training['losses'][0]!r} != AdamW's "
          f"{adamw['losses'][0]!r}")
    rel = [abs(a - b) / abs(b) for a, b in
           zip(training["losses"], adamw["losses"])]
    log(f"FusedAdam vs AdamW losses: {training['losses']} vs "
        f"{adamw['losses']}; max rel {max(rel):.3e} (tol {FUSED_LOSS_RTOL})")
    check(max(rel) <= FUSED_LOSS_RTOL, f"FusedAdam losses left AdamW's by "
          f"{max(rel):.3e}")
    for run in (adamw, training):
        log(f"  {run['optimizer']:>9}: median step "
            f"{1e3 * run['step_s']['median']:.1f} ms, "
            f"{run['tokens_per_s']:.1f} tokens/s, "
            f"{run['achieved_tflops']:.1f} TFLOP/s, update "
            f"{run['profile']['update_ms']:.1f} ms device time, "
            f"K5 launches {run['launches_timed_run'].get('fused_adam', 0)}")
    training["loss_rel_vs_adamw"] = rel
    _free(torch)
    return launches, training


def phase_other_fused(torch, first_loss):
    """FusedLamb, FusedLion and FusedAdagrad on the same model, one engine
    at a time, each freed before the next: 2 ``train_batch`` steps with the
    counters set to 0 just before them and read just after. → by kernel
    name: losses and launches."""
    wrappers = _optimizer_wrappers()
    out = {}
    for opt_type in ("FusedLamb", "FusedLion", "FusedAdagrad"):
        cfg, model, engine = train_engine(torch, opt_type)
        batch = train_batch_tokens(torch, engine, cfg.vocab_size)
        counters = _train_counters(opt_type)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses = [float(engine.train_batch(batch)) for _ in range(2)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counters.items()}
        name = wrappers[opt_type][0]
        log(f"{opt_type}: losses {losses}, 2 steps {wall:.2f} s, launches "
            f"{launches}")
        check(losses[0] == first_loss, f"{opt_type}: first loss "
              f"{losses[0]!r} != FusedAdam's {first_loss!r}")
        check(all(math.isfinite(x) for x in losses),
              f"{opt_type}: non-finite loss")
        for n, c in launches.items():
            check(c > 0, f"{opt_type} path never launched {n}")
        out[name] = {"optimizer": opt_type, "losses": losses,
                     "launches": launches[name], "two_steps_s": wall}
        del engine, model, batch
        _free(torch)
    return out


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def phase_checkpoint(torch):
    """Save after 2 FusedAdam steps, load into a fresh engine (other
    weights), 2 more steps: losses bitwise equal to the first engine's
    steps 3-4 without interruption; the directory read back with the
    port's own ``load_universal``. At CKPT_LAYERS layers of llama3-8B
    width (the saved state is disk time, not card time)."""
    import shutil

    from deepspeed_tpu_torch.checkpoint.ds_to_universal import load_universal
    from deepspeed_tpu_torch.checkpoint.universal.layout import \
        universal_name

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "deepspeed_tpu_torch", "build", "ckpt_smoke")
    shutil.rmtree(root, ignore_errors=True)
    try:
        cfg, model, engine = train_engine(torch, "FusedAdam", CKPT_LAYERS)
        batch = train_batch_tokens(torch, engine, cfg.vocab_size)
        first = [float(engine.train_batch(batch)) for _ in range(2)]
        t0 = time.perf_counter()
        engine.save_checkpoint(root, client_state={"smoke": 1})
        save_s = time.perf_counter() - t0
        saved = {n: p.detach().clone() for n, p in engine.params.items()}
        straight = [float(engine.train_batch(batch)) for _ in range(2)]
        n_params = model.num_params()
        del engine, model
        _free(torch)

        cfg, model, engine = train_engine(torch, "FusedAdam", CKPT_LAYERS,
                                          seed=SEED + 7)
        t0 = time.perf_counter()
        path, client = engine.load_checkpoint(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        nbytes = _dir_bytes(path)
        check(client == {"smoke": 1}, f"client_state came back as {client}")
        check(engine.global_steps == engine.optimizer.count == 2,
              "counters not restored")
        for n, t in saved.items():
            check(torch.equal(engine.params[n], t), f"{n}: master differs")
        resumed = [float(engine.train_batch(batch)) for _ in range(2)]
        log(f"checkpoint: llama3_8b widths, {CKPT_LAYERS} layer(s), "
            f"{n_params / 1e9:.3f} B params, FusedAdam; {nbytes / 1e9:.2f} GB "
            f"in {path}; save {save_s:.2f} s, load {load_s:.2f} s; losses "
            f"{first} then {straight} (uninterrupted) vs {resumed} (resumed)")
        check(resumed == straight, f"resumed losses {resumed} != "
              f"uninterrupted {straight}")
        del engine, model, batch
        _free(torch)
        t0 = time.perf_counter()
        flat = load_universal(path, include_moments=True)
        read_s = time.perf_counter() - t0
        check(set(flat) == {universal_name(n) for n in saved},
              "load_universal names differ from the engine's")
        for n, t in saved.items():
            rec = flat[universal_name(n)]
            check(set(rec) == {"param", "exp_avg", "exp_avg_sq"},
                  f"{n}: leaves {sorted(rec)}")
            check(torch.equal(rec["param"].to(DEVICE), t),
                  f"{n}: load_universal master differs")
        log(f"  load_universal read {len(flat)} parameters x 3 leaves in "
            f"{read_s:.2f} s; masters bitwise equal to the saved engine's")
        del flat, saved
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _free(torch)
    return {"layers": CKPT_LAYERS, "params": n_params, "bytes": nbytes,
            "save_s": save_s, "load_s": load_s, "read_s": read_s,
            "losses_first": first, "losses_uninterrupted": straight,
            "losses_resumed": resumed}


def phase_optimizer_timing(torch, launches, errs):
    """K5, K13, K14, K15 over every leaf of the 4-layer model (one launch
    per leaf, ``multi_tensor_apply``), L2 flushed, median of 10; the plain
    versions the same way; one PyTorch call where one computes the same
    function (timing only)."""
    from deepspeed_tpu_torch import TransformerConfig
    from deepspeed_tpu_torch.models.transformer import param_shapes
    from deepspeed_tpu_torch.ops.adam import fused_adam as fad
    from deepspeed_tpu_torch.ops.lamb import fused_lamb as fla

    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              num_layers=TRAIN_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)
    shapes = param_shapes(cfg)
    params = {n: torch.randn(s, generator=gen, device=DEVICE) * 0.02
              for n, s in shapes.items()}
    grads = {n: torch.randn(s, generator=gen, device=DEVICE) * 1e-2
             for n, s in shapes.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    n_params = sum(p.numel() for p in params.values())
    hyper = dict(lr=OPT_LR, weight_decay=OPT_WD)
    two = {n: (m[n], v[n]) for n in params}
    one = {n: (v[n],) for n in params}

    def apply(fn, states, **kw):
        return lambda: fad.multi_tensor_apply(fn, params, grads, states,
                                              **hyper, **kw)

    def library(make):
        for n, p in params.items():
            p.grad = grads[n]
        opt = make(list(params.values()))
        ms = cuda_ms(torch, opt.step, 10)
        del opt
        for p in params.values():
            p.grad = None
        _free(torch)
        return ms

    specs = [
        ("fused_adam", apply(fad.fused_adam_update, two, step=0),
         apply(fad.fused_adam_update_reference, two, step=0),
         lambda: library(lambda ps: torch.optim.AdamW(
             ps, lr=OPT_LR, weight_decay=OPT_WD, fused=True)),
         "torch.optim.AdamW(fused=True).step()"),
        ("fused_lamb", apply(fla.fused_lamb_update, two, step=0),
         apply(fla.fused_lamb_update_reference, two, step=0), None, None),
        ("fused_lion", apply(fad.fused_lion_update, one),
         apply(fad.fused_lion_update_reference, one), None, None),
        ("fused_adagrad", apply(fad.fused_adagrad_update, one),
         apply(fad.fused_adagrad_update_reference, one),
         lambda: library(lambda ps: torch.optim.Adagrad(
             ps, lr=OPT_LR, eps=1e-10, weight_decay=OPT_WD)),
         "torch.optim.Adagrad.step() (the same sqrt(a) + eps form)"),
    ]
    kernels = []
    for name, kern, plain, lib_fn, lib_name in specs:
        ms = cuda_ms(torch, kern, 10)
        plain_ms = cuda_ms(torch, plain, 3, warmup=1)
        _free(torch)
        lib = lib_fn() if lib_fn is not None else None
        nbytes, flops = OPT_BYTES[name] * n_params, OPT_FLOPS[name] * n_params
        b_ms, b_by = bound_ms(nbytes, flops, F32_FLOPS)
        kernels.append({
            "name": name, "route": "cuda", "source": OPT_SOURCE,
            "replaces": OPT_REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "library": lib_name,
            "shape": {"params": n_params, "leaves": len(params),
                      "dtype": "f32", "layers": TRAIN_LAYERS},
            "bytes": nbytes, "flops": flops})
        log(f"time {name} over {len(params)} leaves, {n_params / 1e9:.3f} B "
            f"params: {ms:.3f} ms (bound {b_ms:.3f} ms by {b_by}, "
            f"{nbytes / ms / 1e9:.2f} TB/s; plain {plain_ms:.3f} ms; "
            f"library {'none' if lib is None else f'{lib:.3f} ms'})")
    del params, grads, m, v, two, one
    _free(torch)
    return kernels


# --------------------------------------------------------------------- #
# block-sparse attention (K16-K19)
# --------------------------------------------------------------------- #
def sparse_configs(H):
    """The main path's two layouts at block 64: Fixed unidirectional (the
    serving and training direction) and BigBird bidirectional (training)."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

    blk = SPARSE_MAIN["block"]
    return {"fixed": sc.FixedSparsityConfig(
                num_heads=H, block=blk, num_local_blocks=4,
                num_global_blocks=1, attention="unidirectional"),
            "bigbird": sc.BigBirdSparsityConfig(num_heads=H, block=blk)}


def sparse_terms(torch, bs, q, k, v, do, lse, delta, tables, scale):
    """Float32 sums of the magnitudes of the terms behind each output,
    over the active blocks only, from the given LSE and delta: |P|@|V|
    (O), |dS|@|K| (dQ), |dS|^T@|Q| (dK), |P|^T@|dO| (dV). They scale the
    error limits as in ``check_flash``."""
    B, H, S, hd = q.shape
    blk = tables.block
    Sp = tables.nk * blk
    kb, vb = bs._blocks(k, tables.nk, blk), bs._blocks(v, tables.nk, blk)
    pv = torch.zeros(B, H, S, hd, device=q.device)
    dsk = torch.zeros_like(pv)
    dsq = torch.zeros(B, H * Sp, hd, device=q.device)
    pdo = torch.zeros_like(dsq)
    heads = torch.arange(H, device=q.device)[:, None]
    rows, _ = tables.padded_rows()
    for i in range(-(-S // blk)):
        idx, valid = rows[i]
        if idx.shape[1] == 0:
            continue
        r0, r1 = i * blk, min(S, (i + 1) * blk)
        kg = bs._gather(kb, idx, H).flatten(2, 3)
        vg = bs._gather(vb, idx, H).flatten(2, 3)
        key_ok, _ = bs._slot_mask(idx, valid, blk, S, H)
        qi, doi = q[:, :, r0:r1].float(), do[:, :, r0:r1].float()
        s = torch.einsum("bhqd,bhnd->bhqn", qi, kg) * scale
        p = torch.where(key_ok[:, None],
                        torch.exp(s - lse[:, :, r0:r1, None]), 0.0)
        dp = torch.einsum("bhqd,bhnd->bhqn", doi, vg)
        ds = (p * (dp - delta[:, :, r0:r1, None]) * scale).abs()
        pv[:, :, r0:r1] = p @ vg.abs()
        dsk[:, :, r0:r1] = ds @ kg.abs()
        pos = idx[..., None] * blk + torch.arange(blk, device=q.device)
        flat = (heads * Sp + pos.expand(H, -1, -1).flatten(1)).flatten()
        dsq.index_add_(1, flat, torch.einsum(
            "bhqn,bhqd->bhnd", ds, qi.abs()).flatten(1, 2))
        pdo.index_add_(1, flat, torch.einsum(
            "bhqn,bhqd->bhnd", p, doi.abs()).flatten(1, 2))
    dsq = dsq.view(B, H, Sp, hd)[:, :, :S]
    pdo = pdo.view(B, H, Sp, hd)[:, :, :S]
    return pv, dsk, dsq, pdo


def check_sparse(torch, bs, tag, q, k, v, do, tables, terms, rtol, atol):
    """K16, K17, K18 and K19 against their plain versions on one batch.
    The backward kernels get the plain forward's LSE and delta, so each
    check sees one kernel; K17's O must equal K16's bit for bit (one kernel
    body). → max abs error by kernel name."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o_ref, lse_ref = bs.block_sparse_fwd_reference(q, k, v, tables, scale)
    delta = (do.float() * o_ref.float()).sum(-1)
    pv, dsk, dsq, pdo = sparse_terms(torch, bs, q, k, v, do, lse_ref, delta,
                                     tables, scale)

    def lim(ref, t):
        return atol + rtol * ref.float().abs() + terms * t

    why = f"{atol:.0e} + {rtol:.3g}*|ref| + {terms:.3g}*"
    errs = {}
    o, lse = bs.block_sparse_fwd(q, k, v, tables, scale)
    errs["block_sparse_fwd"] = _compare_limit(
        torch, f"block_sparse_fwd O {tag}", o, o_ref, lim(o_ref, pv),
        why + "|P|@|V|")
    _compare_limit(torch, f"block_sparse_fwd LSE {tag}", lse, lse_ref,
                   1e-4 + 1e-5 * lse_ref.abs(), "1e-4 + 1e-5*|ref|, float32")
    o2 = bs.block_sparse_fwd_nolse(q, k, v, tables, scale)
    check(torch.equal(o2, o), f"block_sparse_fwd_nolse {tag}: O differs "
          f"from block_sparse_fwd's")
    errs["block_sparse_fwd_nolse"] = float((o2.float() - o_ref.float())
                                           .abs().max())
    dq_ref = bs.block_sparse_bwd_dq_reference(q, k, v, do, lse_ref, delta,
                                              tables, scale)
    dq = bs.block_sparse_bwd_dq(q, k, v, do, lse_ref, delta, tables, scale)
    errs["block_sparse_bwd_dq"] = _compare_limit(
        torch, f"block_sparse_bwd_dq {tag}", dq, dq_ref, lim(dq_ref, dsk),
        why + "|dS|@|K|")
    dk_ref, dv_ref = bs.block_sparse_bwd_dkv_reference(
        q, k, v, do, lse_ref, delta, tables, scale)
    dk, dv = bs.block_sparse_bwd_dkv(q, k, v, do, lse_ref, delta, tables,
                                     scale)
    err_k = _compare_limit(torch, f"block_sparse_bwd_dkv dK {tag}", dk,
                           dk_ref, lim(dk_ref, dsq), why + "|dS|^T@|Q|")
    err_v = _compare_limit(torch, f"block_sparse_bwd_dkv dV {tag}", dv,
                           dv_ref, lim(dv_ref, pdo), why + "|P|^T@|dO|")
    errs["block_sparse_bwd_dkv"] = max(err_k, err_v)
    return errs, (o, lse_ref)


def sparse_inputs(torch, gen, B, H, S, hd, dtype, n=4):
    return [torch.randn(B, H, S, hd, generator=gen, device=DEVICE,
                        dtype=torch.float32).to(dtype) for _ in range(n)]


def phase_sparse_kernel_checks(torch):
    """K16-K19 against their plain versions on edge batches: float32 and
    bf16; block 16, 32, 64, 128; hd 64 and 128; each layout class in turn,
    per-head layouts, an emptied q-block row, S off the block grid."""
    import itertools

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    combos = itertools.product((torch.float32, torch.bfloat16),
                               (16, 32, 64, 128), (64, 128))
    for i, (dtype, blk, hd) in enumerate(combos):
        name, kw = SPARSE_EDGE_LAYOUTS[i % len(SPARSE_EDGE_LAYOUTS)]
        per_head = i % 3 == 0
        empty = i % 3 == 1
        nb, H = 8, 4
        S = nb * blk - (5 if i % 2 else 0)
        layout = getattr(sc, name)(num_heads=H, block=blk,
                                   different_layout_per_head=per_head,
                                   **kw).make_layout(nb * blk)
        if empty:
            layout[:, 3] = False
        tables = bs.prepare_layout(layout, blk, H, DEVICE)
        q, k, v, do = sparse_inputs(torch, gen, 2, H, S, hd, dtype)
        f32 = dtype == torch.float32
        tag = (f"{'f32' if f32 else 'bf16'} {name[:-14]} block={blk} hd={hd} "
               f"S={S} per_head={per_head} empty_row={empty}")
        _, (o, _) = check_sparse(
            torch, bs, tag, q, k, v, do, tables,
            SPARSE_F32_TERMS if f32 else FLASH_BF16_TERMS,
            F32_RTOL if f32 else BF16_RTOL, 1e-5 if f32 else BF16_ATOL)
        if empty:
            o_k, lse_k = bs.block_sparse_fwd(q, k, v, tables)
            rows = slice(3 * blk, 4 * blk)
            check(bool((o_k[:, :, rows] == 0).all())
                  and bool((lse_k[:, :, rows] == -1e30).all()),
                  f"{tag}: the empty row is not O = 0, LSE = -1e30")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _sparse_counters():
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs

    return {name: getattr(bs, name) for name in SPARSE_REPLACES}


def phase_sparse_main_path(torch):
    """``SparseSelfAttention(cfg)(q, k, v, use_kernel=True)`` at llama3-8B
    attention width (B 1, H 32, S 8192, hd 128, bf16, block 64): serving
    under ``torch.no_grad()`` (Fixed), then training steps with
    ``loss.backward()`` (Fixed and BigBird), each with the four counters
    set to 0 just before its timed calls and read just after; the outputs
    against the masked-dense path and the plain versions; the autograd
    gradients bitwise equal to the kernels called directly. → (launches,
    results, main-shape errors)."""
    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs
    from deepspeed_tpu_torch.ops.sparse_attention import \
        sparse_self_attention as ssa

    m = SPARSE_MAIN
    B, H, S, hd = m["B"], m["H"], m["S"], m["hd"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    q, k, v, w = sparse_inputs(torch, gen, B, H, S, hd, torch.bfloat16)
    counters = _sparse_counters()
    cfgs = sparse_configs(H)
    results, launches, errs = {"layouts": {}}, {}, {}
    for name, cfg in cfgs.items():
        tables = bs.prepare_layout(cfg.make_layout(S), m["block"], H, DEVICE)
        results["layouts"][name] = {
            "density": tables.density(),
            "active_blocks_per_head": tables.active_blocks(H) // H,
            "blocks": [tables.nq, tables.nk]}
        log(f"sparse layout {name}: {tables.nq} x {tables.nk} blocks, "
            f"{tables.active_blocks(H) // H} active per head, density "
            f"{100 * tables.density():.2f}%")

    # serving direction ------------------------------------------------ #
    attn = ssa.SparseSelfAttention(cfgs["fixed"])
    with torch.no_grad():
        attn(q, k, v, use_kernel=True)                 # builds the lists
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        times = []
        for _ in range(SPARSE_CALLS):
            t0 = time.perf_counter()
            out = attn(q, k, v, use_kernel=True)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        serve = {n: fn.launches for n, fn in counters.items()}
    log(f"sparse serving (no_grad, fixed): {SPARSE_CALLS} calls "
        f"{[round(1e3 * t, 3) for t in times]} ms; launches {serve}")
    check(serve == {"block_sparse_fwd": 0,
                    "block_sparse_fwd_nolse": SPARSE_CALLS,
                    "block_sparse_bwd_dq": 0, "block_sparse_bwd_dkv": 0},
          f"serving direction launched {serve}, not K17 alone once a call")
    check(tuple(out.shape) == (B, H, S, hd) and out.dtype == torch.bfloat16
          and bool(torch.isfinite(out).all()), "sparse serving output")
    launches["block_sparse_fwd_nolse"] = serve["block_sparse_fwd_nolse"]
    results["serving_call_s"] = sorted(times)
    # against the masked-dense path, 8 heads at a time (same layout: the
    # heads share it, and BigBird/Fixed draw per layout head)
    tables = bs.prepare_layout(cfgs["fixed"].make_layout(S), m["block"], H,
                               DEVICE)
    pv = bs.block_sparse_fwd_reference(q.float(), k.float(), v.float().abs(),
                                       tables)[0]
    worst = 0.0
    with torch.no_grad():
        for h0 in range(0, H, 8):
            dense = ssa.SparseSelfAttention(
                sparse_configs(8)["fixed"])(q[:, h0:h0 + 8], k[:, h0:h0 + 8],
                                            v[:, h0:h0 + 8])
            ref = dense.float()
            lim = (BF16_ATOL + BF16_RTOL * ref.abs()
                   + DENSE_BF16_TERMS * pv[:, h0:h0 + 8].float())
            err = _compare_limit(
                torch, f"sparse serving vs masked-dense heads {h0}-{h0 + 7}",
                out[:, h0:h0 + 8], ref, lim,
                f"{BF16_ATOL:.0e} + {BF16_RTOL:.3g}*|ref| + "
                f"{DENSE_BF16_TERMS:.3g}*|P|@|V|, bf16 dense path")
            worst = max(worst, err)
            del dense, ref, lim
            torch.cuda.empty_cache()
    results["vs_masked_dense_max_abs_err"] = worst
    del pv, out

    # training direction ----------------------------------------------- #
    results["training"] = {}
    for name, cfg in cfgs.items():
        attn = ssa.SparseSelfAttention(cfg)
        qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))

        def step():
            for t in (qg, kg, vg):
                t.grad = None
            o = attn(qg, kg, vg, use_kernel=True)
            loss = (o.float() * w.float()).sum()
            loss.backward()
            return o, loss

        step()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        times = []
        for _ in range(SPARSE_STEPS):
            t0 = time.perf_counter()
            o, loss = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        train = {n: fn.launches for n, fn in counters.items()}
        log(f"sparse training ({name}): {SPARSE_STEPS} steps "
            f"{[round(1e3 * t, 3) for t in times]} ms, loss "
            f"{float(loss.detach()):.6f}; launches {train}")
        check(train == {"block_sparse_fwd": SPARSE_STEPS,
                        "block_sparse_fwd_nolse": 0,
                        "block_sparse_bwd_dq": SPARSE_STEPS,
                        "block_sparse_bwd_dkv": SPARSE_STEPS},
              f"training direction ({name}) launched {train}, not K16, K18 "
              f"and K19 once a step")
        for n in ("block_sparse_fwd", "block_sparse_bwd_dq",
                  "block_sparse_bwd_dkv"):
            launches[n] = launches.get(n, 0) + train[n]
        grads = (qg.grad, kg.grad, vg.grad)
        check(all(bool(torch.isfinite(g).all()) for g in grads),
              f"sparse training ({name}): non-finite gradient")
        # the Function's wiring: the same kernels called directly
        tables = bs.prepare_layout(cfg.make_layout(S), m["block"], H, DEVICE)
        o_k, lse_k = bs.block_sparse_fwd(q, k, v, tables)
        delta = (w.float() * o_k.float()).sum(-1)
        direct = (bs.block_sparse_bwd_dq(q, k, v, w, lse_k, delta, tables),
                  *bs.block_sparse_bwd_dkv(q, k, v, w, lse_k, delta, tables))
        check(torch.equal(o.detach(), o_k) and all(
            torch.equal(a, b) for a, b in zip(grads, direct)),
            f"sparse training ({name}): autograd differs from the kernels "
            f"called directly")
        del qg, kg, vg, grads, direct, o, o_k, lse_k, delta
        torch.cuda.empty_cache()
        e, _ = check_sparse(torch, bs, f"bf16 main shapes {name}", q, k, v, w,
                            tables, FLASH_BF16_TERMS, BF16_RTOL, BF16_ATOL)
        for n, x in e.items():
            errs[n] = max(errs.get(n, 0.0), x)
        results["training"][name] = {"step_s": sorted(times),
                                     "loss": float(loss.detach()),
                                     "launches_timed": train}
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return launches, results, errs


def sparse_work(name, B, H, S, hd, active):
    """(bytes, flops) of one kernel: its [B, H, S, hd] bf16 inputs read once
    and outputs written once, float32 [B, H, S] statistics; 2*hd flops per
    product and (query, key) pair of the ``active`` blocks (over all heads,
    of block**2 pairs each)."""
    n, stats = B * H * S * hd * 2, B * H * S * 4
    blk = SPARSE_MAIN["block"]
    pairs = active * blk * blk
    return {"block_sparse_fwd": (4 * n + stats, 4 * hd * pairs),
            "block_sparse_fwd_nolse": (4 * n, 4 * hd * pairs),
            "block_sparse_bwd_dq": (5 * n + 2 * stats, 6 * hd * pairs),
            "block_sparse_bwd_dkv": (6 * n + 2 * stats, 8 * hd * pairs)}[name]


def phase_sparse_timing(torch, launches, errs, results):
    """K16-K19 at the main shape (Fixed; BigBird beside it), L2 flushed,
    median of 10; the plain versions (median of 3); SDPA with the expanded
    boolean token mask as the library call (forward for K16/K17, backward
    for K18/K19; timing only); K1's causal dense forward at the same shape
    for scale (timing only)."""
    import numpy as np
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    m = SPARSE_MAIN
    B, H, S, hd = m["B"], m["H"], m["S"], m["hd"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    q, k, v, do = sparse_inputs(torch, gen, B, H, S, hd, torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    k1_ms = cuda_ms(torch, lambda: fa.flash_attention_fwd(qt, kt, vt, True,
                                                          scale), 10)
    del qt, kt, vt
    log(f"time flash_attention_fwd (K1) causal dense at B {B} S {S} H {H} "
        f"hd {hd}: {k1_ms:.4f} ms (for scale)")
    by_layout = {}
    kernels = []
    for lname, cfg in sparse_configs(H).items():
        layout = cfg.make_layout(S)
        tables = bs.prepare_layout(layout, m["block"], H, DEVICE)
        o, lse = bs.block_sparse_fwd(q, k, v, tables, scale)
        delta = (do.float() * o.float()).sum(-1)
        specs = {
            "block_sparse_fwd": (
                lambda: bs.block_sparse_fwd(q, k, v, tables, scale),
                lambda: bs.block_sparse_fwd_reference(q, k, v, tables, scale)),
            "block_sparse_fwd_nolse": (
                lambda: bs.block_sparse_fwd_nolse(q, k, v, tables, scale),
                lambda: bs.block_sparse_fwd_reference(q, k, v, tables,
                                                      scale)),
            "block_sparse_bwd_dq": (
                lambda: bs.block_sparse_bwd_dq(q, k, v, do, lse, delta,
                                               tables, scale),
                lambda: bs.block_sparse_bwd_dq_reference(
                    q, k, v, do, lse, delta, tables, scale)),
            "block_sparse_bwd_dkv": (
                lambda: bs.block_sparse_bwd_dkv(q, k, v, do, lse, delta,
                                                tables, scale),
                lambda: bs.block_sparse_bwd_dkv_reference(
                    q, k, v, do, lse, delta, tables, scale)),
        }
        lib_fwd = lib_bwd = None
        if lname == "fixed":
            mask = torch.from_numpy(np.kron(
                layout[0], np.ones((m["block"],) * 2, bool))).to(DEVICE)
            mask = mask[None, None]
            lib_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask), 10)
            qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
            out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask)
            lib_bwd = cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qg, kg, vg), do, retain_graph=True), 10)
            del out, qg, kg, vg, mask
            torch.cuda.empty_cache()
        active = tables.active_blocks(H)
        rows = {}
        for name, (kern, plain) in specs.items():
            ms = cuda_ms(torch, kern, 10)
            plain_ms = cuda_ms(torch, plain, 3, warmup=1)
            nbytes, flops = sparse_work(name, B, H, S, hd, active)
            b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
            lib = lib_bwd if "bwd" in name else lib_fwd
            rows[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": b_by, "library_ms": lib,
                          "bytes": nbytes, "flops": flops}
            log(f"time {name} ({lname}, density "
                f"{100 * tables.density():.2f}%): {ms:.4f} ms (bound "
                f"{b_ms:.4f} ms by {b_by}, {flops / ms / 1e9:.1f} TFLOP/s; "
                f"plain {plain_ms:.3f} ms; library "
                f"{'-' if lib is None else f'{lib:.4f} ms'})")
            torch.cuda.empty_cache()
        by_layout[lname] = {"density": tables.density(),
                            "active_blocks": active, "kernels": rows}
        del o, lse, delta
        torch.cuda.empty_cache()
    for name in SPARSE_REPLACES:
        main = by_layout["fixed"]["kernels"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": SPARSE_SOURCES[name],
            "replaces": SPARSE_REPLACES[name], "launches": launches[name],
            "max_abs_err": errs[name], **main,
            "library": ("scaled_dot_product_attention with the expanded "
                        "boolean token mask, " +
                        ("backward (dQ, dK, dV together)" if "bwd" in name
                         else "forward")),
            "shape": {"B": B, "H": H, "S": S, "hd": hd,
                      "block": m["block"], "layout": "fixed",
                      "density": by_layout["fixed"]["density"],
                      "dtype": "bf16"},
            "bigbird": by_layout["bigbird"]["kernels"][name]})
    results["timing"] = {"k1_causal_dense_ms": k1_ms, "by_layout": by_layout}
    del q, k, v, do
    _free(torch)
    return kernels


# --------------------------------------------------------------------- #
# int8 quantization: K8a, K8b, K9a, K10a
# --------------------------------------------------------------------- #
QUANT_SOURCE = "deepspeed_tpu_torch/csrc/quantizer.cu"
QUANT_REPLACES = {
    "quantize_int8": "deepspeed_tpu/ops/quantizer/quantizer.py:29",
    "dequantize_int8": "deepspeed_tpu/ops/quantizer/quantizer.py:64",
    "quant_pack_wire": "deepspeed_tpu/ops/quantizer/quantizer.py:140",
    "unpack_dequant_wire": "deepspeed_tpu/ops/quantizer/quantizer.py:212",
}
QUANT_LIBRARY = ("none: no single PyTorch call computes group-wise max-abs "
                 "int8 quantization or its dequantize "
                 "(torch.quantize_per_channel is affine with given scales)")
# edge batches: every group size of the CPU test, and 4096 (one CUDA block
# a group instead of one warp)
QUANT_GROUP_SIZES = (2, 64, 256, 1000, 1024, 4096)
QUANT_GROUP = 256                  # quantize_params' and the wire's groups
QUANT_CHUNK = 1 << 20              # groups a plain-version comparison takes
# |w - dq| <= s/2 up to the float32 rounding of x/s and of q*s, each at
# most 2**-24 relative of a value <= 127*s: s/2 * (1 + 2**-15) bounds both
DQ_SLACK = 1.0 + 2.0 ** -15
HANDOFF_BLOCK = 128                # the decode engine's page (prefill: 64)
HANDOFF_TIMED = 3                  # timed hand-offs of the 1,024-token prompt


def same_bits(torch, a, b):
    """Bitwise equality of two tensors of one dtype and shape. NaNs equal
    NaNs: the card writes its canonical NaN where the CPU keeps a payload,
    and the bits of a NaN carry no value."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    na, nb = torch.isnan(a), torch.isnan(b)
    if not torch.equal(na, nb):
        return False
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(torch.equal(a.masked_fill(na, 0).view(ints),
                            b.masked_fill(nb, 0).view(ints)))


def max_abs(torch, a, b):
    """Largest |a - b| over the values that are not NaN in both."""
    d = (a.float() - b.float()).abs()
    return float(d.nan_to_num(0.0).max()) if d.numel() else 0.0


def quant_edge_batch(torch, gen, gs, dtype):
    """The CPU test's edge batch on the card: a group of ordinary values,
    one of zeros, one of exact half quantization steps, one of subnormals,
    one holding a NaN, one holding an infinity, then a tail of gs // 3 + 1
    values off the group grid; made in float32 and cast to ``dtype``."""
    dev = DEVICE

    def randn(n):
        return torch.randn(n, generator=gen, device=dev)

    amax = torch.tensor(127.0 * 0.25, device=dev)
    step = amax * (torch.ones((), device=dev) / torch.tensor(127.0,
                                                             device=dev))
    k = torch.randint(-126, 126, (gs,), generator=gen, device=dev) + 0.5
    half = k * step
    half[0] = amax
    sub = torch.where(torch.rand(gs, generator=gen, device=dev) < 0.5,
                      -3e-39, 3e-39)
    nan, inf = randn(gs), randn(gs)
    nan[gs // 2] = float("nan")
    inf[-1] = float("inf")
    return torch.cat([randn(gs), torch.zeros(gs, device=dev), half, sub,
                      nan, inf, randn(gs // 3 + 1)]).to(dtype)


def phase_quant_kernel_checks(torch, ops):
    """K8a, K9a, K8b and K10a against their plain versions on the card, bit
    for bit, on edge batches: group sizes 2-4096, float32, bfloat16 and
    float16 inputs, each at a 16-byte aligned address (the vector path)
    and one element off it (the scalar path); K8b and K10a write float32,
    bfloat16 and float16, cut to the input's size; K10a's int4 branch
    reads the plain K9b's bytes. Then K6 and K7 at page 128, the decode
    engine's page in the handoff, against their plain versions."""
    from deepspeed_tpu_torch.ops.quantizer import quantizer as qz

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    n_checks = 0
    for gs in QUANT_GROUP_SIZES:
        for dtype in (f32, bf16, f16):
            base = quant_edge_batch(torch, gen, gs, dtype)
            n = base.numel()
            buf = torch.empty(n + 8, dtype=dtype, device=DEVICE)
            for off in (0, 1):
                x = buf[off:off + n]
                x.copy_(base)
                tag = f"gs {gs} {str(dtype)[6:]} offset {off}"
                q, s = qz.quantize_int8(x, gs)
                qr, sr = qz.quantize_int8_reference(x, gs)
                check(same_bits(torch, q, qr) and same_bits(torch, s, sr),
                      f"K8a differs from its plain version ({tag})")
                s1 = s[:, 0]
                check(bool(s1[1] == 1 and s1[3] == 1 and torch.isnan(s1[4])
                           and torch.isinf(s1[5])
                           and not q[[1, 3, 4, 5]].any()),
                      f"K8a edge groups wrong ({tag}): scales "
                      f"{s1[:6].tolist()}")
                w, ws = qz.quant_pack_wire(x, 8, gs)
                wr, wsr = qz.quant_pack_wire_reference(x, 8, gs)
                check(same_bits(torch, w, wr) and same_bits(torch, ws, wsr)
                      and torch.equal(w, q),
                      f"K9a differs from its plain version or K8a ({tag})")
                n_checks += 3
                for odt in (f32, bf16, f16):
                    out = qz.dequantize_int8(q, s, shape=(n,), dtype=odt)
                    ref = qz.dequantize_int8_reference(q, s, shape=(n,),
                                                       dtype=odt)
                    check(same_bits(torch, out, ref),
                          f"K8b to {odt} differs from its plain version "
                          f"({tag})")
                    out = qz.unpack_dequant_wire(w, ws, 8, shape=(n,),
                                                 dtype=odt)
                    ref = qz.unpack_dequant_wire_reference(
                        w, ws, 8, shape=(n,), dtype=odt)
                    check(same_bits(torch, out, ref),
                          f"K10a int8 to {odt} differs from its plain "
                          f"version ({tag})")
                    n_checks += 2
                    if gs % 2:
                        continue
                    w4, s4 = qz._quant_pack4_reference(x, gs)
                    out = qz.unpack_dequant_wire(w4, s4, 4, shape=(n,),
                                                 dtype=odt)
                    ref = qz.unpack_dequant_wire_reference(
                        w4, s4, 4, shape=(n,), dtype=odt)
                    check(same_bits(torch, out, ref),
                          f"K10a int4 to {odt} differs from its plain "
                          f"version ({tag})")
                    n_checks += 1
    torch.cuda.synchronize()
    log(f"check quantizer kernels: {n_checks} bitwise checks on edge "
        f"batches (group sizes {QUANT_GROUP_SIZES}, f32/bf16/f16, aligned "
        f"and misaligned) passed")

    # K6/K7 take the page size at run time; hold them at page 128
    KV, G, hd, ps = 8, 4, 128, HANDOFF_BLOCK
    NB = 2048 // ps
    S = 8
    q, pages, kvl, pt, cu = paged_inputs(
        torch, gen, KV=KV, G=G, hd=hd, ps=ps, NB=NB, n_pages=S * NB + 1,
        q_lens=[1, 1, 200, 48, 0, 0, 7, 0],
        kv_lens=[129, 257, 712, 48, 0, 0, 1031, 0], dtype=torch.bfloat16,
        pad_tokens=6)
    kw = dict(num_kv_heads=KV)
    _compare(torch, "ragged_paged_attention bf16 page 128",
             ops.ragged_paged_attention(q, pages, kvl, pt, cu, **kw),
             ops.ragged_paged_attention_reference(q, pages, kvl, pt, cu,
                                                  **kw),
             BF16_ATOL, BF16_RTOL)
    q, pages, kvl, pt, _ = paged_inputs(
        torch, gen, KV=KV, G=G, hd=hd, ps=ps, NB=NB, n_pages=S * NB + 1,
        q_lens=None, kv_lens=[160, 288, 1056, 33, 0, 128, 256, 2047],
        dtype=torch.bfloat16)
    _compare(torch, "decode_paged_attention bf16 page 128",
             ops.decode_paged_attention(q, pages, kvl, pt, **kw),
             ops.decode_attend_dense(q, pages, kvl, pt, **kw), BF16_ATOL,
             BF16_RTOL)
    torch.cuda.synchronize()
    return n_checks


def _quant_counters(qz, zero=False):
    fns = {"quantize_int8": qz.quantize_int8,
           "dequantize_int8": qz.dequantize_int8,
           "quant_pack_wire": qz.quant_pack_wire,
           "unpack_dequant_wire": qz.unpack_dequant_wire}
    if zero:
        for f in fns.values():
            f.launches = 0
    return {name: f.launches for name, f in fns.items()}


def _quant_leaf_checks(torch, qz, name, w, node, deq=None):
    """One quantized leaf against the plain versions, QUANT_CHUNK groups at
    a time (groups are independent, so a slice of whole groups is exact):
    K8a's q and scales bit for bit, |w - dq| <= s/2, and, with ``deq``,
    K8b's bfloat16 output bit for bit. → (largest |kernel - plain| of the
    output checked, largest |w - dq| / s)."""
    q, s = node["__q__"], node["__scale__"]
    flat = w.reshape(-1)
    gs = q.shape[1]
    worst = err = 0.0
    for g0 in range(0, q.shape[0], QUANT_CHUNK):
        g1 = min(g0 + QUANT_CHUNK, q.shape[0])
        xs = flat[g0 * gs:min(g1 * gs, flat.numel())]
        if deq is None:
            qr, sr = qz.quantize_int8_reference(xs, gs)
            check(same_bits(torch, q[g0:g1], qr)
                  and same_bits(torch, s[g0:g1], sr),
                  f"K8a differs from its plain version on {name}, groups "
                  f"{g0}:{g1}")
            err = max(err, max_abs(torch, q[g0:g1], qr),
                      max_abs(torch, s[g0:g1], sr))
            del qr, sr
            dq = qz.dequantize_int8_reference(q[g0:g1], s[g0:g1],
                                              shape=(xs.numel(),))
            step = s[g0:g1].expand(-1, gs).reshape(-1)[:xs.numel()]
            ratio = (xs.float() - dq).abs() / step
            worst = max(worst, float(ratio.max()))
            check(worst <= 0.5 * DQ_SLACK,
                  f"{name}: |w - dq| = {worst} s > s/2")
            del dq, step, ratio
        else:
            ref = qz.dequantize_int8_reference(q[g0:g1], s[g0:g1],
                                               shape=(xs.numel(),),
                                               dtype=torch.bfloat16)
            got = deq.reshape(-1)[g0 * gs:g0 * gs + xs.numel()]
            check(same_bits(torch, got, ref),
                  f"K8b differs from its plain version on {name}, groups "
                  f"{g0}:{g1}")
            err = max(err, max_abs(torch, got, ref))
            del ref
    return err, worst


def quant_work(name, n, groups, elem_in, elem_out):
    """(bytes, flops) of one call on n values in ``groups`` groups: the
    input read once, the output written once, 4 bytes a scale; ~4 float32
    operations a value (max-abs, divide, round, clip; or convert and
    multiply)."""
    scales = 4 * groups
    if name in ("quantize_int8", "quant_pack_wire"):
        return n * elem_in + n + scales, 4 * n
    return n + scales + n * elem_out, 2 * n


def phase_quant_serving(torch, ops, model, prompts, bf16_out):
    """Weight-only int8 serving at llama3-8B width: ``quantize_params``
    (K8a once per quantized leaf), every leaf against the plain version,
    ``dequantize_params`` to bfloat16 (K8b once per leaf), ``generate`` on
    the dequantized weights, the int8 and int4 byte counts; then K8a and
    K8b timed on the largest leaf. → (results, timing rows)."""
    from deepspeed_tpu_torch import (CausalLM, InferenceEngineV2,
                                     RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.quantization import (
        dequantize_params, quantize_params, quantized_memory_bytes)
    from deepspeed_tpu_torch.ops.quantizer import quantizer as qz

    cfg = model.config
    state = {n: t.detach() for n, t in model.state_dict().items()}
    bf16_bytes = sum(t.numel() * t.element_size() for t in state.values())
    expected = sorted(n for n, t in state.items() if t.is_floating_point()
                      and t.dim() >= 2 and t.numel() >= 1 << 14)
    _quant_counters(qz, zero=True)
    t0 = time.perf_counter()
    q8, meta = quantize_params(state, group_size=QUANT_GROUP, bits=8)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    launches = {"quantize_int8": _quant_counters(qz)["quantize_int8"]}
    got = sorted(n for n, v in q8.items() if isinstance(v, dict))
    log(f"quantize_params(bits=8): {meta['quantized_leaves']} leaves in "
        f"{quant_s:.3f} s; K8a launches {launches['quantize_int8']} "
        f"(expected {len(expected)}: {expected})")
    check(got == expected and meta["quantized_leaves"] == len(expected)
          and launches["quantize_int8"] == len(expected),
          f"quantize_params quantized {got} with "
          f"{launches['quantize_int8']} K8a launches, not {expected}")
    worst = 0.0
    errs = {"quantize_int8": 0.0, "dequantize_int8": 0.0}
    for name in expected:
        node = q8[name]
        check(node["__dtype__"] == "bfloat16" and node["__bits__"] == 8
              and node["__shape__"] == tuple(state[name].shape),
              f"{name}: quantized node meta {node['__dtype__']}, "
              f"{node['__shape__']}")
        err, ratio = _quant_leaf_checks(torch, qz, name, state[name], node)
        errs["quantize_int8"] = max(errs["quantize_int8"], err)
        worst = max(worst, ratio)
    torch.cuda.synchronize()
    log(f"check K8a per leaf: q and scales bitwise equal to the plain "
        f"version on all {len(expected)} leaves; max |w - dq| / s = "
        f"{worst:.6f} (limit 0.5 * (1 + 2**-15))")

    _quant_counters(qz, zero=True)
    t0 = time.perf_counter()
    deq = dequantize_params(q8, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    dequant_s = time.perf_counter() - t0
    launches["dequantize_int8"] = _quant_counters(qz)["dequantize_int8"]
    check(launches["dequantize_int8"] == len(expected),
          f"dequantize_params launched K8b {launches['dequantize_int8']} "
          f"times, not {len(expected)}")
    for name in expected:
        check(deq[name].dtype == torch.bfloat16
              and deq[name].shape == state[name].shape,
              f"{name}: dequantized {deq[name].dtype} "
              f"{tuple(deq[name].shape)}")
        err, _ = _quant_leaf_checks(torch, qz, name, state[name], q8[name],
                                    deq=deq[name])
        errs["dequantize_int8"] = max(errs["dequantize_int8"], err)
    torch.cuda.synchronize()
    log(f"dequantize_params(bfloat16): {dequant_s:.3f} s, K8b launches "
        f"{launches['dequantize_int8']}, bitwise equal to the plain version "
        f"on every leaf")

    engine = InferenceEngineV2(CausalLM(cfg, deq),
                               RaggedInferenceEngineConfig(), device=DEVICE)
    log("generate on the int8-dequantized weights:")
    out, gen_launches, run = _run_generate(torch, ops, engine, prompts,
                                           len(bf16_out[0]), cfg.vocab_size)
    agree = sum(a == b for o, r in zip(out, bf16_out) for a, b in zip(o, r))
    total = sum(len(o) for o in out)
    log(f"greedy tokens equal to the bf16 run's: {agree}/{total} "
        f"({agree / total:.3f}; not a gate: random weights leave tiny "
        f"logit margins)")
    del engine, deq
    _free(torch)

    q8_bytes = quantized_memory_bytes(q8)
    before = _quant_counters(qz)
    t0 = time.perf_counter()
    q4, _ = quantize_params(state, group_size=QUANT_GROUP, bits=4)
    torch.cuda.synchronize()
    int4_s = time.perf_counter() - t0
    q4_bytes = quantized_memory_bytes(q4)
    del q4
    _free(torch)
    log(f"weight bytes: bf16 {bf16_bytes}, int8 {q8_bytes} "
        f"({q8_bytes / bf16_bytes:.4f} x bf16; limit 0.55), int4 {q4_bytes} "
        f"({q4_bytes / q8_bytes:.4f} x int8; limit 0.6; plain legacy ops on "
        f"the card, {int4_s:.3f} s)")
    check(q8_bytes < 0.55 * bf16_bytes, "int8 weights not below 0.55 x bf16")
    check(q4_bytes < 0.6 * q8_bytes, "int4 weights not below 0.6 x int8")
    check(_quant_counters(qz) == before, "the legacy int4 path launched a "
          "quantizer kernel")

    # timing on the largest leaf
    name = "layers.gate_proj.kernel"
    leaf, node = state[name], q8[name]
    q, s = node["__q__"], node["__scale__"]
    n, groups = leaf.numel(), q.shape[0]
    rows = []
    specs = {
        "quantize_int8": (lambda: qz.quantize_int8(leaf, QUANT_GROUP),
                          lambda: qz.quantize_int8_reference(leaf,
                                                             QUANT_GROUP),
                          2, 1),
        "dequantize_int8": (
            lambda: qz.dequantize_int8(q, s, shape=leaf.shape,
                                       dtype=torch.bfloat16),
            lambda: qz.dequantize_int8_reference(q, s, shape=leaf.shape,
                                                 dtype=torch.bfloat16),
            1, 2),
    }
    for kname, (kern, plain, e_in, e_out) in specs.items():
        ms = cuda_ms(torch, kern, 10)
        plain_ms = cuda_ms(torch, plain, 3, warmup=1)
        _free(torch)
        nbytes, flops = quant_work(kname, n, groups, e_in, e_out)
        b_ms, b_by = bound_ms(nbytes, flops, F32_FLOPS)
        log(f"time {kname} on {name} {tuple(leaf.shape)} bf16: {ms:.4f} ms "
            f"(bound {b_ms:.4f} ms by {b_by}, {nbytes / ms / 1e6:.1f} GB/s; "
            f"plain {plain_ms:.3f} ms)")
        rows.append({"name": kname, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                     "flops": flops,
                     "shape": {"leaf": name, "dims": list(leaf.shape),
                               "group_size": QUANT_GROUP,
                               "dtype": "bf16"}})
    del q8, state, leaf, node, q, s
    _free(torch)
    results = {"quantized_leaves": len(expected), "launches": launches,
               "max_abs_err": errs,
               "quantize_s": quant_s, "dequantize_s": dequant_s,
               "int4_quantize_s": int4_s, "bf16_bytes": bf16_bytes,
               "int8_bytes": q8_bytes, "int4_bytes": q4_bytes,
               "max_err_over_scale": worst,
               "greedy_agree_with_bf16": agree / total,
               "generate": run, "generate_launches": gen_launches}
    return results, rows


def _frame_wire(frame):
    """(wire bytes, scale bytes) of an int8 DSKV1 frame."""
    import struct

    (hlen,) = struct.unpack(">I", frame[5:9])
    header = json.loads(frame[9:9 + hlen])
    payload = frame[9 + hlen:]
    nw = header["groups"] * header["group_size"]
    return payload[:nw], payload[nw:]


def phase_handoff(torch, model, prompts, new_tokens):
    """Disaggregated prefill at llama3-8B width: engine P (page 64) prefills
    the 8 prompts less their last tokens; each sequence goes export_kv →
    to_wire(w) → from_wire(device="cuda") → import_kv into engine D (page
    128), for w in fp32 and int8; D puts the last tokens and decodes
    ``new_tokens``, as P does on its own sequences. K9a and K10a launch
    once per int8 shipment; the int8 wire equals the plain K9a's bytes,
    K10a's rows the plain version's, the int8 error stays in
    int8_error_bound, fp32 rows read back from D equal the shipped ones,
    and the fp32-shipped logits and stream equal P's bit for bit. Then the
    hand-off of the 1,024-token prompt is timed, and K9a and K10a on its
    rows. → (results, timing rows)."""
    from deepspeed_tpu_torch import (InferenceEngineV2,
                                     RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2 import kv_ship
    from deepspeed_tpu_torch.ops.quantizer import quantizer as qz

    cfg = model.config
    src = InferenceEngineV2(model, RaggedInferenceEngineConfig(),
                            device=DEVICE)
    budget = src.config.max_tokens
    uids = list(range(len(prompts)))

    def prefill(uid, toks):
        for i in range(0, len(toks), budget):
            src.put([uid], [toks[i:i + budget]])

    t0 = time.perf_counter()
    for uid, p in zip(uids, prompts):
        prefill(uid, p[:-1])
    torch.cuda.synchronize()
    log(f"handoff: P (page {src.config.block_size}) prefilled "
        f"{sum(len(p) - 1 for p in prompts)} tokens in "
        f"{time.perf_counter() - t0:.3f} s")
    gs = kv_ship.INT8_GROUP
    streams, frame_bytes, worst = {}, {}, 0.0
    errs = {"quant_pack_wire": 0.0, "unpack_dequant_wire": 0.0}
    _quant_counters(qz, zero=True)
    dst = {}
    for wire in kv_ship.WIRE_FORMATS:
        dst[wire] = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            block_size=HANDOFF_BLOCK), device=DEVICE)
        frame_bytes[wire] = 0
        for uid, p in zip(uids, prompts):
            ship = kv_ship.export_kv(src, uid, p[:-1])
            frame = kv_ship.to_wire(ship, wire)
            back = kv_ship.from_wire(frame, device=DEVICE)
            check(back.rows.device.type == torch.device(DEVICE).type,
                  "from_wire rebuilt the rows off the card")
            check(kv_ship.import_kv(dst[wire], back, uid),
                  f"import_kv ({wire}, uid {uid}) found no free pages")
            frame_bytes[wire] += len(frame)
            if wire == "fp32":
                again = kv_ship.export_kv(dst[wire], uid, p[:-1])
                check(same_bits(torch, again.rows, ship.rows),
                      f"fp32 rows read back from D differ (uid {uid})")
                continue
            wr, sr = qz.quant_pack_wire_reference(ship.rows, 8, gs)
            w_bytes, s_bytes = _frame_wire(frame)
            check(w_bytes == wr.cpu().numpy().tobytes()
                  and s_bytes == sr.cpu().numpy().tobytes(),
                  f"int8 wire differs from the plain K9a's (uid {uid})")
            w_k = torch.frombuffer(bytearray(w_bytes), dtype=torch.int8)
            errs["quant_pack_wire"] = max(errs["quant_pack_wire"], max_abs(
                torch, w_k, wr.reshape(-1).cpu()))
            ref = qz.unpack_dequant_wire_reference(
                wr, sr, 8, shape=tuple(ship.rows.shape))
            check(same_bits(torch, back.rows, ref),
                  f"K10a rows differ from the plain version (uid {uid})")
            errs["unpack_dequant_wire"] = max(errs["unpack_dequant_wire"],
                                              max_abs(torch, back.rows, ref))
            diff = (back.rows - ship.rows).abs().reshape(-1)
            bound = kv_ship.int8_error_bound(sr, gs, diff.numel())
            check(bool((diff <= bound).all()),
                  f"int8 error above int8_error_bound (uid {uid})")
            worst = max(worst, float((diff / bound).max()))
            del wr, sr, ref, diff, bound
        del ship, back
    launches = _quant_counters(qz)
    launches = {k: launches[k] for k in errs}
    log(f"shipped {len(prompts)} sequences on each wire; launches {launches}; "
        f"frames fp32 {frame_bytes['fp32']} B, int8 {frame_bytes['int8']} B "
        f"({frame_bytes['int8'] / frame_bytes['fp32']:.4f} x); int8 error "
        f"<= {worst:.4f} x int8_error_bound")
    check(launches == {"quant_pack_wire": len(prompts),
                       "unpack_dequant_wire": len(prompts)},
          f"K9a/K10a launches {launches}, not one per int8 shipment")
    # P continues its own sequences (the uninterrupted run), each D the
    # shipped ones: the last tokens in one put, then a fused decode
    logits = {}
    for wire, eng in (("uninterrupted", src), *dst.items()):
        logits[wire] = eng.put(uids, [[p[-1]] for p in prompts])
        seeds = [int(t) for t in logits[wire].argmax(-1).tolist()]
        toks = eng.decode_batch(uids, seeds, new_tokens - 1)
        streams[wire] = [[seeds[i]] + [int(t) for t in toks[:, i]]
                         for i in range(len(uids))]
        check(all(0 <= t < cfg.vocab_size for o in streams[wire] for t in o),
              f"{wire}: a token out of range")
    # the fp32 wire carries P's bf16 rows exactly, K6 walks the context in
    # chunks of 64 positions whatever the page and K7 splits it at fixed
    # 64-position boundaries: D's logits and greedy stream are P's own,
    # bit for bit
    check(same_bits(torch, logits["fp32"], logits["uninterrupted"])
          and streams["fp32"] == streams["uninterrupted"],
          "fp32-shipped continuation differs from P's uninterrupted run")
    del dst, eng, logits
    _free(torch)
    total = sum(len(o) for o in streams["fp32"])
    agree = {w: sum(a == b for o, r in zip(streams[w],
                                           streams["uninterrupted"])
                    for a, b in zip(o, r)) / total
             for w in kv_ship.WIRE_FORMATS}
    log(f"greedy streams of D equal to P's uninterrupted run: fp32 "
        f"{agree['fp32']:.3f} (a gate: bit for bit), int8 "
        f"{agree['int8']:.3f} (not a gate: random weights leave tiny logit "
        f"margins)")

    # the hand-off of the 1,024-token prompt, timed
    long_uid, long_prompt = 100, prompts[-1]
    prefill(long_uid, long_prompt)
    timing = {}
    for wire in kv_ship.WIRE_FORMATS:
        eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            block_size=HANDOFF_BLOCK), device=DEVICE)
        laps = []
        for rep in range(HANDOFF_TIMED + 1):
            lap = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ship = kv_ship.export_kv(src, long_uid, long_prompt)
            torch.cuda.synchronize()
            lap["export_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            frame = kv_ship.to_wire(ship, wire)
            lap["to_wire_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = kv_ship.from_wire(frame, device=DEVICE)
            torch.cuda.synchronize()
            lap["from_wire_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            check(kv_ship.import_kv(eng, back, rep), "timed import refused")
            torch.cuda.synchronize()
            lap["import_s"] = time.perf_counter() - t0
            lap["frame_bytes"] = len(frame)
            eng.flush([rep])
            if rep:                              # the first is a warm-up
                laps.append(lap)
        timing[wire] = {k: sorted(lap[k] for lap in laps)[len(laps) // 2]
                        for k in laps[0]}
        log(f"hand-off of {ship.n_tokens} tokens, {wire} (median of "
            f"{HANDOFF_TIMED}): export {timing[wire]['export_s'] * 1e3:.2f} "
            f"ms, to_wire {timing[wire]['to_wire_s'] * 1e3:.2f} ms, "
            f"from_wire {timing[wire]['from_wire_s'] * 1e3:.2f} ms, import "
            f"{timing[wire]['import_s'] * 1e3:.2f} ms; frame "
            f"{timing[wire]['frame_bytes']} B")
        del eng
    rows_t = ship.rows
    n = rows_t.numel()
    groups = -(-n // gs)
    w, s = qz.quant_pack_wire(rows_t, 8, gs)
    specs = {
        "quant_pack_wire": (lambda: qz.quant_pack_wire(rows_t, 8, gs),
                            lambda: qz.quant_pack_wire_reference(rows_t, 8,
                                                                 gs), 4, 1),
        "unpack_dequant_wire": (
            lambda: qz.unpack_dequant_wire(w, s, 8, shape=rows_t.shape),
            lambda: qz.unpack_dequant_wire_reference(w, s, 8,
                                                     shape=rows_t.shape),
            1, 4),
    }
    rows = []
    for kname, (kern, plain, e_in, e_out) in specs.items():
        ms = cuda_ms(torch, kern, 20)
        plain_ms = cuda_ms(torch, plain, 5, warmup=1)
        nbytes, flops = quant_work(kname, n, groups, e_in, e_out)
        b_ms, b_by = bound_ms(nbytes, flops, F32_FLOPS)
        log(f"time {kname} on the {ship.n_tokens}-token shipment "
            f"{tuple(rows_t.shape)} f32: {ms:.4f} ms (bound {b_ms:.4f} ms by "
            f"{b_by}, {nbytes / ms / 1e6:.1f} GB/s; plain {plain_ms:.3f} ms)")
        rows.append({"name": kname, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                     "flops": flops,
                     "shape": {"rows": list(rows_t.shape),
                               "group_size": gs, "dtype": "f32"}})
    del src, ship, back, rows_t, w, s
    _free(torch)
    results = {"decode_page": HANDOFF_BLOCK, "prefill_page": 64,
               "launches": launches, "max_abs_err": errs,
               "frame_bytes": frame_bytes,
               "int8_err_over_bound": worst,
               "agree_with_uninterrupted": agree,
               "timed_1024": timing}
    return results, rows


def quant_kernel_entries(rows, launches, errs):
    """The ``kernels`` JSON entries of K8a, K8b, K9a and K10a."""
    out = []
    for row in rows:
        name = row["name"]
        out.append({"name": name, "route": "cuda", "source": QUANT_SOURCE,
                    "replaces": QUANT_REPLACES[name],
                    "launches": launches[name], "max_abs_err": errs[name],
                    "ms": row["ms"], "plain_ms": row["plain_ms"],
                    "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"], "library_ms": None,
                    "library": QUANT_LIBRARY,
                    **{k: row[k] for k in ("shape", "bytes", "flops")}})
    return out


# --------------------------------------------------------------------- #
# the data-parallel world: K9b, K10b, K11, K12
# --------------------------------------------------------------------- #
CM_SOURCE = "deepspeed_tpu_torch/csrc/collective_matmul.cu"
WORLD_KERNELS = {   # name in the kernels line → (source, TPU kernel)
    "quant_pack_wire_int4": (
        QUANT_SOURCE, "deepspeed_tpu/ops/quantizer/quantizer.py:148"),
    "unpack_dequant_mean": (
        QUANT_SOURCE, "deepspeed_tpu/ops/quantizer/quantizer.py:250"),
    # K10a's kernel as LoCo's residual runs it: unpack_dequant_wire and the
    # subtraction of deepspeed_tpu/runtime/comm/fused_wire.py:126,141
    "wire_residual": (
        QUANT_SOURCE, "deepspeed_tpu/ops/quantizer/quantizer.py:212"),
    "shard_major_matmul": (
        CM_SOURCE, "deepspeed_tpu/kernels/fused_collective_matmul.py:99"),
    "gathered_dequant_matmul": (
        CM_SOURCE, "deepspeed_tpu/kernels/fused_collective_matmul.py:205"),
}
WORLD_SIZE = 2                 # two gloo ranks sharing the one card
WORLD_AXES = ("data",)
# what each rank of the world runs: llama3-8B width (``model``: the
# TransformerConfig preset) at 2 layers (~33 GB a rank), 3 steps of qgZ;
# qgZ + LoCo (~9 GB more a rank) at the 1 layer that fits, 2 steps; the
# fused-gemm calls at the down projection's shapes
WORLD_SPEC = {"device": "cuda", "model": "llama3_8b", "layers": 2,
              "steps": 3, "loco_layers": 1, "loco_steps": 2, "seq": 2048,
              "gemm": (4096, 14336, 4096)}
EMBED_SHAPE = (128256, 4096)   # the largest gradient leaf: 525 M float32
# the qgZ wire's bound on |exchanged - exact mean| a group: stage 1 moves
# each rank's value by at most its group's half step (A/7/2, A the
# largest max|g| of the group over the ranks) and so their mean; stage 2
# re-quantizes the mean with a half step of at most (M + A/14)/7/2, M the
# exact mean's max; the float32 rounding of x/s and q*s adds <= 2**-15 of
# that (as DQ_SLACK)
WIRE_SLACK = 1.0 + 2.0 ** -10


def _world_counters(zero=False):
    """The launch counters of the world's kernels (and of K1-K4, which the
    model runs), set to 0 first with ``zero``."""
    from deepspeed_tpu_torch.kernels import fused_collective_matmul as fcm
    from deepspeed_tpu_torch.ops.quantizer import quantizer as qz

    counters = {   # name → (wrapper, the attribute that counts)
        "quant_pack_wire_int4": (qz.quant_pack_wire, "launches4"),
        "quant_pack_wire": (qz.quant_pack_wire, "launches"),
        "unpack_dequant_mean": (qz.unpack_dequant_mean, "launches"),
        "unpack_dequant_wire": (qz.unpack_dequant_wire, "launches"),
        "wire_residual": (qz.wire_residual, "launches"),
        "shard_major_matmul": (fcm.shard_major_matmul, "launches"),
        "gathered_dequant_matmul": (fcm._gathered_dequant_matmul,
                                    "launches"),
        **{name: (f, "launches") for name, f in _train_counters().items()}}
    if zero:
        for f, attr in counters.values():
            setattr(f, attr, 0)
    return {name: getattr(f, attr) for name, (f, attr) in counters.items()}


def _wire_bound(torch, g, exact, n, q_max=7, group=QUANT_GROUP):
    """Per group of ``group`` values of a flat leaf: the bound on |the
    quantized mean - the exact mean| (WIRE_SLACK's comment), with A the
    groups' max|g| over the world's ranks. → [groups]."""
    from deepspeed_tpu_torch import comm

    def amax(t):
        t = t.reshape(-1).float()
        pad = (-t.numel()) % (n * group)
        if pad:
            t = torch.cat([t, t.new_zeros(pad)])
        return t.view(-1, group).abs().amax(dim=1)

    a = comm.all_reduce(amax(g), comm.ReduceOp.MAX)
    half1 = a / q_max / 2
    return (half1 + (amax(exact) + half1) / q_max / 2) * WIRE_SLACK


def _param_digest(torch, params):
    """Two int64 sums of each leaf's float32 bits (plain and position-
    weighted, wrapping), a digest two ranks compare after every step."""
    rows = []
    for p in params.values():
        bits = p.detach().reshape(-1).view(torch.int32)
        s1 = torch.zeros((), dtype=torch.int64, device=p.device)
        s2 = torch.zeros((), dtype=torch.int64, device=p.device)
        for i in range(0, bits.numel(), 1 << 24):
            c = bits[i:i + (1 << 24)].to(torch.int64)
            s1 += c.sum()
            s2 += (c * torch.arange(i + 1, i + 1 + c.numel(),
                                    device=p.device)).sum()
        rows.append(torch.stack([s1, s2]))
    return torch.stack(rows)


def _ranks_agree(torch, params, full=False):
    """Whether every rank holds the same parameter bits: the digests of
    all ranks, and with ``full`` each leaf broadcast from rank 0 and
    compared bit for bit."""
    from deepspeed_tpu_torch import comm

    d = _param_digest(torch, params)
    every = comm.all_gather_into_tensor(d[None]).view(WORLD_SIZE, *d.shape)
    same = bool((every == every[0]).all())
    if full:
        for p in params.values():
            mine = p.detach().clone()
            comm.broadcast(mine, src=0)
            same &= bool(torch.equal(mine.view(torch.int32),
                                     p.detach().view(torch.int32)))
            del mine
    return same


def _world_train(torch, rank, spec, layers, steps, loco, exchange_check):
    """``initialize`` → ``train_batch`` on this rank of the world: the
    spec's model width cut to ``layers`` (remat), random float32 masters
    from the same seed on every rank, bf16, AdamW,
    ``zero_quantized_gradients`` (and ``zeropp_loco``), micro-batch 1 x
    the spec's ``seq`` tokens a rank. The counters are set to 0 just
    before the steps and read just after."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import CausalLM, TransformerConfig, comm
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.runtime.comm.fused_wire import inv_n
    from deepspeed_tpu_torch.runtime.comm_path import quantized_allreduce

    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(getattr(TransformerConfig, spec["model"])(),
                              num_layers=layers, remat=True)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = CausalLM(cfg, init_params(cfg, gen, torch.float32, DEVICE),
                     trainable=True)
    ds_config = {
        "train_micro_batch_size_per_gpu": 1,
        "optimizer": {"type": "AdamW",
                      "params": {"lr": 3e-4, "weight_decay": 0.1}},
        "gradient_clipping": 1.0,
        "zero_optimization": {"stage": 0, "zero_quantized_gradients": True,
                              "zeropp_loco": loco},
        "bf16": {"enabled": True},
    }
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=ds_config, device=DEVICE)
    del model
    n_params = sum(p.numel() for p in engine.params.values())
    rng = np.random.default_rng(SEED + 7)
    batches = [{"input_ids": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(engine.train_batch_size(), spec["seq"]))).to(
            DEVICE)} for _ in range(steps)]
    torch.cuda.synchronize()
    comm.barrier()
    _world_counters(zero=True)
    losses, step_s, wire, agree, ops = [], [], [], [], set()
    for batch in batches:
        comm.reset_comm_record()
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        rec = comm.comm_record()
        ops |= {f"{e['op']} {e['dtype']}" for e in rec}
        wire.append({"int8": sum(e["bytes"] for e in rec
                                 if e["dtype"] == "int8"),
                     "float32": sum(e["bytes"] for e in rec
                                    if e["dtype"] == "float32"),
                     "collectives": len(rec)})
        agree.append(_ranks_agree(torch, engine.params,
                                  full=len(losses) == steps))
    launches = _world_counters()
    check(all(agree), f"rank {rank}: the ranks' parameters differ after a "
                      f"qgZ step ({agree})")
    check(all(math.isfinite(v) for v in losses),
          f"rank {rank}: non-finite losses {losses}")
    out = {"layers": layers, "params": n_params, "losses": losses,
           "step_s": step_s, "wire_bytes": wire, "launches": launches,
           "collectives": sorted(ops),
           "bit_identical_after_each_step": agree,
           "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    if exchange_check:
        # where one more step's time goes: this rank's forward and
        # backward, the exchange (K9b, K10b, K10a and gloo), the update
        ctx = engine._dp_step.ctx
        marks = [time.perf_counter()]
        _, grads = ctx.local_loss_and_grads(engine._rank_rows(batches[-1]))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        grads, _ = ctx.exchange_grads(grads, engine.comm_error)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        engine._apply_update(grads, unscale=False)
        engine._zero_grads()
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        out["step_breakdown_ms"] = {
            k: 1e3 * (b - a) for k, a, b in zip(
                ("forward_backward", "exchange", "update"), marks,
                marks[1:])}
        check(_ranks_agree(torch, engine.params),
              f"rank {rank}: the ranks' parameters differ after the "
              f"broken-down step")
    if loco:
        res = engine.comm_error
        out["loco_residual_abs_sum"] = float(sum(
            e["worker"].abs().sum() + e["server"].abs().sum()
            for e in res.values()))
        check(len(res) == len(engine.params) and
              out["loco_residual_abs_sum"] > 0,
              f"rank {rank}: LoCo residuals missing or zero")
        check(launches["wire_residual"] > 0,
              f"rank {rank}: LoCo's residual kernel never launched")
    if exchange_check:
        # one more backward, then every leaf's gradient exchanged on the
        # wire against its exact mean (all_reduce), within the wire bound
        engine._zero_grads()
        engine._loss_and_backward(engine._rank_rows(batches[-1])[0])
        worst, err = 0.0, 0.0
        for g in engine._grads().values():
            exact = comm.all_reduce(g.detach().clone()).mul_(
                inv_n(WORLD_SIZE))
            q, _, _ = quantized_allreduce(g, WORLD_AXES, bits=4)
            bound = _wire_bound(torch, g, exact, WORLD_SIZE)
            diff = (q - exact).reshape(-1).abs()
            pad = (-diff.numel()) % (WORLD_SIZE * QUANT_GROUP)
            diff = torch.cat([diff, diff.new_zeros(pad)]).view(
                -1, QUANT_GROUP)
            worst = max(worst, float((diff / (bound[:, None] + 1e-30)).max()))
            err = max(err, float(diff.max()))
            del exact, q, bound, diff
        engine._zero_grads()
        check(worst <= 1.0, f"rank {rank}: the exchanged gradient is "
                            f"{worst:.3f}x the wire's bound from the mean")
        out["exchange_err_over_bound"] = worst
        out["exchange_max_abs_err"] = err
    del engine, batches
    return out


def _world_gemm(torch, rank, spec):
    """The fused-gemm entry points on the down projection's shapes, wire
    0, 8 and 4: ``gemm_reduce_scatter(x, w)`` (x this rank's [M, K], w the
    same [K, N] on every rank) and ``gemm_all_gather_matmul(x, w_shard)``
    (w_shard this rank's [K/2, N] rows), bf16. The counters are set to 0
    before the six calls and read after them; then the fp edges against K11
    followed by the plain collective, bit for bit, and the int edges
    within their half-step bounds of the fp result."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.kernels import fused_collective_matmul as fcm
    from deepspeed_tpu_torch.ops.quantizer import quantizer as qz
    from deepspeed_tpu_torch.runtime.comm import fused_gemm as fg
    from deepspeed_tpu_torch.runtime.comm.fused_wire import inv_n

    torch.cuda.reset_peak_memory_stats()
    bf16 = torch.bfloat16
    M, K, N = spec["gemm"]
    gx = torch.Generator(device=DEVICE).manual_seed(SEED + 50 + rank)
    gw = torch.Generator(device=DEVICE).manual_seed(SEED + 49)
    x = torch.randn(M, K, generator=gx, device=DEVICE).to(bf16)
    w = (torch.randn(K, N, generator=gw, device=DEVICE) / K ** 0.5).to(bf16)
    kk = K // WORLD_SIZE
    w_shard = w[rank * kk:(rank + 1) * kk].contiguous()
    torch.cuda.synchronize()
    comm.barrier()
    _world_counters(zero=True)
    comm.reset_comm_record()
    outs, ms = {}, {}
    for bits in (0, 8, 4):
        for name, call in (
                ("gemm_reduce_scatter",
                 lambda: fg.gemm_reduce_scatter(x, w, WORLD_AXES, bits)),
                ("gemm_all_gather_matmul",
                 lambda: fg.gemm_all_gather_matmul(x, w_shard, WORLD_AXES,
                                                   bits))):
            t0 = time.perf_counter()
            outs[name, bits] = call()
            torch.cuda.synchronize()
            ms[f"{name} int{bits}"] = 1e3 * (time.perf_counter() - t0)
    launches = _world_counters()
    ops = sorted({f"{e['op']} {e['dtype']}" for e in comm.comm_record()})
    for k in ("shard_major_matmul", "gathered_dequant_matmul"):
        check(launches[k] > 0, f"rank {rank}: {k} never launched")
    errs = {}
    # fp edges: K11, then the plain collective
    y = fcm.shard_major_matmul(x, w, WORLD_SIZE)
    ref = comm.reduce_scatter_tensor(y) * inv_n(WORLD_SIZE)
    check(same_bits(torch, outs["gemm_reduce_scatter", 0], ref),
          f"rank {rank}: gemm_reduce_scatter int0 differs from K11 + "
          f"reduce_scatter")
    w_full = comm.all_gather_into_tensor(w_shard)
    ref = fcm.shard_major_matmul(x, w_full, 1)
    check(same_bits(torch, outs["gemm_all_gather_matmul", 0], ref),
          f"rank {rank}: gemm_all_gather_matmul int0 differs from "
          f"all_gather + K11")
    # int edges: the half step of each exchanged value (epilogue) or of
    # each dequantized weight (prologue), plus the bf16 roundings of both
    # results
    rows = M // WORLD_SIZE
    fp = outs["gemm_reduce_scatter", 0].float()
    for bits, q_max in ((8, 127), (4, 7)):
        got = outs["gemm_reduce_scatter", bits].float()
        a = comm.all_reduce(y.float().view(-1, QUANT_GROUP).abs().amax(1),
                            comm.ReduceOp.MAX)
        mine = a.view(WORLD_SIZE, -1)[rank]
        limit = (mine / q_max / 2).repeat_interleave(QUANT_GROUP).view(
            rows, N) + 2.0 ** -8 * (fp.abs() + got.abs())
        errs[f"gemm_reduce_scatter int{bits}"] = _compare_limit(
            torch, f"rank {rank} gemm_reduce_scatter int{bits}", got, fp,
            limit, "half a step of the exchanged values + two bf16 ulps")
    fp = outs["gemm_all_gather_matmul", 0].float()
    xa = x.float().abs()
    for bits in (8, 4):
        got = outs["gemm_all_gather_matmul", bits].float()
        wv, s = qz.quant_pack_wire(w_shard, bits, QUANT_GROUP)
        half = comm.all_gather_into_tensor(s).expand(-1, QUANT_GROUP) / 2
        half = half.reshape(WORLD_SIZE, -1)[:, :kk * N].reshape(K, N)
        with torch.no_grad():
            limit = (torch.matmul(xa, half) + K * 2.0 ** -23 * torch.matmul(
                xa, w_full.float().abs()) + 2.0 ** -8 * (fp.abs()
                                                         + got.abs()))
        errs[f"gemm_all_gather_matmul int{bits}"] = _compare_limit(
            torch, f"rank {rank} gemm_all_gather_matmul int{bits}", got, fp,
            limit, "half a step of each weight x |x| + float32 sums + two "
                   "bf16 ulps")
        del wv, s, half, limit, got
    torch.cuda.synchronize()
    return {"launches": launches, "ms": ms, "max_abs_err": errs,
            "collectives": ops,
            "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def _world_rank(rank, spec):
    """One rank of the world (run by ``launcher.run_local_world``): the
    kernels were built by the parent and are only loaded here."""
    import torch

    global DEVICE
    DEVICE = spec["device"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if DEVICE == "cuda":
        from deepspeed_tpu_torch.ops.op_builder import load_kernels

        load_kernels()
    out = {"rank": rank}
    out["qgz"] = _world_train(torch, rank, spec, spec["layers"],
                              spec["steps"], loco=False, exchange_check=True)
    _free(torch)
    out["fused_gemm"] = _world_gemm(torch, rank, spec)
    _free(torch)
    out["qgz_loco"] = _world_train(torch, rank, spec, spec["loco_layers"],
                                   spec["loco_steps"], loco=True,
                                   exchange_check=False)
    _free(torch)
    return out


def phase_world(torch, spec=None, target=None):
    """The data-parallel world on the one card: WORLD_SIZE gloo ranks on
    cuda:0 (NCCL takes one rank a GPU), spawned by
    ``launcher.run_local_world``. Each rank trains the qgZ path at
    llama3-8B width, runs the fused-gemm entry points, then the qgZ + LoCo
    path (``WORLD_SPEC``; ``spec`` and ``target`` replace it and
    ``_world_rank`` for a rehearsal). → the ranks' results."""
    from deepspeed_tpu_torch.launcher import run_local_world

    _free(torch)
    store = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "deepspeed_tpu_torch", "build", "world")
    t0 = time.perf_counter()
    try:
        res = run_local_world(target or _world_rank, WORLD_SIZE,
                              (spec or WORLD_SPEC,), store_dir=store,
                              backend="gloo", threads=4, timeout_s=900)
    except RuntimeError as e:
        raise SmokeFailure(f"the {WORLD_SIZE}-rank world failed: {e}")
    wall = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    for part in ("qgz", "qgz_loco"):
        a, b = res[0][part], res[1][part]
        check(a["losses"] == b["losses"],
              f"{part}: the ranks' data-mean losses differ")
        for r in res:
            p = r[part]
            launches = p["launches"]
            for k in ("quant_pack_wire_int4", "unpack_dequant_mean",
                      "unpack_dequant_wire"):
                check(launches[k] > 0, f"{part} rank {r['rank']}: {k} "
                                       f"never launched")
            log(f"world {part} rank {r['rank']} ({p['layers']} layers, "
                f"{p['params'] / 1e9:.3f} B params): losses {p['losses']}, "
                f"step {[round(s * 1e3, 1) for s in p['step_s']]} ms, wire "
                f"bytes a step {p['wire_bytes'][-1]}, launches "
                f"{ {k: v for k, v in launches.items() if v} }, peak "
                f"{p['max_memory_gb']:.2f} GB on {smi}; one step broken "
                f"down {p.get('step_breakdown_ms')}")
    for r in res:
        g = r["fused_gemm"]
        log(f"world fused_gemm rank {r['rank']}: ms {g['ms']}, launches "
            f"{ {k: v for k, v in g['launches'].items() if v} }, peak "
            f"{g['max_memory_gb']:.2f} GB")
    used = sorted({c for r in res for p in ("qgz", "fused_gemm", "qgz_loco")
                   for c in r[p]["collectives"]})
    log(f"world: gloo ran {used} on {DEVICE} tensors in both ranks; the "
        f"facade staged none through the host")
    log(f"world: exchange err/bound {res[0]['qgz']['exchange_err_over_bound']:.3f} "
        f"and {res[1]['qgz']['exchange_err_over_bound']:.3f}; the world "
        f"took {wall:.1f} s")
    return res


# |kernel - plain| of a float32-accumulated product of K terms t_k: the
# rounding of each result to its dtype (half an ulp of each: 2**-8 of its
# size in bfloat16, 2**-24 in float32), plus the two float32 sums'
# rounding errors. For zero-mean random terms those are random walks,
# each about 0.4 * sqrt(K) * 2**-24 * ||t||_2 (||t||_2 over the output's K
# products); ACC_SIGMAS of them stays far above the largest deviation of
# the 16 M outputs, and far below what a real fault adds (the planted
# faults below read many times their limit)
ACC_SIGMAS = 16.0
MATMUL_LIMIT = ("half an ulp of each result in its dtype + "
                f"{ACC_SIGMAS:g} x sqrt(K) x 2**-24 x ||t||_2 (float32 sums "
                "in another order)")


def matmul_limit(torch, x, w, got, ref):
    """The elementwise limit on |got - ref| for ``x @ w`` (MATMUL_LIMIT)."""
    K = x.shape[1]
    half_ulp = 2.0 ** -8 if got.dtype == torch.bfloat16 else 2.0 ** -24
    with torch.no_grad():
        norm = torch.matmul(x.float().square(), w.float().square()).sqrt_()
    return (half_ulp * (got.float().abs() + ref.float().abs())
            + ACC_SIGMAS * math.sqrt(K) * 2.0 ** -24 * norm)


def dropped_tile(torch, plain, x, k0=4096, width=32):
    """A planted fault: ``plain`` on x with K columns [k0, k0 + width)
    zeroed, as a kernel that skipped one K tile would compute."""
    xd = x.clone()
    xd[:, k0:k0 + width] = 0
    return plain(xd)


def bf16_sums(torch, x, w, width=32):
    """A planted fault: x @ w with each 32-wide K tile's product rounded
    to bfloat16 and the running sum carried in bfloat16, as a kernel that
    accumulated in bfloat16 would compute."""
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.bfloat16,
                      device=x.device)
    for k0 in range(0, x.shape[1], width):
        acc += torch.matmul(x[:, k0:k0 + width], w[k0:k0 + width])
    return acc


def planted_fault(torch, name, fault, ref, limit):
    """max |fault - ref| / limit, which must exceed 1: the limit would
    catch the fault."""
    worst = float(((fault.float() - ref.float()).abs() / limit).max())
    log(f"check planted fault: {name} reads {worst:.1f}x the limit")
    check(worst > 1.0, f"the limit would pass a planted fault ({name}, "
                       f"{worst:.3f}x)")
    return worst


def world_kernel_checks(torch):
    """K9b and K10b against their plain versions on the card, bit for bit,
    on edge batches (K9b: every even group size of the int8 checks,
    float32/bfloat16/float16, aligned and one element off; K10b: n = 2, 3
    and 4 peers of edge-batch wires, int4 and int8, with and without the
    LoCo addend) and on the embedding gradient leaf (K9b over the whole
    leaf, K10b on stacks of n = 2 and 4 of its wire's chunks, QUANT_CHUNK
    groups at a time); K11 and K12 at the down projection's shapes and at
    edge shapes, within limits set from the roundings' statistics, and
    planted faults read against those limits; LoCo's residual bit for bit
    on the edge batches and on the leaf's int4 wire. Then each is timed
    there. → (max abs errors, timing rows, planted faults' err/limit)."""
    from deepspeed_tpu_torch.kernels import fused_collective_matmul as fcm
    from deepspeed_tpu_torch.ops.quantizer import quantizer as qz

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    n_checks = 0
    errs = {k: 0.0 for k in WORLD_KERNELS}
    for gs in QUANT_GROUP_SIZES:
        for dtype in (f32, bf16, f16):
            base = quant_edge_batch(torch, gen, gs, dtype)
            n = base.numel()
            buf = torch.empty(n + 8, dtype=dtype, device=DEVICE)
            for off in (0, 1):
                x = buf[off:off + n]
                x.copy_(base)
                tag = f"gs {gs} {str(dtype)[6:]} offset {off}"
                w, s = qz.quant_pack_wire(x, 4, gs)
                wr, sr = qz.quant_pack_wire_reference(x, 4, gs)
                check(same_bits(torch, w, wr) and same_bits(torch, s, sr),
                      f"K9b differs from its plain version ({tag})")
                s1 = s[:, 0]
                check(bool(s1[1] == 1 and s1[3] == 1 and torch.isnan(s1[4])
                           and torch.isinf(s1[5])
                           and not w[[1, 3, 4, 5]].any()),
                      f"K9b edge groups wrong ({tag})")
                n_checks += 1
        for n_peers in (2, 3, 4):
            for bits in (4, 8):
                peers = [qz.quant_pack_wire(
                    quant_edge_batch(torch, gen, gs, f32), bits, gs)
                    for _ in range(n_peers)]
                wst = torch.stack([p[0] for p in peers])
                sst = torch.stack([p[1] for p in peers])
                add = torch.randn(wst.shape[1] * gs, generator=gen,
                                  device=DEVICE) * 1e-3
                for a in (None, add):
                    got = qz.unpack_dequant_mean(wst, sst, bits, n_peers, a)
                    ref = qz.unpack_dequant_mean_reference(wst, sst, bits,
                                                           n_peers, a)
                    check(same_bits(torch, got, ref),
                          f"K10b differs from its plain version (gs {gs}, "
                          f"n {n_peers}, int{bits}, add {a is not None})")
                    n_checks += 1
            for bits in (4, 8):
                x = quant_edge_batch(torch, gen, gs, f32)
                x = torch.cat([x, x.new_zeros((-x.numel()) % gs)])
                w, s = qz.quant_pack_wire(x, bits, gs)
                check(same_bits(torch, qz.wire_residual(x, w, s, bits),
                                qz.wire_residual_reference(x, w, s, bits)),
                      f"LoCo's residual kernel differs from its plain "
                      f"version (gs {gs}, int{bits})")
                n_checks += 1
    log(f"check K9b/K10b/residual: {n_checks} bitwise checks on edge "
        f"batches passed")

    # the embedding gradient leaf, in full
    leaf = torch.randn(EMBED_SHAPE, generator=gen, device=DEVICE)
    leaf.mul_(torch.rand(EMBED_SHAPE[0], 1, generator=gen, device=DEVICE)
              * 1e-3)
    leaf = leaf.view(-1)
    gs = QUANT_GROUP
    w, s = qz.quant_pack_wire(leaf, 4, gs)
    groups = w.shape[0]
    for g0 in range(0, groups, QUANT_CHUNK):
        g1 = min(g0 + QUANT_CHUNK, groups)
        wr, sr = qz.quant_pack_wire_reference(leaf[g0 * gs:g1 * gs], 4, gs)
        check(same_bits(torch, w[g0:g1], wr) and
              same_bits(torch, s[g0:g1], sr),
              f"K9b differs from its plain version on the embedding "
              f"gradient leaf, groups {g0}:{g1}")
        del wr, sr
    stacks = {}
    for n_peers in (2, 4):
        wst = w.view(n_peers, groups // n_peers, -1)
        sst = s.view(n_peers, groups // n_peers, 1)
        got = qz.unpack_dequant_mean(wst, sst, 4, n_peers)
        per = groups // n_peers
        for g0 in range(0, per, QUANT_CHUNK):
            g1 = min(g0 + QUANT_CHUNK, per)
            ref = qz.unpack_dequant_mean_reference(wst[:, g0:g1],
                                                   sst[:, g0:g1], 4, n_peers)
            check(same_bits(torch, got[g0 * gs:g1 * gs], ref),
                  f"K10b differs from its plain version on {n_peers} peers "
                  f"of the leaf's wire, groups {g0}:{g1}")
            del ref
        stacks[n_peers] = (wst, sst)
        del got
    res = qz.wire_residual(leaf, w, s, 4)
    for g0 in range(0, groups, QUANT_CHUNK):
        g1 = min(g0 + QUANT_CHUNK, groups)
        ref = qz.wire_residual_reference(leaf[g0 * gs:g1 * gs], w[g0:g1],
                                         s[g0:g1], 4)
        check(same_bits(torch, res[g0 * gs:g1 * gs], ref),
              f"LoCo's residual kernel differs from its plain version on "
              f"the leaf's int4 wire, groups {g0}:{g1}")
        del ref
    del res
    torch.cuda.synchronize()
    log(f"check K9b on the {EMBED_SHAPE} float32 gradient leaf, K10b on "
        f"stacks of 2 and 4 of its chunks, LoCo's residual on its int4 "
        f"wire: bit for bit")

    # K11: the down projection, bf16, two shards; float32 and an odd edge
    M, K, N = WORLD_SPEC["gemm"]
    x = torch.randn(M, K, generator=gen, device=DEVICE).to(bf16)
    wm = (torch.randn(K, N, generator=gen, device=DEVICE) / K ** 0.5).to(bf16)
    got = fcm.shard_major_matmul(x, wm, WORLD_SIZE)
    ref = fcm.matmul_reference(x, wm)
    limit = matmul_limit(torch, x, wm, got, ref)
    tag = "K11 shard_major_matmul bf16 [4096, 14336] @ [14336, 4096]"
    errs["shard_major_matmul"] = _compare_limit(
        torch, f"{tag} 2 shards", got, ref, limit, MATMUL_LIMIT)
    faults = {"K11 with a 32-wide K tile dropped": dropped_tile(
        torch, lambda xd: fcm.matmul_reference(xd, wm), x),
              "K11 with its sums carried in bfloat16": bf16_sums(
        torch, x, wm)}
    planted = {name: planted_fault(torch, name, f, ref, limit)
               for name, f in faults.items()}
    del got, ref, limit, faults
    for (m, k, nn, shards) in ((300, 72, 200, 3), (64, 4096, 40, 2)):
        xe = torch.randn(m, k, generator=gen, device=DEVICE)
        we = torch.randn(k, nn, generator=gen, device=DEVICE)
        got = fcm.shard_major_matmul(xe, we, shards)
        ref = fcm.matmul_reference(xe, we)
        errs["shard_major_matmul"] = max(errs["shard_major_matmul"],
                                         _compare_limit(
            torch, f"K11 float32 [{m}, {k}] @ [{k}, {nn}] {shards} shards",
            got, ref, matmul_limit(torch, xe, we, got, ref), MATMUL_LIMIT))
    # K12: x against the two shards of the same weight on the int4 and
    # int8 wires (the prologue's operands at world 2), and an odd edge
    kk = K // WORLD_SIZE
    k12 = {}
    for bits in (4, 8):
        wires = [qz.quant_pack_wire(wm[r * kk:(r + 1) * kk], bits, gs)
                 for r in range(WORLD_SIZE)]
        wst = torch.stack([a for a, _ in wires])
        sst = torch.stack([b for _, b in wires])
        got = fcm._gathered_dequant_matmul(x, wst, sst, bits, kk, N, bf16)
        ref = fcm._gathered_dequant_matmul_reference(x, wst, sst, bits, kk,
                                                     N, bf16)
        deq = torch.cat([fcm.unpack_dequant_wire_values(
            wst[r], sst[r], bits).reshape(-1)[:kk * N].reshape(kk, N)
            for r in range(WORLD_SIZE)])
        limit = matmul_limit(torch, x, deq, got, ref)
        tag = (f"K12 gathered_dequant_matmul int{bits} [4096, 14336] x 2 "
               f"shards of [7168, 4096]")
        errs["gathered_dequant_matmul"] = max(
            errs["gathered_dequant_matmul"], _compare_limit(
                torch, tag, got, ref, limit, MATMUL_LIMIT))
        name = f"K12 int{bits} with a 32-wide K tile dropped"
        planted[name] = planted_fault(torch, name, dropped_tile(
            torch, lambda xd: fcm._gathered_dequant_matmul_reference(
                xd, wst, sst, bits, kk, N, bf16), x), ref, limit)
        k12[bits] = (wst, sst)
        del got, ref, deq, limit
    xe = torch.randn(130, 300, generator=gen, device=DEVICE)
    wires = [qz.quant_pack_wire(torch.randn(100 * 136, generator=gen,
                                            device=DEVICE), 4, 200)
             for _ in range(3)]           # a group size not a power of 2
    wst = torch.stack([a for a, _ in wires])
    sst = torch.stack([b for _, b in wires])
    got = fcm._gathered_dequant_matmul(xe, wst, sst, 4, 100, 136, f32)
    ref = fcm._gathered_dequant_matmul_reference(xe, wst, sst, 4, 100, 136,
                                                 f32)
    deq = torch.cat([fcm.unpack_dequant_wire_values(
        wst[r], sst[r], 4).reshape(-1)[:100 * 136].reshape(100, 136)
        for r in range(3)])
    errs["gathered_dequant_matmul"] = max(
        errs["gathered_dequant_matmul"], _compare_limit(
            torch, "K12 float32 [130, 300] x 3 int4 shards of [100, 136], "
                   "group 200",
            got, ref, matmul_limit(torch, xe, deq, got, ref), MATMUL_LIMIT))
    torch.cuda.synchronize()

    # timing, each at the main path's shapes
    rows = []
    n_el = leaf.numel()
    specs = {
        "quant_pack_wire_int4": (
            lambda: qz.quant_pack_wire(leaf, 4, gs),
            lambda: qz.quant_pack_wire_reference(leaf, 4, gs), None,
            n_el * 4 + n_el // 2 + 4 * groups, 4 * n_el, F32_FLOPS,
            {"x": list(EMBED_SHAPE), "dtype": "f32", "group_size": gs}),
        "unpack_dequant_mean": (
            lambda: qz.unpack_dequant_mean(*stacks[2], 4, 2),
            lambda: qz.unpack_dequant_mean_reference(*stacks[2], 4, 2),
            None, groups * (gs // 2 + 4) + (groups // 2) * gs * 4,
            2 * n_el, F32_FLOPS,
            {"peers": 2, "wire": list(stacks[2][0].shape)}),
        "wire_residual": (
            lambda: qz.wire_residual(leaf, w, s, 4),
            lambda: qz.wire_residual_reference(leaf, w, s, 4), None,
            n_el * 4 + n_el // 2 + 4 * groups + 4 * n_el, 2 * n_el,
            F32_FLOPS, {"x": list(EMBED_SHAPE), "dtype": "f32",
                        "group_size": gs, "wire": "int4"}),
        "shard_major_matmul": (
            lambda: fcm.shard_major_matmul(x, wm, WORLD_SIZE),
            lambda: fcm.matmul_reference(x, wm),
            lambda: torch.matmul(x, wm),
            2 * (M * K + K * N + M * N), 2 * M * K * N, BF16_FLOPS,
            {"x": [M, K], "w": [K, N], "dtype": "bf16", "shards": 2}),
        "gathered_dequant_matmul": (
            lambda: fcm._gathered_dequant_matmul(x, *k12[4], 4, kk, N, bf16),
            lambda: fcm._gathered_dequant_matmul_reference(
                x, *k12[4], 4, kk, N, bf16), None,
            2 * M * K + K * N // 2 + 4 * k12[4][1].numel() + 2 * M * N,
            2 * M * K * N, F32_FLOPS,
            {"x": [M, K], "shards": 2, "w_shard": [kk, N], "wire": "int4"}),
    }
    for name, (kern, plain, lib, nbytes, flops, peak, shape) in \
            specs.items():
        ms = cuda_ms(torch, kern, 10)
        plain_ms = cuda_ms(torch, plain, 3, warmup=1)
        lib_ms = cuda_ms(torch, lib, 10) if lib is not None else None
        b_ms, b_by = bound_ms(nbytes, flops, peak)
        log(f"time {name} {shape}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
            f"{b_by}; plain {plain_ms:.3f} ms; library "
            f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'})")
        rows.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                     "bytes": nbytes, "flops": flops, "shape": shape})
    del leaf, w, s, stacks, x, wm, k12
    _free(torch)
    return errs, rows, planted


def world_kernel_entries(rows, res, errs):
    """The ``kernels`` JSON entries of K9b, K10b, LoCo's residual, K11 and
    K12: launches of rank 0's qgZ steps (K9b, K10b), qgZ + LoCo steps (the
    residual) and fused-gemm calls (K11, K12)."""
    launches = {**res[0]["qgz"]["launches"],
                "wire_residual": res[0]["qgz_loco"]["launches"][
                    "wire_residual"],
                **{k: res[0]["fused_gemm"]["launches"][k]
                   for k in ("shard_major_matmul", "gathered_dequant_matmul")}}
    libs = {"quant_pack_wire_int4": QUANT_LIBRARY,
            "unpack_dequant_mean": "none: no single PyTorch call unpacks, "
                                   "dequantizes and averages n peers' wires",
            "wire_residual": "none: no single PyTorch call unpacks an int4 "
                             "wire and subtracts it in one rounding",
            "shard_major_matmul": "torch.matmul(x, w)",
            "gathered_dequant_matmul": "none: no single PyTorch call "
                                       "multiplies by int4/int8 wire shards"}
    out = []
    for row in rows:
        name = row["name"]
        source, replaces = WORLD_KERNELS[name]
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": errs[name], "ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"], "library": libs[name],
                    **{k: row[k] for k in ("shape", "bytes", "flops")}})
    return out


def main_shapes():
    """The shapes the main path hands the kernels (llama3_8b widths, the
    default engine: page 64, max_ctx 2048 → 32 pages per sequence, a pool
    of 16 sequences x 32 layers): K6 a mixed 256-token SplitFuse batch
    (two decode rows, a continued prompt chunk, a fresh prompt chunk, six
    padding rows), K7 the 8-sequence decode window of 128-1024 token
    prompts 32 tokens in."""
    NB = 2048 // 64
    return {
        "KV": 8, "G": 4, "hd": 128, "ps": 64, "NB": NB,
        "n_pages": 32 * 16 * NB + 1,
        "k6_q_lens": [1, 1, 200, 48, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        "k6_kv_lens": [129, 257, 712, 48, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                       0],
        "k6_pad": 6,
        "k7_kv_lens": [n + 32 for n in (128, 256, 384, 512, 640, 768, 896,
                                        1024)],
    }


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from deepspeed_tpu_torch.inference.v2.kernels import ragged_ops as ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    try:
        phase_card(torch)
        ptxas = phase_build(torch)
        shapes = main_shapes()
        errs = phase_kernel_checks(torch, ops, shapes)
        phase_decode_split_checks(torch, ops, shapes)
        train_errs = phase_train_kernel_checks(torch)
        opt_errs = phase_optimizer_kernel_checks(torch)
        phase_sparse_kernel_checks(torch)
        quant_checks = phase_quant_kernel_checks(torch, ops)
        launches, serving, model, prompts, bf16_out = phase_main_path(
            torch, ops)
        kernels = phase_timing(torch, ops, shapes, launches, errs)
        del shapes                       # the serving timing inputs
        torch.cuda.empty_cache()
        quant, quant_rows = phase_quant_serving(torch, ops, model, prompts,
                                                bf16_out)
        handoff, handoff_rows = phase_handoff(torch, model, prompts,
                                              len(bf16_out[0]))
        del model
        _free(torch)
        train_launches, training = phase_train_main_path(torch)
        fa_launches, fused_adam = phase_fused_adam_main_path(torch, training)
        others = phase_other_fused(torch, fused_adam["losses"][0])
        checkpoint = phase_checkpoint(torch)
        kernels += phase_train_timing(torch, train_launches, train_errs)
        for row in kernels:
            names = REDESIGNED.get(row["name"], ())
            if names:
                row["ptxas"] = {n: ptxas[n] for n in names if n in ptxas}
        opt_launches = {"fused_adam": fa_launches["fused_adam"],
                        **{n: o["launches"] for n, o in others.items()}}
        kernels += phase_optimizer_timing(torch, opt_launches, opt_errs)
        sparse_launches, sparse, sparse_errs = phase_sparse_main_path(torch)
        kernels += phase_sparse_timing(torch, sparse_launches, sparse_errs,
                                       sparse)
        kernels += quant_kernel_entries(
            quant_rows + handoff_rows,
            {**quant["launches"], **handoff["launches"]},
            {**quant["max_abs_err"], **handoff["max_abs_err"]})
        world_errs, world_rows, planted = world_kernel_checks(torch)
        world = phase_world(torch)
        kernels += world_kernel_entries(world_rows, world, world_errs)
        check(len(kernels) == 23, f"{len(kernels)} kernels timed, not 23 "
                                  f"(22 TPU kernels and LoCo's residual)")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"serving": serving}))
    log(json.dumps({"training": training}))
    log(json.dumps({"training_fused_adam": fused_adam,
                    "other_fused_optimizers": others,
                    "checkpoint": checkpoint}))
    log(json.dumps({"sparse_attention": sparse}))
    log(json.dumps({"quantization": {"edge_checks": quant_checks,
                                     "weight_only": quant,
                                     "handoff": handoff}}))
    log(json.dumps({"data_parallel_world": world,
                    "matmul_planted_faults_over_limit": planted}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero before the last line is printed:

  1. the card: ``nvidia-smi`` name and power limit, ``nvcc``;
  2. build the CUDA kernels afresh from ``deepspeed_tpu_torch/csrc`` (one
     ``nvcc`` per source, in parallel; libraries an earlier process left
     in the build directory are removed first) and print the build time
     and ptxas report,
     with the registers, spills and static shared memory of the kernels
     redesigned for Hopper (``REDESIGNED``: K6, K7, K4, K2, K3, K1, K11,
     K12, K16/K17, K18 and K19); a spill in one of them, or a wgmma
     serialization warning outside K4's (there since its redesign), fails
     the run; the hd-256 instances of the exact tile kernels (K1-K3,
     K16-K19) are logged with their spills, not gated; and build the
     designs K12's, K16/K17's, K18's and K19's redesigns replaced from
     their copies in ``deepspeed_tpu_torch/utils/probe_parents/`` (timing
     only);
  3. hold each kernel against its plain PyTorch version on the card: at the
     serving path's shapes (hd 128, 8 KV heads, G 4, page 64, bf16; K6's
     bf16 kernel within two ulps plus FLASH_BF16_TERMS of |P|@|V|, since
     it rounds P to bf16, two calls bit for bit, and a planted fault, one
     64-position context chunk dropped from the longest row's sequence,
     that must read at least 10x the limit) and on float32 edge batches
     (padding rows, zero-length rows, contexts ending on a page edge, a
     NaN-poisoned sequence); then K7's split-context design: the same q
     and K/V rows paged at 64 and at 128 must give bit-equal outputs, two
     calls bit-equal ones, on the split-edge lengths (0, 1, 63, 64, 65,
     127, 128, 129, 1000, 2048) in bf16 and f32 against the plain version;
     NSPLIT and the live first-pass blocks are logged; then K6 and K7 on
     edge batches (``PAGED_EDGES``: hd 7, 16, 80, 96, 100 and 256; G 1, 3,
     16 and 71) in bf16 and f32, without ALiBi and with Bloom's and
     Falcon's (kv_lens past 256), NaN isolation in both; then ``TransformerConfig.tiny()`` (hd 16) through
     its default kernels: ``generate`` with ``attn_impl="paged"`` (K6, K7)
     against ``"gather"``, and 4 training steps with ``attn_impl="auto"``
     at S 128 (K1-K4; hd 16 zero-padded to 64) against the unfused path;
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
     before every timed launch, beside the card's bound; K6 and its SDPA
     call also by their kernels' own device time (``device_ms``,
     ``torch.profiler``);
  6. hold each training kernel against its plain version: flash attention
     forward (O, LSE), dQ and dK/dV at B 4, S 2048, H 32 (8 KV heads
     repeated), hd 128, bf16, causal, and on float32 edge batches (S 1,
     100, 257; causal and full; hd 64 and 128; G 1 and 4) and bf16 ones
     (S 1, 63, 64, 65, 127, 128, 129, 100, 257: the bf16 kernels' tile
     edges; causal and full; hd 64 and 128), and at hd 16, 80 and 96
     (zero-padded to 64 or 128 by the wrappers) in bf16 and float32; the
     fused RMSNorm+matmul at M 8192, D 4096, F 4096/1024/14336 in bf16, at
     M 100, F 1000 in float32 and bf16, and at D/F 4093/1003 and 61/45
     (zero-padded to multiples of 8) and with x off 16-byte alignment
     (copied); each elementwise against a stated limit; K1, K2, K3
     and K4 twice bit for bit at the main shapes, and planted faults that
     must read at least 10x their limits (K4: one 64-deep k-stage skipped;
     K1: one 128-key tile dropped from O; K2: one 64-key tile dropped from
     dQ; K3: one 64-query tile dropped from dK and dV);
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
     then ZeRO at one device (``phase_zero_offload``, FusedAdam, bf16,
     remat, 4 x 2048 tokens): stage 0, stage 2, the optimizer state on
     the host, Twin-Flow 0.5 and ``pipeline_read`` at ZERO_LAYERS, 2 + 5
     steps each, losses and masters bit for bit with stage 0 (step time,
     peak memory, pinned bytes, each step's H2D/D2H bytes, milliseconds
     and GB/s, K5's launches; the counters of K1-K5 set to 0 before the
     timed steps and read after); a planted fault (one leaf's moments
     never written back) the bit check must catch; an injected
     ``offload_prefetch`` failure (one failure, the same losses);
     ``offload_states``/``reload_states`` on cpu and nvme after step 3,
     steps 4-7 bit for bit; ZERO_BIG_LAYERS layers (81.7 GB of resident
     state) with the state on the host, after ``MemAvailable`` is found
     to hold it, the loss falling; Muon (its Newton-Schulz time a step,
     one tiny step against the CPU's); a client ``torch.optim.AdamW``
     with a save/load round trip continuing bit for bit;
 12. time each training kernel beside its bound, its plain version and one
     PyTorch call (SDPA forward and backward; ``F.rms_norm`` plus
     ``torch.matmul``), log the port's whole attention backward (delta, K2
     and K3 through ``_FlashAttention.backward``) beside SDPA's backward,
     and time each optimizer kernel over every leaf of the
     4-layer model (``torch.optim.AdamW(fused=True)`` and
     ``torch.optim.Adagrad`` as the library calls of K5 and K15);
 13. (after phase 8) hold the block-sparse attention kernels K16-K19
     against their plain versions on 16 edge batches: float32 and bf16,
     block 16, 32, 64 and 128, hd 64 and 128, each layout class in turn,
     per-head layouts, an emptied q-block row (O = 0, LSE = -1e30 exactly)
     and S off the block grid (K16, K18 and K19 twice on each, bit for
     bit; K17's O equal to K16's); and at hd 16, 80 and 96 (zero-padded);
     then K1-K3 and K16-K19 at hd 160 and 256 (the exact tile kernels, 160
     zero-padded) in bf16 and float32 against their plain versions, and
     each timed at hd 256 in bf16 (timing only);
 14. the sparse-attention path: ``SparseSelfAttention(cfg)(q, k, v,
     use_kernel=True)`` at llama3-8B attention width (B 1, H 32, S 8192,
     hd 128, bf16, block 64): under ``torch.no_grad()`` with the Fixed
     layout, K17 alone must launch, once a call; with q, k, v requiring
     grad and ``loss.backward()``, with the Fixed and the BigBird layout,
     K16, K18 and K19 once each a step; the serving output against the
     masked-dense path (8 heads at a time), the training gradients bitwise
     equal to the kernels called directly, and K16-K19 against their plain
     versions at this width; K16, K18 and K19 against planted faults (one
     k-block left out of the shortest layout list of two or more for O and
     dQ, one q-block out of the shortest transposed list for dK and dV),
     which must read at least 10x their limits;
 15. time K16-K19 at that shape beside their bound, their plain versions,
     SDPA with the expanded boolean token mask (timing only) and K1's
     causal dense forward (for scale); the parent designs of K16-K19 on
     both layouts and K19 at the configs' default block 16 (the kept exact
     path), timing only; print the sparse results' line, the hd-256 line and
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
 19. (after phase 18, on phase 4's model) prefix reuse and the KV memory
     tier (``phase_prefix_serving``): a prefix-cache engine
     (``num_blocks=96``, ``host_tier_mb=512``) and a cache-off one, in
     the lifecycle scheduler's call order; a shared 1,024-token system
     prompt with 8 suffixes (request 7 grafts a partial page by
     copy-on-write), each grafted request's first-token logits within
     ``SERVING_LOGITS_REL`` of its cold twin's and, as the twin puts the
     same chunks, its logits and tokens bit for bit, the shared page's
     bits unchanged (a planted fault, one word of a copy-on-write copy
     flipped, must fail the bit-for-bit check); four unrelated
     1,280-token prompts evict the whole trie (the full pages spilled to
     the host); the prompt grafted back from the host bit for bit (a
     planted fault, one host value one bf16 ulp up, must show as the one
     difference);
     a sequence spilled, flushed and restored bit for bit, its logits
     against the cache-off run's; a ``decode_window``/``nan`` window
     flagging only its first uid, its batchmate's tokens equal to a clean
     window's; K6's and K7's counters must rise; times to first token,
     prefill tokens saved, and the spills' and restores' bytes and
     seconds printed beside the card's name and power limit;
 19a. (after phase 19, on phase 4's model and prompts) speculative
     decoding (``phase_speculative``): vanilla fused decode and
     ``speculative_decode`` (k = ``SPEC_K``, ``SPEC_NEW`` tokens) with
     ``NGramDrafter`` (twice: the same tokens), a same-weights draft
     engine, a ``SPEC_DRAFT_LAYERS``-layer draft and an always-wrong
     drafter (one window a token, KV lengths and blocks as the rollbacks
     leave them); every verify window launches K6 once a layer and K7
     never; a NaN-poisoned verify window flags only its first uid and
     its batchmate equals a clean repeat bit for bit; every emitted
     token, and every first rejected candidate of the same-weights
     draft, within ``SPEC_MARGIN`` of the argmax of a teacher-forced
     re-score (``spec_content_check``: ``SPEC_MARGIN_FACTOR`` x the
     card's own paged-vs-gather difference on that batch, at most
     ``SPEC_MARGIN_CAP``, the two re-scores within
     ``SERVING_LOGITS_REL``), and the run with ``rollback_kv`` skipped
     at least ``SPEC_FAULT_FACTOR`` x it;
     per-user tokens/s, acceptance and K6 launches a window printed;
 19b. (after phase 19a, on phase 4's model, prompts and ``generate``
     streams) the serving lifecycle (``phase_serving_lifecycle``):
     ``LifecycleScheduler(window_steps=8).run_until_idle()`` on the 8
     prompts, 64 new tokens each (K6 and K7 must launch); KV-pressure
     preemption on a 40-page pool, a priority-1 arrival preempting a
     priority-0 decode, resumed by recompute and from a 512 MB host tier
     (a swap-in), both within the margin of their re-scores, and a
     planted fault (the resume re-prefills its last token twice)
     reported against it (above 1 x; it read 4.42 x on the H100, short
     of ``SPEC_FAULT_FACTOR``, which is not held); a ``decode_window``/``nan`` window
     failing only its poisoned uid (health ``degraded``); then
     ``ServingServer`` on 127.0.0.1: the 8 prompts from 8 concurrent
     clients, an SSE stream, 429 with ``Retry-After`` from a filled
     queue of 2, ``predicted_tok_per_s`` equal to the last clean decode
     window's roofline, ``/v1/prefill`` on fp32 and int8 into
     ``kv_import`` (K9a and K10a must launch; the int8 frame at most 0.3
     x the fp32 one), a client dropping its stream (CANCELLED, pages
     back), ``drain_and_stop`` with a 503 during the drain, and the
     command-line server answering and exiting 0 on SIGTERM; every
     stream of ``generate``, the scheduler and the server within
     ``SPEC_MARGIN`` of its re-score; times to first token, time per
     output token, decode tok/s against ``generate``'s, the HTTP cost
     of a request and the decode roofline printed beside the card;
 19c. (after ``del model``) the universal families (``phase_families``):
     Bloom-7b1 at its published widths and depth (ALiBi) and Falcon-7b
     at its published widths, 8 of 32 layers (71 query heads on one KV
     head): ``generate`` (untimed, then ``REPEATS`` timed; K6 and K7 must
     launch), paged vs gather within ``SERVING_LOGITS_REL``, and on Bloom
     ``speculative_decode`` with ``NGramDrafter`` under the content
     check (the margin at most ``SPEC_MARGIN_CAP``); weights and pool
     bytes printed;
 19d. (after phase 19c) MoE serving (``phase_moe_serving``): Mixtral-8x7B
     widths cut to ``MIXTRAL_LAYERS`` of 32 layers (46.97 GB of bf16
     weights, the router float32) on the default engine (cf 2.0): layer
     0's routing on 64 flat tokens (8 padding) at cf 2.0 and 0.5, the
     card's gate equal to the CPU's on the same logits (slots, capacity
     and counts; values within ``MOE_GATE_ULPS``), also with planted
     ties, the bf16 block within ``MOE_LIMIT`` of its float32 CPU run
     from the card's slots, and a planted fault (the drop mask left out)
     above it; ``generate`` on 8 prompts of 128-1024 tokens, ``MOE_NEW``
     new tokens each (untimed with the schedule and the gates recorded,
     then ``REPEATS`` timed; K6 and K7 must launch), dropped assignments
     a put and a decode step, the decode roofline, a profiled 8 x 8
     window, and every emitted token within ``SPEC_MARGIN`` of its
     teacher-forced re-score in the same batches, routed as
     ``generate`` was (``moe_content_check``);
 20. (last) hold the data-parallel kernels against their plain versions:
     K9b ``quant_pack_wire(bits=4)`` bit for bit on the int8 phase's edge
     batches (even group sizes) and on a 525 M-element float32 leaf of the
     embedding gradient's shape (2**20 groups at a time); K10b
     ``unpack_dequant_mean`` bit for bit on n = 2, 3, 4 peers of edge-batch
     wires (int4 and int8, with and without LoCo's addend) and on stacks of
     2 and 4 chunks of that leaf's wire; LoCo's residual (K10a's variant
     ``wire_residual``) bit for bit on the edge batches' int4 and int8
     wires and on that leaf's int4 wire; K11 ``shard_major_matmul`` at the
     down projection's shapes (x [4096, 14336] @ w [14336, 4096], bf16, 2
     shards; the same bits at 1, 2 and 4 shards and across two calls) and
     on bf16 and float32 edges (M 300, K 72, N 200 in 3 shards; M 64, K
     4096, N 40 in 2; K and N off multiples of 8, 75/203 and 61/45,
     zero-padded by the wrapper; x off 16-byte alignment, copied), K12
     ``_gathered_dequant_matmul`` at x [4096, 14336] bf16 against 2 int4
     and int8 shards of [7168, 4096] and on ``K12_EDGES`` (M, k and N off
     its tiles and stages, group 200, odd N, float32 and bf16 x), two
     calls bit for bit, each within an elementwise limit set from the
     roundings' statistics (``matmul_limit``), with planted faults (K11: a
     32-wide K tile dropped, its sums carried in bfloat16; K12: a 16-deep
     k-stage dropped, which must read at least 10x the limit) read against
     the same limits and required to exceed them; each timed at those
     shapes beside its bound, its plain version and, for K11,
     ``torch.matmul`` (timing only); K12 also on the int8 wire, its parent
     design, and the float32 ``torch.matmul`` by the weight already
     dequantized (a yardstick without the dequantize);
 21. the data-parallel world: ``launcher.run_local_world`` spawns 2 gloo
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
 22. print ``{"ok": true, "device": {...}}`` as the last line.
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
#: nvidia-smi's "name, power.limit" of the card, printed beside times
CARD = "not read"
#: serving logits of two paths through bf16 activations (paged vs gather,
#: grafted vs cold): relative l2 error
SERVING_LOGITS_REL = 5e-2

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

# K6's bf16 kernel rounds P to bf16 (relative error <= 2**-9 a term) before
# P.V, as K1 does, so its limit adds FLASH_BF16_TERMS of |P|@|V| (the plain
# version on a pool whose V half is |V|) to the two-ulp output rounding
K6_CHUNK = 64                      # K6's walked context chunk (hd <= 128)

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


def device_ms(torch, fn, iters=20):
    """Mean device time of the kernels ``fn`` launches, in ms, from
    ``torch.profiler`` (the kernels' own durations, without the host's
    launch latency that ``cuda_ms``'s events also take in when the host is
    slower than the card). Before every call a 256 MB buffer is inverted
    (its kernel is left out of the sum), as ``cuda_ms`` flushes the L2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    global _flush_buf
    if _flush_buf is None:
        _flush_buf = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device=DEVICE)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            _flush_buf.bitwise_not_()
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == DeviceType.CUDA
                and "bitwise_not" not in e.name
                and e.name != "Command Buffer Full")
    return total / 1e3 / iters


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
    global CARD
    CARD = smi.stdout.strip()
    log(CARD)
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


def ptxas_wide_heads(log_text, names):
    """{"<kernel> <dtype> tile <rows>": {"registers", "spill_bytes",
    "stack_bytes", "smem_bytes"}} from ``nvcc -Xptxas -v`` output, for
    each hd-256 instance (``Li256E`` in its mangled name) of the entry
    functions named in ``names``."""
    import re

    out = {}
    for fn in re.findall(r"Compiling entry function '(\S+)'", log_text):
        name = next((n for n in names if f"{n}I" in fn), None)
        tile = re.search(r"Li256ELi(\d+)E", fn)
        if name and tile:
            dt = "bf16" if "nv_bfloat16" in fn else "f32"
            out[f"{name} {dt} tile {tile.group(1)}"] = ptxas_report(
                log_text, (fn,))[fn]
    return out


# the kernels redesigned for Hopper (mma.sync + cp.async K6, split-context
# K7, TMA + wgmma K4, K2, K3, K1, K11, K16/K17, K18 and K19, the
# register-blocked float32 K12), by source; their dynamic shared memory
# comes on top of ptxas's static figure
REDESIGNED = {
    "ragged_paged_attention": ("ragged_paged_mma_kernel",),
    "decode_paged_attention": ("decode_split_kernel", "decode_merge_kernel"),
    "rmsnorm_matmul": ("rms_rows_kernel", "rmsnorm_matmul_wgmma_kernel"),
    "flash_attention_bwd": ("flash_bwd_dq_wgmma_kernel",
                            "flash_bwd_dkv_wgmma_kernel"),
    "flash_attention_fwd": ("flash_fwd_wgmma_kernel",),
    "collective_matmul": ("shard_major_matmul_wgmma_kernel",
                          "gathered_dequant_matmul_kernel"),
    "block_sparse_attention_fwd": ("bs_fwd_wgmma_kernel",),
    "block_sparse_attention_bwd": ("bs_dq_wgmma_kernel",
                                   "bs_dkv_wgmma_kernel"),
}
# a redesigned kernel's row in the kernels line, where that is not its
# source's name
REDESIGNED_ROWS = {"flash_bwd_dq_wgmma_kernel": "flash_attention_bwd_dq",
                   "flash_bwd_dkv_wgmma_kernel": "flash_attention_bwd_dkv",
                   "shard_major_matmul_wgmma_kernel": "shard_major_matmul",
                   "gathered_dequant_matmul_kernel":
                       "gathered_dequant_matmul",
                   "bs_fwd_wgmma_kernel": "block_sparse_fwd",
                   "bs_dq_wgmma_kernel": "block_sparse_bwd_dq",
                   "bs_dkv_wgmma_kernel": "block_sparse_bwd_dkv"}
# the exact tile kernels that carry hd 256 (K1-K3, K16-K19), by source:
# their hd-256 instances' registers and spills are logged, not gated
WIDE_HEAD_KERNELS = {
    "flash_attention_fwd": ("flash_fwd_kernel",),
    "flash_attention_bwd": ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"),
    "block_sparse_attention_fwd": ("bs_fwd_kernel",),
    "block_sparse_attention_bwd": ("bs_dq_kernel", "bs_dkv_kernel"),
}
# the designs K12's, K16/K17's, K18's and K19's redesigns replaced, built
# from their copies in deepspeed_tpu_torch/utils/probe_parents/
# (kernel_probe.build_parents) and timed beside the tree's: {source:
# library} (the block_sparse_attention_bwd copy holds K19's design and
# K18's, which K19's redesign left as it was)
_PARENT_LIBS = {}


def phase_build(torch):
    from deepspeed_tpu_torch.ops.op_builder import get_builder, load_kernels

    builder = get_builder()
    # build afresh: a library an earlier process left in the build
    # directory would load without ptxas's report, which the spill check
    # below reads
    if os.path.isdir(builder.build_dir):
        for f in os.listdir(builder.build_dir):
            if f.endswith(".so"):
                os.remove(os.path.join(builder.build_dir, f))
    t0 = time.perf_counter()
    libs = load_kernels()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {builder.build_seconds:.1f} s)")
    from deepspeed_tpu_torch.utils import kernel_probe

    t0 = time.perf_counter()
    _PARENT_LIBS.update(kernel_probe.build_parents(kernel_probe.PARENTS))
    log(f"build: the parent designs of {sorted(_PARENT_LIBS)} (timing "
        f"only) in {time.perf_counter() - t0:.1f} s")
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
        check(rec["spill_bytes"] == 0, f"ptxas spilled {name}")
    # the exact kernels at hd 256 may spill (a thread holds 128 or 256
    # accumulator floats): logged, not gated
    for src, names in WIDE_HEAD_KERNELS.items():
        wide = ptxas_wide_heads(builder.build_log.get(src, ""), names)
        for name, rec in wide.items():
            log(f"ptxas hd 256 {name}: {rec['registers']} registers, "
                f"{rec['spill_bytes']} bytes spilled, {rec['stack_bytes']} "
                f"bytes stack")
            report[f"hd256 {name}"] = rec
    for src in REDESIGNED:
        if "serialized" not in builder.build_log.get(src, ""):
            continue
        # K4's wgmma kernel has carried C7512 ("insufficient register
        # resources") since its redesign; the others may not
        check(src == "rmsnorm_matmul",
              f"ptxas serialized the wgmma instructions of {src}")
        log(f"ptxas serialized some wgmma instructions of {src}")
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


def abs_v_pool(pages, KV):
    """A copy of the page pool with its V half replaced by |V|: the plain
    paged attention on it gives sum_j P_j |V_j|, the terms' magnitudes
    behind each output."""
    t = pages.clone()
    t[:, :, KV:] = t[:, :, KV:].abs()
    return t


def ragged_limit(torch, ops, q, pages, kvl, pt, cu, KV, ref, **kw):
    """K6's per-element limit (see K6_CHUNK's note) → (limit, why)."""
    if q.dtype == torch.bfloat16:
        terms = ops.ragged_paged_attention_reference(
            q, abs_v_pool(pages, KV), kvl, pt, cu, num_kv_heads=KV,
            **kw).float()
        return (BF16_ATOL + BF16_RTOL * ref.float().abs()
                + FLASH_BF16_TERMS * terms,
                f"{BF16_ATOL:.0e} + {BF16_RTOL:.3g}*|ref| + "
                f"{FLASH_BF16_TERMS:.3g}*|P|@|V|")
    return F32_ATOL + 0.0 * ref, f"{F32_ATOL:.0e}, float32"


def check_ragged(torch, ops, tag, q, pages, kvl, pt, cu, KV, **kw):
    """K6 against its plain version within ``ragged_limit``, and (bf16)
    two calls bit for bit. → max abs error."""
    out = ops.ragged_paged_attention(q, pages, kvl, pt, cu, num_kv_heads=KV,
                                     **kw)
    ref = ops.ragged_paged_attention_reference(q, pages, kvl, pt, cu,
                                               num_kv_heads=KV, **kw)
    limit, why = ragged_limit(torch, ops, q, pages, kvl, pt, cu, KV, ref,
                              **kw)
    err = _compare_limit(torch, f"ragged_paged_attention {tag}", out, ref,
                         limit, why)
    if q.dtype == torch.bfloat16:
        again = ops.ragged_paged_attention(q, pages, kvl, pt, cu,
                                           num_kv_heads=KV, **kw)
        check(torch.equal(again, out), f"ragged {tag}: two calls differ")
    return err


def ragged_dropped_chunk(torch, ops, q, pages, kvl, pt, cu, KV, s, lo, hi):
    """The plain K6 with context positions [lo, hi) of sequence s left out
    of its rows' softmax (a CTA that lost a walked chunk). → output."""
    out = ops.ragged_paged_attention_reference(q, pages, kvl, pt, cu,
                                               num_kv_heads=KV).float()
    H, hd = q.shape[1], q.shape[2]
    G, ps = H // KV, pages.shape[1]
    q0, q1, L = int(cu[s]), int(cu[s + 1]), int(kvl[s])
    n = q1 - q0
    ctx = pages[pt[s, :-(-L // ps)].long()].reshape(-1, 2 * KV, hd)[:L]
    k = ctx[:, :KV].float().repeat_interleave(G, dim=1)
    v = ctx[:, KV:].float().repeat_interleave(G, dim=1)
    sc = torch.einsum("thd,chd->htc", q[q0:q1].float(), k) / math.sqrt(hd)
    pos = torch.arange(L, device=q.device)
    q_pos = L - n + torch.arange(n, device=q.device)
    keep = (pos[None, :] <= q_pos[:, None]) & ~((pos >= lo) & (pos < hi))
    sc = torch.where(keep[None], sc, -1e30)
    out[q0:q1] = torch.einsum("htc,chd->thd", torch.softmax(sc, dim=-1), v)
    return out.to(q.dtype)


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
    errs["ragged_paged_attention"] = check_ragged(
        torch, ops, "bf16 main shapes", *args, m["KV"])
    # a planted fault: the longest row's sequence with one walked chunk
    # dropped must read far above the limit
    s_long = max(range(len(m["k6_q_lens"])),
                 key=lambda i: m["k6_kv_lens"][i] * (m["k6_q_lens"][i] > 0))
    lo = (m["k6_kv_lens"][s_long] // 2) // K6_CHUNK * K6_CHUNK
    ref = ops.ragged_paged_attention_reference(*args, **kw)
    limit, _ = ragged_limit(torch, ops, *args, m["KV"], ref)
    fault = ragged_dropped_chunk(torch, ops, *args, m["KV"], s_long, lo,
                                 lo + K6_CHUNK)
    errs["ragged_paged_attention_fault_x"] = planted_fault(
        torch, f"K6 with the context chunk [{lo}, {lo + K6_CHUNK}) of "
        f"sequence {s_long} dropped", fault, ref, limit)
    check(errs["ragged_paged_attention_fault_x"] >= 10.0,
          f"K6's limit reads a dropped chunk at only "
          f"{errs['ragged_paged_attention_fault_x']:.2f}x, not >= 10x")
    del ref, limit, fault
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


# K6/K7 edge batches beyond the main shapes, (KV, G, hd, ps): head dims off
# 64/128 (16, 80, 96, 256; 100 and 7 take 8- and 2-byte copies), groups of
# 1, 16 and 71 (Falcon-7B's MQA width)
PAGED_EDGES = ((2, 1, 16, 16), (2, 4, 80, 64), (2, 16, 96, 32),
               (1, 71, 16, 64), (2, 2, 256, 64), (2, 3, 100, 16),
               (1, 4, 7, 16))


def phase_paged_edge_checks(torch, ops):
    """K6 and K7 against their plain versions on edge batches (PAGED_EDGES)
    in bf16 and float32, without ALiBi and with both forms (kv_lens past
    256, where Falcon's bf16(k_pos) is inexact): padding rows, empty and
    interior-empty rows, page edges; K6's bf16 kernel two calls bit for
    bit; a NaN-poisoned sequence reaching no other row in either kernel.
    → the number of checks."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    n = 0
    for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for KV, G, hd, ps in PAGED_EDGES:
            NB = 640 // ps
            q_lens = [7, 0, 1, 16, 1, 33, 0, 0]      # interior/trailing zeros
            kv_lens = [7, 0, 64, 16, 300, 400, 0, 0]
            q, pages, kvl, pt, cu = paged_inputs(
                torch, gen, KV=KV, G=G, hd=hd, ps=ps, NB=NB,
                n_pages=9 * NB + 1, q_lens=q_lens, kv_lens=kv_lens,
                dtype=dtype, pad_tokens=5)
            dec_lens = [33, 0, 64, 1, 0, 500, 16, 300]
            qd, pd, kd, ptd, _ = paged_inputs(
                torch, gen, KV=KV, G=G, hd=hd, ps=ps, NB=NB,
                n_pages=9 * NB + 1, q_lens=None, kv_lens=dec_lens,
                dtype=dtype)
            for alibi in (None, False, True):
                kw = ({} if alibi is None else
                      dict(alibi=ops.alibi_slopes(KV * G).tolist(),
                           alibi_scaled=alibi))
                form = ("none" if alibi is None
                        else "falcon" if alibi else "bloom")
                tag = f"{dt} KV={KV} G={G} hd={hd} ps={ps} alibi={form}"
                check_ragged(torch, ops, tag, q, pages, kvl, pt, cu, KV, **kw)
                n += 1
                out = ops.ragged_paged_attention(q, pages, kvl, pt, cu,
                                                 num_kv_heads=KV, **kw)
                check(bool((out[-5:] == 0).all()),
                      f"ragged {tag}: padding rows not 0")
                dec = ops.decode_paged_attention(qd, pd, kd, ptd,
                                                 num_kv_heads=KV, **kw)
                ref = ops.decode_attend_dense(qd, pd, kd, ptd,
                                              num_kv_heads=KV, **kw)
                if dt == "bf16":
                    _compare(torch, f"decode_paged_attention {tag}", dec,
                             ref, BF16_ATOL, BF16_RTOL)
                else:
                    _compare(torch, f"decode_paged_attention {tag}", dec,
                             ref, F32_ATOL)
                check(bool((dec[[1, 4]] == 0).all()),
                      f"decode {tag}: kv_lens==0 rows not 0")
                n += 1
            # NaN isolation: sequence 3 (rows 8..23) and decode row 5
            poisoned = pages.clone()
            poisoned[pt[3].long()] = float("nan")
            mates = torch.cat([torch.arange(0, 8),
                               torch.arange(24, q.shape[0])])
            clean = ops.ragged_paged_attention(q, pages, kvl, pt, cu,
                                               num_kv_heads=KV)
            out = ops.ragged_paged_attention(q, poisoned, kvl, pt, cu,
                                             num_kv_heads=KV)
            check(bool(torch.equal(out[mates], clean[mates])),
                  f"ragged {dt} G={G} hd={hd}: NaN page reached another "
                  f"sequence")
            check(bool(torch.isnan(out[8:24]).all()),
                  f"ragged {dt} G={G} hd={hd}: poisoned sequence lost its "
                  f"NaN")
            poisoned = pd.clone()
            poisoned[ptd[5].long()] = float("nan")
            clean = ops.decode_paged_attention(qd, pd, kd, ptd,
                                               num_kv_heads=KV)
            out = ops.decode_paged_attention(qd, poisoned, kd, ptd,
                                             num_kv_heads=KV)
            keep = [0, 1, 2, 3, 4, 6, 7]
            check(bool(torch.equal(out[keep], clean[keep]))
                  and bool(torch.isnan(out[5]).all()),
                  f"decode {dt} G={G} hd={hd}: NaN isolation broken")
            del q, pages, qd, pd, poisoned
    torch.cuda.synchronize()
    log(f"check paged edges: {n} K6/K7 edge checks passed (hd 7-256, G "
        f"1-71, ALiBi both forms), NaN isolation in both kernels")
    return n


def phase_tiny_config(torch, ops):
    """``TransformerConfig.tiny()`` (hd 16, 4 query heads on 2 KV heads)
    through its default kernels on the card: serving ``generate`` with
    ``attn_impl="paged"`` (K6 and K7 must launch, every token in range)
    and one ``put`` against ``"gather"``; training with ``attn_impl=
    "auto"`` at S 128 (K1-K4 must launch: the flash kernels at hd 16
    zero-padded to 64): one step's loss and gradient norm against
    ``attn_impl="xla", fused_rmsnorm="off"``, then 4 steps whose loss
    falls. → a summary dict."""
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import (CausalLM, InferenceEngineV2,
                                     RaggedInferenceEngineConfig,
                                     TransformerConfig)
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig.tiny()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    rng = np.random.default_rng(SEED + 41)
    model = CausalLM(cfg, init_params(cfg, gen, torch.bfloat16, DEVICE))
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (5, 17, 40, 64)]
    engine = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        max_ctx=cfg.max_seq_len), device=DEVICE)
    ops.ragged_paged_attention.launches = 0
    ops.decode_paged_attention.launches = 0
    out = engine.generate(prompts, max_new_tokens=16)
    torch.cuda.synchronize()
    serve = {"ragged_paged_attention": ops.ragged_paged_attention.launches,
             "decode_paged_attention": ops.decode_paged_attention.launches}
    for name, n in serve.items():
        check(n > 0, f"tiny serving never launched {name}")
    check(all(len(o) == 16 and all(0 <= t < cfg.vocab_size for t in o)
              for o in out), "tiny generate returned bad tokens")
    logits = {}
    for impl in ("paged", "gather"):
        eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            max_ctx=cfg.max_seq_len, attn_impl=impl), device=DEVICE)
        logits[impl] = eng.put([0, 1], [prompts[2], prompts[3]]).float()
        del eng
    rel = float((logits["paged"] - logits["gather"]).norm()
                / logits["gather"].norm())
    log(f"tiny serving (hd 16, G 2): launches {serve}; paged vs gather put "
        f"rel l2 {rel:.3e} (tol 5e-2)")
    check(rel <= 5e-2, f"tiny paged vs gather logits differ: rel {rel}")
    del engine, model

    tcfg = dataclasses.replace(cfg, attn_impl="auto")
    model = CausalLM(tcfg, init_params(tcfg, gen, torch.float32, DEVICE),
                     trainable=True)
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=model, config={
        "train_micro_batch_size_per_gpu": 4,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
        "gradient_clipping": 1.0, "zero_optimization": {"stage": 0},
        "bf16": {"enabled": True}}, device=DEVICE)
    batch = train_batch_tokens(torch, engine, cfg.vocab_size, cfg.max_seq_len)
    loss_k, norm_k = _loss_and_grad_norm(torch, engine, batch)
    model.config = dataclasses.replace(tcfg, attn_impl="xla",
                                       fused_rmsnorm="off")
    loss_x, norm_x = _loss_and_grad_norm(torch, engine, batch)
    model.config = tcfg
    rel_loss = abs(loss_k - loss_x) / abs(loss_x)
    rel_norm = abs(norm_k - norm_x) / abs(norm_x)
    counters = _train_counters()
    for fn in counters.values():
        fn.launches = 0
    losses = [float(engine.train_batch(batch)) for _ in range(4)]
    torch.cuda.synchronize()
    train = {name: fn.launches for name, fn in counters.items()}
    log(f"tiny training (S {cfg.max_seq_len}, attn auto): losses {losses}; "
        f"launches {train}; path check loss rel {rel_loss:.3e} (tol 1e-2), "
        f"grad norm rel {rel_norm:.3e} (tol 5e-2)")
    for name, n in train.items():
        check(n > 0, f"tiny training never launched {name}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"tiny training loss did not fall: {losses}")
    check(rel_loss <= 1e-2 and rel_norm <= 5e-2,
          f"tiny path check: loss rel {rel_loss}, grad norm rel {rel_norm}")
    del engine, model
    torch.cuda.empty_cache()
    return {"serving_launches": serve, "paged_vs_gather_rel": rel,
            "training_launches": train, "losses": losses,
            "path_check": {"loss_rel": rel_loss, "grad_norm_rel": rel_norm}}


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
    paged_vs_gather(torch, model, [prompts[1][:100], prompts[2][:120],
                                   prompts[3][:36]], "main path")
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

    def k6():
        return ops.ragged_paged_attention(q, pages, kvl, pt, cu, **kw)

    ms = cuda_ms(torch, k6, 20)
    dev = device_ms(torch, k6)
    log(f"K6 main shapes: {ms:.4f} ms (events), {dev:.4f} ms (device, "
        f"profiler)")
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
    lib_dev = device_ms(torch, lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask))
    log(f"K6's library call (SDPA, boolean mask): {lib:.4f} ms (events), "
        f"{lib_dev:.4f} ms (device)")
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
        "library_ms": lib, "device_ms": dev, "library_device_ms": lib_dev,
        "fault_x": errs["ragged_paged_attention_fault_x"],
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


PADDED_HDS = (16, 80, 96)          # head dims the wrappers zero-pad
FLASH_TILE = 64                    # the bf16 backward's walked tile
FLASH_FWD_TILE = 128               # the bf16 forward's walked key tile


def check_flash_fwd_faults(torch, fa, q, k, v):
    """K1 twice on the same inputs, bit for bit; and a planted fault from
    the plain math, read against the limit ``check_flash`` holds O to: O
    with the key tile [S/2, S/2 + FLASH_FWD_TILE) dropped from every row's
    softmax (a block that skipped a walked tile), which must read at least
    10x the limit. → the fault's reading (x the limit)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    a = fa.flash_attention_fwd(q, k, v, True, scale)
    b = fa.flash_attention_fwd(q, k, v, True, scale)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "flash_attention_fwd: two calls differ")
    log("check flash_attention_fwd: two calls bit for bit")
    del a, b
    ref, lse = fa.flash_attention_fwd_reference(q, k, v, True, scale)
    S = q.shape[1]
    keep = fa._causal_mask(S, q.device)
    s = fa._scores(q, k, scale)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    limit = (BF16_ATOL + BF16_RTOL * ref.float().abs() + FLASH_BF16_TERMS
             * torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs()))
    del p
    t0 = S // 2
    keep[:, t0:t0 + FLASH_FWD_TILE] = False
    s = torch.where(keep, s, -1e30)
    s = torch.softmax(s, dim=-1)
    fault = torch.einsum("bhqk,bkhd->bqhd", s, v.float()).to(q.dtype)
    del s
    worst = planted_fault(torch, f"O with the key tile [{t0}, "
                          f"{t0 + FLASH_FWD_TILE}) dropped", fault, ref,
                          limit)
    check(worst >= 10.0, f"K1's limit reads a dropped tile at only "
                         f"{worst:.2f}x, not >= 10x")
    return worst


def check_flash_bwd_faults(torch, fa, q, k, v, do):
    """K2 and K3 twice on the same inputs, bit for bit; and two planted
    faults from the plain math, read against the limits ``check_flash``
    holds them to: dQ with the 64-key tile [S/2, S/2 + 64) dropped (a dQ
    block that skipped a walked tile), dK and dV with the 64-query tile
    [S/2, S/2 + 64) dropped. Each must read at least 10x its limit.
    → (dQ fault reading, dK/dV fault reading), x the limit."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = fa.flash_attention_fwd_reference(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    del o
    args = (q, k, v, do, lse, delta, True, scale)
    dq = fa.flash_attention_bwd_dq(*args)
    check(torch.equal(dq, fa.flash_attention_bwd_dq(*args)),
          "flash_attention_bwd_dq: two calls differ")
    dk, dv = fa.flash_attention_bwd_dkv(*args)
    dk2, dv2 = fa.flash_attention_bwd_dkv(*args)
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
          "flash_attention_bwd_dkv: two calls differ")
    log("check flash_attention_bwd_dq, flash_attention_bwd_dkv: two calls "
        "bit for bit")
    del dq, dk, dv, dk2, dv2
    p, ds = fa.probs_and_ds(q, k, v, do, lse, delta, True, scale)
    qf, kf, dof = q.float(), k.float(), do.float()
    t0 = q.shape[1] // 2
    tile = slice(t0, t0 + FLASH_TILE)

    def limit(ref, terms):
        return (BF16_ATOL + BF16_RTOL * ref.float().abs()
                + FLASH_BF16_TERMS * terms)

    ref = fa.flash_attention_bwd_dq_reference(*args)
    lim = limit(ref, torch.einsum("bhqk,bkhd->bqhd", ds.abs(), kf.abs()))
    kept = ds.clone()
    kept[..., tile] = 0
    fault = torch.einsum("bhqk,bkhd->bqhd", kept, kf).to(q.dtype)
    x_dq = planted_fault(torch, f"dQ with the key tile [{t0}, "
                         f"{t0 + FLASH_TILE}) dropped", fault, ref, lim)
    del ref, lim, fault
    kept.copy_(ds)
    kept[:, :, tile] = 0
    ref_k, ref_v = fa.flash_attention_bwd_dkv_reference(*args)
    lim = limit(ref_k, torch.einsum("bhqk,bqhd->bkhd", ds.abs(), qf.abs()))
    fault = torch.einsum("bhqk,bqhd->bkhd", kept, qf).to(k.dtype)
    x_dk = planted_fault(torch, f"dK with the query tile [{t0}, "
                         f"{t0 + FLASH_TILE}) dropped", fault, ref_k, lim)
    del lim, fault
    kept.copy_(p)
    kept[:, :, tile] = 0
    lim = limit(ref_v, torch.einsum("bhqk,bqhd->bkhd", p.abs(), dof.abs()))
    fault = torch.einsum("bhqk,bqhd->bkhd", kept, dof).to(v.dtype)
    x_dv = planted_fault(torch, f"dV with the query tile [{t0}, "
                         f"{t0 + FLASH_TILE}) dropped", fault, ref_v, lim)
    x_dkv = min(x_dk, x_dv)
    check(x_dq >= 10.0 and x_dkv >= 10.0,
          f"K2/K3's limits read a dropped tile at only {x_dq:.2f}x / "
          f"{x_dkv:.2f}x, not >= 10x")
    return x_dq, x_dkv


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
    errs["flash_attention_fwd_fault_x"] = check_flash_fwd_faults(
        torch, fa, q, k, v)
    (errs["flash_attention_bwd_dq_fault_x"],
     errs["flash_attention_bwd_dkv_fault_x"]) = check_flash_bwd_faults(
        torch, fa, q, k, v, do)
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
    # the same tails on the tensor-core path, in bf16, and the lengths
    # around the bf16 kernels' tiles (128 owned rows; walked tiles of 64
    # rows in the backward, of 128 keys in the forward): 1, 63-65, 127-129,
    # 257
    for S in (1, 63, 64, 65, 127, 128, 129, 100, 257):
        for causal in (True, False):
            for hd in (64, 128):
                q, k, v, do = flash_inputs(torch, gen, 2, S, 8, 2, hd,
                                           torch.bfloat16)
                check_flash(torch, fa, f"bf16 S={S} causal={causal} hd={hd} "
                            f"G=4", q, k, v, do, causal, FLASH_BF16_TERMS,
                            BF16_RTOL, BF16_ATOL)
    # head dims off 64/128: q, k, v, dO zero-padded to 64 or 128 by the
    # wrappers, the scale from the true hd, O/dQ/dK/dV sliced back
    for hd in PADDED_HDS:
        for S in (100, 257):
            for causal in (True, False):
                for dtype, tag, terms, rtol, atol in (
                        (torch.bfloat16, "bf16", FLASH_BF16_TERMS, BF16_RTOL,
                         BF16_ATOL),
                        (torch.float32, "f32", F32_TERMS, F32_RTOL, 1e-5)):
                    q, k, v, do = flash_inputs(torch, gen, 2, S, 8, 2, hd,
                                               dtype)
                    check_flash(torch, fa, f"{tag} padded S={S} causal="
                                f"{causal} hd={hd} G=4", q, k, v, do, causal,
                                terms, rtol, atol)
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
    # D and F off multiples of 8 (zero-padded by the wrapper, the mean over
    # the true D) and an operand off 16-byte alignment (copied)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        for Do, Fo, off in ((4093, 1003, 0), (61, 45, 0), (4096, 1000, 1)):
            buf = torch.randn(100 * Do + 8, generator=gen,
                              device=DEVICE).to(dtype)
            x = buf[off:off + 100 * Do].view(100, Do)
            scale = (1 + 0.1 * torch.randn(Do, generator=gen, device=DEVICE)
                     ).to(dtype)
            w = (torch.randn(Do, Fo, generator=gen, device=DEVICE)
                 / math.sqrt(Do)).to(dtype)
            check_rmsnorm_matmul(torch, fcm, f"{tag} M=100 D={Do} F={Fo} "
                                 f"x offset {off}", x, scale, w, 1e-5)
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


def train_engine(torch, opt_type, layers=TRAIN_LAYERS, seed=SEED, zero=None,
                 client=None):
    """``initialize`` on llama3-8B widths cut to ``layers`` with remat,
    random float32 masters from a seeded generator, bench.py's ds_config
    with ``opt_type`` (or the client optimizer factory ``client``) and the
    ``zero_optimization`` block ``zero`` (stage 0 by default). →
    (cfg, model, engine)."""
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
        "zero_optimization": zero or {"stage": 0},
        "bf16": {"enabled": True},
    }
    if client is not None:
        del ds_config["optimizer"]
    engine, _, _, _ = deepspeed_tpu_torch.initialize(
        model=model, config=ds_config, device=DEVICE, optimizer=client)
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
    ("K1 flash forward", ("flash_fwd_wgmma_kernel",)),
    ("K2 flash dQ", ("flash_bwd_dq_wgmma_kernel",)),
    ("K3 flash dK/dV", ("flash_bwd_dkv_wgmma_kernel",)),
    ("K6/K7 paged attention", ("ragged_paged", "decode_split_kernel",
                               "decode_merge_kernel")),
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
    return device_breakdown(
        prof, wall, f"profiled step (timed median {1e3 * step_s:.1f} ms)",
        f"the update (unscale, clip, {opt_type}) {update_ms:.1f} ms of it",
        update_ms=update_ms)


def device_breakdown(prof, wall, what, note="", **extra):
    """A profile's device time by kernel, grouped (``_KERNEL_GROUPS``),
    and the device's busy share of ``wall`` seconds (the union of the
    device events' intervals; its idle share is the rest). CUPTI's
    "Command Buffer Full" records are host-side stalls of a full launch
    queue, not device work, and are counted apart. Logged; → numbers."""
    from torch.autograd import DeviceType

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
    log(f"{what}: wall {1e3 * wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (1e3 * wall):.1f}% of wall, idle "
        f"{100 - 100 * busy / (1e3 * wall):.1f}%); {len(spans)} device "
        f"events, {stalls} launch-queue-full stalls" +
        (f"; {note}" if note else ""))
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {group}: {ms:.2f} ms ({100 * ms / max(total, 1e-9):.1f}% "
            f"of device time)")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (ms, n) in top:
        log(f"  {ms:8.2f} ms  x{n:<4d} {name[:110]}")
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy, **extra,
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
        if f"{name}_fault_x" in errs:
            kernels[-1]["planted_fault_x_limit"] = errs[f"{name}_fault_x"]
        log(f"time {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}, "
            f"plain {plain_ms:.3f} ms, library {lib:.4f} ms)")
        torch.cuda.empty_cache()
    # the port's whole backward (delta, K2 and K3) beside SDPA's
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = fa._FlashAttention.apply(qg, kg, vg, True, scale)
    whole = cuda_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), do, retain_graph=True), 10)
    log(f"time the port's whole attention backward (delta, K2, K3 through "
        f"_FlashAttention.backward): {whole:.4f} ms; SDPA's backward "
        f"{lib_bwd:.4f} ms ({whole / lib_bwd:.2f}x)")
    del out, qg, kg, vg
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


# --------------------------------------------------------------------- #
# ZeRO on one device, optimizer offload, offload_states, Muon, a client
# optimizer
# --------------------------------------------------------------------- #
ZERO_LAYERS = 4                    # the variants' depth (1.922 B params)
ZERO_BIG_LAYERS = 16               # 4.54 B params: 81.7 GB resident
ZERO_WARMUP, ZERO_TIMED = 2, 5
ZERO_BIG_WARMUP, ZERO_BIG_TIMED = 1, 3
ZERO_VARIANTS = (
    ("stage0", {"stage": 0}),
    ("stage2", {"stage": 2}),
    ("cpu", {"stage": 2, "offload_optimizer": {"device": "cpu"}}),
    ("twin0.5", {"stage": 2, "offload_optimizer": {"device": "cpu",
                                                   "ratio": 0.5}}),
    ("cpu_pipeline", {"stage": 2, "offload_optimizer": {
        "device": "cpu", "pipeline_read": True}}),
)
ZERO_FAULT_LEAF = "layers.down_proj.kernel"  # its moments skip write-back
ZERO_HOST_MARGIN = 16e9            # host bytes the process needs besides
MUON_STEPS = 3
#: one card step of Muon on TransformerConfig.tiny() against the CPU's, in
#: float32: the loss within 1e-5 relative; the masters within a twentieth
#: of one step (0.05 lr), since the two devices' matmuls sum in other
#: orders and the Newton-Schulz iteration and Adam's 1/(sqrt(v) + 1e-8)
#: amplify that (tests/test_torch_muon.py holds the same bound)
MUON_TINY_LR = 3e-3
MUON_TINY_STEP_FRACTION = 0.05
CLIENT_STEPS = 3


def _host_masters(torch, engine):
    return {n: p.detach().to("cpu", copy=True)
            for n, p in engine.params.items()}


def _masters_diff(torch, engine, ref):
    """Names whose masters differ from ``ref`` and the largest |diff|."""
    names, worst = [], 0.0
    for n, p in engine.params.items():
        got = p.detach().cpu()
        if not torch.equal(got, ref[n]):
            names.append(n)
            worst = max(worst, float((got - ref[n]).abs().max()))
    return names, worst


def _skip_write_back(engine, leaf_name):
    """Plant a fault: the streamed update never writes ``leaf_name``'s
    updated moments back to host memory."""
    off = engine._offload
    ptrs = {t.untyped_storage().data_ptr()
            for t in off.leaves[leaf_name].host}
    write_back = off._write_back

    def skipping(stream, host, dev):
        if host.untyped_storage().data_ptr() in ptrs:
            return off._event(stream)
        return write_back(stream, host, dev)

    off._write_back = skipping


def _zero_run(torch, name, zero, layers=ZERO_LAYERS, warmup=ZERO_WARMUP,
              timed=ZERO_TIMED, fault_leaf=None, opt_type="FusedAdam"):
    """``warmup`` untimed and ``timed`` timed ``train_batch`` steps of one
    ZeRO configuration, the launch counters set to 0 before the timed
    steps and read after them. → (engine, result)."""
    host_before = _mem_available_bytes()
    t0 = time.perf_counter()
    cfg, model, engine = train_engine(torch, opt_type, layers, zero=zero)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host_taken = host_before - _mem_available_bytes()
    if fault_leaf is not None:
        _skip_write_back(engine, fault_leaf)
    batch = train_batch_tokens(torch, engine, cfg.vocab_size)
    losses = [float(engine.train_batch(batch)) for _ in range(warmup)]
    torch.cuda.synchronize()
    counters = _train_counters(opt_type)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    times, copies = [], []
    for _ in range(timed):
        t0 = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if engine._offload is not None:
            copies.append(dict(engine._offload.step_stats()))
    launches = {n: fn.launches for n, fn in counters.items()}
    for n, c in launches.items():
        check(c > 0, f"{name}: the training path never launched {n}")
    check(all(math.isfinite(x) for x in losses), f"{name}: non-finite loss")
    srt = sorted(times)
    res = {"zero": zero, "layers": layers, "params": model.num_params(),
           "init_s": init_s, "losses": losses,
           "step_s": {"median": srt[len(srt) // 2], "min": srt[0],
                      "max": srt[-1]},
           "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "pinned_host_gb": (engine._offload.pinned_bytes() / 1e9
                              if engine._offload is not None else 0.0),
           "host_mem_available_drop_at_init_gb": host_taken / 1e9,
           "launches_per_step": {n: c / timed for n, c in launches.items()}}
    if copies:
        per = {}
        for key in ("h2d", "d2h"):
            nbytes = copies[-1][f"{key}_bytes"]
            ms = sorted(c[f"{key}_ms"] for c in copies)
            med = ms[len(ms) // 2]
            per[key] = {"bytes": nbytes, "ms_median": med,
                        "gb_per_s": nbytes / med / 1e6}
        res["copies_per_step"] = per
        res["ring"] = {"buffers": engine._offload.buffer_count,
                       "pieces": len(engine._offload.pieces)}
    if engine._offload_prefetcher is not None:
        res["prefetch"] = engine._offload_prefetcher.stats()
    cp = res.get("copies_per_step")
    log(f"zero {name}: {layers} layers, median step "
        f"{1e3 * res['step_s']['median']:.1f} ms [{1e3 * srt[0]:.1f}, "
        f"{1e3 * srt[-1]:.1f}], peak {res['max_memory_allocated_gb']:.2f} "
        f"GB, pinned {res['pinned_host_gb']:.2f} GB (MemAvailable fell "
        f"{host_taken / 1e9:.2f} GB at init), K5 a step "
        f"{res['launches_per_step'].get('fused_adam')}"
        + (f"; a step H2D {cp['h2d']['bytes'] / 1e9:.2f} GB in "
           f"{cp['h2d']['ms_median']:.1f} ms ({cp['h2d']['gb_per_s']:.1f} "
           f"GB/s), D2H {cp['d2h']['bytes'] / 1e9:.2f} GB in "
           f"{cp['d2h']['ms_median']:.1f} ms ({cp['d2h']['gb_per_s']:.1f} "
           f"GB/s); ring {res['ring']}" if cp else ""))
    del model, batch
    return engine, res


def _mem_available_bytes():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise SmokeFailure("/proc/meminfo has no MemAvailable line")


def _offload_states_legs(torch, engine, batch, want, ref_masters, swap_dir):
    """``offload_states`` after step 3 on cpu (optimizer and masters) and
    nvme (optimizer), each leg's bytes and seconds; steps 4 and 5, then 6
    and 7, bit for bit the uninterrupted run's."""
    legs = {}
    for step, (device, include) in ((3, ("cpu", ("optimizer", "params"))),
                                    (4, ("nvme", ("optimizer",)))):
        nbytes = sum(t.numel() * t.element_size() for what in include
                     for t in engine._device_groups(what)[0].values())
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        engine.offload_states(include=include, device=device,
                              nvme_path=swap_dir)
        torch.cuda.synchronize()
        off_s = time.perf_counter() - t0
        during = torch.cuda.memory_allocated()
        refused = False
        try:
            engine.train_batch(batch)
        except RuntimeError as e:
            refused = "reload_states" in str(e)
        check(refused, f"offload_states({device}): train_batch did not "
                       f"refuse while the state was away")
        t0 = time.perf_counter()
        engine.reload_states()
        on_s = time.perf_counter() - t0
        after = torch.cuda.memory_allocated()
        got = float(engine.train_batch(batch))
        check(got == want[step], f"offload_states({device}): the next "
              f"loss {got!r} != the uninterrupted run's {want[step]!r}")
        legs[device] = {"include": list(include), "bytes": nbytes,
                        "offload_s": off_s, "reload_s": on_s,
                        "offload_gb_per_s": nbytes / off_s / 1e9,
                        "reload_gb_per_s": nbytes / on_s / 1e9,
                        "memory_allocated_gb": {
                            "before": before / 1e9, "during": during / 1e9,
                            "after": after / 1e9},
                        "next_loss": got}
        log(f"offload_states {device} {include}: {nbytes / 1e9:.2f} GB out "
            f"in {off_s:.2f} s, back in {on_s:.2f} s; memory_allocated "
            f"{before / 1e9:.2f} -> {during / 1e9:.2f} -> {after / 1e9:.2f} "
            f"GB; the next loss {got!r} (uninterrupted {want[step]!r})")
    got = [float(engine.train_batch(batch)) for _ in range(2)]
    check(got == want[-2:], f"offload_states: steps 6-7 {got} != "
          f"{want[-2:]}")
    names, worst = _masters_diff(torch, engine, ref_masters)
    check(not names, f"offload_states: masters differ after 7 steps "
          f"({names[:3]}, max |diff| {worst})")
    return legs


def _muon_checks(torch):
    """Muon at ZERO_LAYERS (the loss falls over MUON_STEPS; the
    Newton-Schulz seconds a step), and one step on TransformerConfig.tiny
    on the card against the CPU's."""
    from deepspeed_tpu_torch.runtime import optimizer as opt_mod

    ns = opt_mod.orthogonalize_via_newton_schulz
    ns_ms = []

    def timed_ns(x, *a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = ns(x, *a, **kw)
        end.record()
        ns_ms.append((tuple(x.shape), start, end))
        return out

    opt_mod.orthogonalize_via_newton_schulz = timed_ns
    try:
        t0 = time.perf_counter()
        cfg, model, engine = train_engine(torch, "Muon", ZERO_LAYERS)
        batch = train_batch_tokens(torch, engine, cfg.vocab_size)
        matrices = sorted({n for n in engine.params
                           if engine.params[n].ndim == 2})
        losses, times = [], []
        for _ in range(MUON_STEPS):
            t0 = time.perf_counter()
            losses.append(float(engine.train_batch(batch)))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        opt_mod.orthogonalize_via_newton_schulz = ns
    ns_total = sum(s.elapsed_time(e) for _, s, e in ns_ms) / MUON_STEPS
    shapes = sorted({str(list(sh)) for sh, _, _ in ns_ms})
    log(f"Muon: {ZERO_LAYERS} layers, losses {losses}, steps "
        f"{[round(t, 3) for t in times]} s; Newton-Schulz over "
        f"{len(matrices)} 2-D leaves {matrices} (shapes {shapes}): "
        f"{ns_total:.1f} ms a step (CUDA events, float32, TF32 off)")
    check(all(math.isfinite(x) for x in losses), "Muon: non-finite loss")
    check(losses[-1] < losses[0], f"Muon: the loss did not fall: {losses}")
    del engine, model, batch
    _free(torch)
    return {"layers": ZERO_LAYERS, "losses": losses, "step_s": times,
            "newton_schulz_ms_per_step": ns_total, "matrices": matrices,
            "ns_calls_per_step": len(ns_ms) / MUON_STEPS,
            "tiny_vs_cpu": _muon_tiny_vs_cpu(torch)}


def _muon_tiny_vs_cpu(torch):
    import numpy as np

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import CausalLM, TransformerConfig
    from deepspeed_tpu_torch.models.transformer import init_params

    cfg = TransformerConfig.tiny()
    cpu_params = init_params(cfg, torch.Generator().manual_seed(SEED),
                             device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=(2, 128)))
    config = {"train_batch_size": 2, "gradient_clipping": 1.0,
              "optimizer": {"type": "Muon", "params": {"lr": MUON_TINY_LR}}}
    out = {}
    for device in ("cpu", DEVICE):
        params = {n: t.clone().to(device) for n, t in cpu_params.items()}
        engine, _, _, _ = deepspeed_tpu_torch.initialize(
            model=CausalLM(cfg, params, trainable=True), config=config,
            device=device)
        loss = float(engine.train_batch({"input_ids": tokens.to(device)}))
        out[device] = (loss, {n: p.detach().cpu()
                              for n, p in engine.params.items()})
    (l_cpu, p_cpu), (l_card, p_card) = out["cpu"], out[DEVICE]
    worst = max(float((p_card[n] - p_cpu[n]).abs().max()) for n in p_cpu)
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    limit = MUON_TINY_STEP_FRACTION * MUON_TINY_LR
    log(f"Muon tiny, one step: loss {l_card!r} (card) vs {l_cpu!r} (CPU), "
        f"rel {rel:.3e} (tol 1e-5); masters max |diff| {worst:.3e} (tol "
        f"{limit:.1e}, {MUON_TINY_STEP_FRACTION} of a step at lr "
        f"{MUON_TINY_LR})")
    check(rel <= 1e-5, f"Muon tiny: losses differ by {rel}")
    check(worst <= limit, f"Muon tiny: masters differ by {worst}")
    return {"loss_card": l_card, "loss_cpu": l_cpu, "loss_rel": rel,
            "masters_max_abs": worst, "limit": limit}


def _client_checks(torch, root):
    """``torch.optim.AdamW(foreach=False)`` through ``initialize(
    optimizer=...)`` at CKPT_LAYERS: CLIENT_STEPS steps (the loss falls),
    save, 2 more; a fresh engine loads the tag and its 2 steps are bit
    for bit the uninterrupted ones."""
    import shutil

    def factory(params):
        return torch.optim.AdamW(params, lr=3e-4, weight_decay=0.1,
                                 foreach=False)

    shutil.rmtree(root, ignore_errors=True)
    try:
        cfg, model, engine = train_engine(torch, None, CKPT_LAYERS,
                                          client=factory)
        check(type(engine.optimizer.optimizer).__name__ == "AdamW",
              "the client factory's optimizer is not the engine's")
        batch = train_batch_tokens(torch, engine, cfg.vocab_size)
        losses = [float(engine.train_batch(batch))
                  for _ in range(CLIENT_STEPS)]
        check(all(math.isfinite(x) for x in losses) and
              losses[-1] < losses[0], f"client AdamW: losses {losses}")
        t0 = time.perf_counter()
        engine.save_checkpoint(root)
        save_s = time.perf_counter() - t0
        straight = [float(engine.train_batch(batch)) for _ in range(2)]
        del engine, model
        _free(torch)
        cfg, model, engine = train_engine(torch, None, CKPT_LAYERS,
                                          seed=SEED + 7, client=factory)
        t0 = time.perf_counter()
        engine.load_checkpoint(root)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        resumed = [float(engine.train_batch(batch)) for _ in range(2)]
        log(f"client AdamW(foreach=False): {CKPT_LAYERS} layer(s), losses "
            f"{losses}; save {save_s:.2f} s, load {load_s:.2f} s; then "
            f"{straight} (uninterrupted) vs {resumed} (resumed)")
        check(resumed == straight, f"client AdamW: resumed {resumed} != "
              f"uninterrupted {straight}")
        del engine, model, batch
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free(torch)
    return {"layers": CKPT_LAYERS, "losses": losses, "save_s": save_s,
            "load_s": load_s, "losses_uninterrupted": straight,
            "losses_resumed": resumed}


PINNED_PROBE_BYTES = 1 << 31      # the host buffer of each pinned kind


def _pinned_kinds(torch):
    """Ways to get page-locked host memory: → {kind: maker}; a maker
    returns (a float32 host tensor of PINNED_PROBE_BYTES, its release)."""
    import ctypes

    from deepspeed_tpu_torch.runtime.swap_tensor import pinned

    n = PINNED_PROBE_BYTES // 4

    def caching():
        return torch.empty(n, pin_memory=True), lambda: None

    def registered():
        t = torch.empty(n, dtype=torch.float32)
        lib = pinned._cudart()
        err = lib.cudaHostRegister(ctypes.c_void_p(t.data_ptr()),
                                   ctypes.c_size_t(PINNED_PROBE_BYTES), 0)
        if err != 0:
            raise OSError(f"cudaHostRegister failed with CUDA error {err}")
        return t, lambda: lib.cudaHostUnregister(ctypes.c_void_p(
            t.data_ptr()))

    def exact():
        return pinned.pinned_empty((n,)), lambda: None

    return {"caching allocator (torch.empty pin_memory=True)": caching,
            "cudaHostRegister in place": registered,
            "cudaHostAlloc, exact size (pinned.pinned_empty)": exact}


def _pinned_copy_rates(torch):
    """Host-to-device and device-to-host GB/s of a PINNED_PROBE_BYTES
    buffer of each pinned kind (median of 3 on a side stream, CUDA
    events), one direction at a time and both at once (two streams, two
    halves), and the seconds to make the buffer."""
    n = PINNED_PROBE_BYTES // 4
    dev = torch.empty(n, dtype=torch.float32, device=DEVICE)
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    out = {}
    for kind, make in _pinned_kinds(torch).items():
        t0 = time.perf_counter()
        try:
            host, release = make()
        except (OSError, AttributeError) as e:
            out[kind] = f"not measured: {e}"
            continue
        host.fill_(1.0)
        alloc_s = time.perf_counter() - t0
        res = {"make_s": alloc_s}
        for direction in ("h2d", "d2h"):
            ms = []
            for _ in range(3):
                a, b = (torch.cuda.Event(enable_timing=True) for _ in "ab")
                with torch.cuda.stream(streams[0]):
                    a.record()
                    if direction == "h2d":
                        dev.copy_(host, non_blocking=True)
                    else:
                        host.copy_(dev, non_blocking=True)
                    b.record()
                b.synchronize()
                ms.append(a.elapsed_time(b))
            res[f"{direction}_gb_per_s"] = PINNED_PROBE_BYTES / sorted(
                ms)[1] / 1e6
        half = n // 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.cuda.stream(streams[0]):
            dev[:half].copy_(host[:half], non_blocking=True)
        with torch.cuda.stream(streams[1]):
            host[half:].copy_(dev[half:], non_blocking=True)
        torch.cuda.synchronize()
        res["both_ways_gb_per_s"] = PINNED_PROBE_BYTES / (
            time.perf_counter() - t0) / 1e9
        out[kind] = res
        log(f"pinned {kind}: made in {alloc_s:.2f} s; H2D "
            f"{res['h2d_gb_per_s']:.1f} GB/s, D2H {res['d2h_gb_per_s']:.1f} "
            f"GB/s, both ways at once {res['both_ways_gb_per_s']:.1f} GB/s "
            f"({PINNED_PROBE_BYTES / 2 ** 30:.0f} GiB)")
        release()
        del host
    del dev
    _free(torch)
    return out


def phase_zero_offload(torch):
    """ZeRO at one device on the training path at llama3-8B widths (bf16,
    remat, 4 x 2048 tokens, FusedAdam): the five ZERO_VARIANTS at
    ZERO_LAYERS, each bit for bit with stage 0 (losses and masters); a
    planted fault (one leaf's moments never written back) caught; an
    injected prefetch failure (same losses); offload_states/reload_states
    on cpu and nvme continuing bit for bit; ZERO_BIG_LAYERS layers with
    the state on the host (81.7 GB resident); Muon; a client optimizer.
    → the phase's record."""
    from deepspeed_tpu_torch.runtime.fault import injection

    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "deepspeed_tpu_torch", "build")
    out = {"variants": {}}
    _free(torch)
    out["pinned_copy_rates"] = _pinned_copy_rates(torch)
    ref_masters = want = None
    for name, zero in ZERO_VARIANTS:
        engine, res = _zero_run(torch, name, zero)
        if name == "stage0":
            ref_masters, want = _host_masters(torch, engine), res["losses"]
        else:
            names, worst = _masters_diff(torch, engine, ref_masters)
            check(res["losses"] == want, f"zero {name}: losses "
                  f"{res['losses']} != stage 0's {want}")
            check(not names, f"zero {name}: masters differ from stage 0's "
                  f"({names[:3]}, max |diff| {worst})")
            res["bitwise_vs_stage0"] = True
        out["variants"][name] = res
        del engine
        _free(torch)

    # planted fault: one leaf's moments never go home
    engine, res = _zero_run(torch, "cpu + planted fault", ZERO_VARIANTS[2][1],
                            fault_leaf=ZERO_FAULT_LEAF)
    names, worst = _masters_diff(torch, engine, ref_masters)
    loss_gap = max(abs(a - b) for a, b in zip(res["losses"], want))
    log(f"planted fault ({ZERO_FAULT_LEAF}'s moments not written back): "
        f"{len(names)} masters differ, max |diff| {worst:.3e}; losses "
        f"{res['losses']} vs {want}, max |diff| {loss_gap:.3e}")
    check(ZERO_FAULT_LEAF in names and worst > 0, "the planted write-back "
          "fault was not caught by the bit check")
    out["planted_fault"] = {"leaf": ZERO_FAULT_LEAF, "masters_differ": names,
                            "max_abs": worst, "loss_max_abs": loss_gap}
    del engine
    _free(torch)

    # an injected prefetch failure: the same bits, one failure counted
    os.environ[injection.ENV_VAR] = \
        "site=offload_prefetch,kind=offload,times=1"
    injection.clear()
    try:
        engine, res = _zero_run(torch, "cpu_pipeline + injected failure",
                                ZERO_VARIANTS[4][1], warmup=1, timed=2)
    finally:
        del os.environ[injection.ENV_VAR]
        injection.clear()
    stats = res["prefetch"]
    log(f"injected offload_prefetch failure: {stats}; losses "
        f"{res['losses']} vs {want[:3]}")
    check(stats["failures"] == 1 and stats["arms"] == 2,
          f"prefetcher counters {stats}")
    check(res["losses"] == want[:3], "an injected prefetch failure changed "
          "the losses")
    out["injected_prefetch_failure"] = {"prefetch": stats,
                                        "losses": res["losses"]}
    del engine
    _free(torch)

    # offload_states / reload_states after step 3 of the stage-0 run
    engine, res = _zero_run(torch, "stage0 for offload_states", {"stage": 0},
                            warmup=1, timed=2)
    check(res["losses"] == want[:3], "stage 0 rerun differs")
    batch = train_batch_tokens(torch, engine, engine.module.config.vocab_size)
    swap_dir = os.path.join(build, "swap_smoke")
    os.makedirs(swap_dir, exist_ok=True)
    try:
        out["offload_states"] = _offload_states_legs(
            torch, engine, batch, want, ref_masters, swap_dir)
    finally:
        import shutil

        shutil.rmtree(swap_dir, ignore_errors=True)
    del engine, batch, ref_masters
    _free(torch)

    # 16 layers: the resident state would not fit the card
    from deepspeed_tpu_torch import TransformerConfig
    from deepspeed_tpu_torch.models.transformer import param_shapes

    cfg = dataclasses.replace(TransformerConfig.llama3_8b(),
                              num_layers=ZERO_BIG_LAYERS)
    n_big = sum(math.prod(s) for s in param_shapes(cfg).values())
    pinned = 2 * 4 * n_big
    avail = _mem_available_bytes()
    log(f"zero big: {ZERO_BIG_LAYERS} layers, {n_big / 1e9:.3f} B params: "
        f"resident state {18 * n_big / 1e9:.1f} GB (18 bytes a param), "
        f"{pinned / 1e9:.1f} GB pinned on the host; MemAvailable "
        f"{avail / 1e9:.1f} GB")
    check(avail >= pinned + ZERO_HOST_MARGIN, f"the host cannot hold the "
          f"{ZERO_BIG_LAYERS}-layer run's pinned state: MemAvailable "
          f"{avail / 1e9:.1f} GB < {pinned / 1e9:.1f} GB + "
          f"{ZERO_HOST_MARGIN / 1e9:.0f} GB")
    engine, res = _zero_run(torch, f"cpu_pipeline {ZERO_BIG_LAYERS} layers",
                            ZERO_VARIANTS[4][1], layers=ZERO_BIG_LAYERS,
                            warmup=ZERO_BIG_WARMUP, timed=ZERO_BIG_TIMED)
    timed = res["losses"][ZERO_BIG_WARMUP:]
    check(timed[-1] < timed[0], f"zero big: the loss did not fall: {timed}")
    res["resident_state_gb"] = 18 * n_big / 1e9
    res["mem_available_gb"] = avail / 1e9
    out["big"] = res
    del engine
    _free(torch)

    out["muon"] = _muon_checks(torch)
    out["client_optimizer"] = _client_checks(
        torch, os.path.join(build, "client_ckpt_smoke"))
    return out


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
    body), and K16, K18 and K19 must give the same bits in two calls.
    → max abs error by kernel name."""
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
    o3, lse3 = bs.block_sparse_fwd(q, k, v, tables, scale)
    check(torch.equal(o3, o) and torch.equal(lse3, lse),
          f"block_sparse_fwd {tag}: two calls differ")
    del o3, lse3
    errs["block_sparse_fwd_nolse"] = float((o2.float() - o_ref.float())
                                           .abs().max())
    dq_ref = bs.block_sparse_bwd_dq_reference(q, k, v, do, lse_ref, delta,
                                              tables, scale)
    dq = bs.block_sparse_bwd_dq(q, k, v, do, lse_ref, delta, tables, scale)
    errs["block_sparse_bwd_dq"] = _compare_limit(
        torch, f"block_sparse_bwd_dq {tag}", dq, dq_ref, lim(dq_ref, dsk),
        why + "|dS|@|K|")
    check(torch.equal(dq, bs.block_sparse_bwd_dq(q, k, v, do, lse_ref, delta,
                                                 tables, scale)),
          f"block_sparse_bwd_dq {tag}: two calls differ")
    dk_ref, dv_ref = bs.block_sparse_bwd_dkv_reference(
        q, k, v, do, lse_ref, delta, tables, scale)
    dk, dv = bs.block_sparse_bwd_dkv(q, k, v, do, lse_ref, delta, tables,
                                     scale)
    err_k = _compare_limit(torch, f"block_sparse_bwd_dkv dK {tag}", dk,
                           dk_ref, lim(dk_ref, dsq), why + "|dS|^T@|Q|")
    err_v = _compare_limit(torch, f"block_sparse_bwd_dkv dV {tag}", dv,
                           dv_ref, lim(dv_ref, pdo), why + "|P|^T@|dO|")
    errs["block_sparse_bwd_dkv"] = max(err_k, err_v)
    dk2, dv2 = bs.block_sparse_bwd_dkv(q, k, v, do, lse_ref, delta, tables,
                                       scale)
    check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
          f"block_sparse_bwd_dkv {tag}: two calls differ")
    return errs, (o, lse_ref)


def _dropped_entry(bs, tables, transposed):
    """A copy of ``tables`` with the last entry left out of the shortest
    list of two or more: of the layout's rows (K16-K18 walk them) or of
    the transposed layout's (K19). → (tables, what was left out)."""
    import numpy as np

    layout = tables.layout.copy()
    lengths = layout.sum(axis=1 if transposed else 2)   # [LH, n] lengths
    lengths = np.where(lengths >= 2, lengths, layout.shape[1] + 1)
    lh, r = np.unravel_index(int(lengths.argmin()), lengths.shape)
    if transposed:
        c = int(np.nonzero(layout[lh, :, r])[0][-1])
        layout[lh, c, r] = False
        what = f"q-block {c} left out of k-block {r}'s list"
    else:
        c = int(np.nonzero(layout[lh, r])[0][-1])
        layout[lh, r, c] = False
        what = f"k-block {c} left out of q-block {r}'s list"
    return bs.BlockSparseTables(layout, tables.block, tables.device), what


def check_bs_faults(torch, bs, tag, q, k, v, do, tables):
    """K16, K18 and K19 against planted faults from the plain math, read
    against the limits ``check_sparse`` holds them to: O (K16) and dQ
    (K18) with one k-block left out of the shortest layout list of two or
    more, dK and dV (K19) with one q-block left out of the shortest
    transposed-layout list of two or more (a CTA that skipped a list
    entry, the kernels' walks). Each must read at least 10x its limit.
    (Out of a list of 125, the longest of the Fixed layout, one entry
    moves dK by ~1/125 and read 3.8-5.5x.) → {kernel: the fault's reading
    (x the limit)}."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = bs.block_sparse_fwd_reference(q, k, v, tables, scale)
    delta = (do.float() * o.float()).sum(-1)
    pv, dsk, dsq, pdo = sparse_terms(torch, bs, q, k, v, do, lse, delta,
                                     tables, scale)

    def lim(ref, t):
        return BF16_ATOL + BF16_RTOL * ref.float().abs() + FLASH_BF16_TERMS * t

    rows, what = _dropped_entry(bs, tables, transposed=False)
    fault = bs.block_sparse_fwd_reference(q, k, v, rows, scale)[0]
    x_o = planted_fault(torch, f"O {tag} with {what}", fault, o, lim(o, pv))
    del fault, pv
    ref = bs.block_sparse_bwd_dq_reference(q, k, v, do, lse, delta, tables,
                                           scale)
    fault = bs.block_sparse_bwd_dq_reference(q, k, v, do, lse, delta, rows,
                                             scale)
    x_dq = planted_fault(torch, f"dQ {tag} with {what}", fault, ref,
                         lim(ref, dsk))
    del o, ref, fault, dsk
    cols, what = _dropped_entry(bs, tables, transposed=True)
    ref_k, ref_v = bs.block_sparse_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                     tables, scale)
    f_k, f_v = bs.block_sparse_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                 cols, scale)
    x_k = planted_fault(torch, f"dK {tag} with {what}", f_k, ref_k,
                        lim(ref_k, dsq))
    x_v = planted_fault(torch, f"dV {tag} with {what}", f_v, ref_v,
                        lim(ref_v, pdo))
    out = {"block_sparse_fwd": x_o, "block_sparse_bwd_dq": x_dq,
           "block_sparse_bwd_dkv": min(x_k, x_v)}
    for name, x in out.items():
        check(x >= 10.0, f"{name}'s limits read a dropped list entry at "
                         f"only {x:.2f}x, not >= 10x")
    return out


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
    # head dims off 64/128, zero-padded by the wrappers
    for i, (dtype, hd) in enumerate(itertools.product(
            (torch.float32, torch.bfloat16), PADDED_HDS)):
        name, kw = SPARSE_EDGE_LAYOUTS[i % len(SPARSE_EDGE_LAYOUTS)]
        blk, H = 64, 4
        S = 8 * blk - 5
        layout = getattr(sc, name)(num_heads=H, block=blk,
                                   **kw).make_layout(8 * blk)
        tables = bs.prepare_layout(layout, blk, H, DEVICE)
        q, k, v, do = sparse_inputs(torch, gen, 2, H, S, hd, dtype)
        f32 = dtype == torch.float32
        check_sparse(torch, bs, f"{'f32' if f32 else 'bf16'} padded "
                     f"{name[:-14]} block={blk} hd={hd} S={S}", q, k, v, do,
                     tables, SPARSE_F32_TERMS if f32 else FLASH_BF16_TERMS,
                     F32_RTOL if f32 else BF16_RTOL,
                     1e-5 if f32 else BF16_ATOL)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# head dims in (128, 256]: zero-padded to 256 by the wrappers, run by the
# exact tile kernels (K1-K3, K16-K19) in both types
WIDE_HDS = (160, 256)
# timing shapes at hd 256 (bf16): K1-K3 causal, K16-K19 on the Fixed layout
WIDE_FLASH = dict(B=1, S=4096, H=16, hd=256)
WIDE_SPARSE = dict(B=1, H=16, S=8192, hd=256, block=64)


def phase_wide_head_checks(torch):
    """K1-K3 and K16-K19 at hd 160 and 256 (the exact tile kernels; 160
    zero-padded to 256) against their plain versions in bf16 and float32:
    flash attention at S 100 and 257, causal and full, G 2; block-sparse
    attention at blocks 16, 64 and 128, each layout class in turn, per-head
    layouts, an emptied q-block row (O = 0, LSE = -1e30 exactly) and S off
    the block grid. Then each kernel timed at hd 256 in bf16 beside its
    bound (timing only; speed at hd 256 is later work). → the timings."""
    import itertools

    from deepspeed_tpu_torch.ops.sparse_attention import \
        block_sparse_kernel as bs
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa

    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    kinds = ((torch.bfloat16, "bf16", FLASH_BF16_TERMS, BF16_RTOL, BF16_ATOL),
             (torch.float32, "f32", F32_TERMS, F32_RTOL, 1e-5))
    for hd, (dtype, tag, terms, rtol, atol), S, causal in itertools.product(
            WIDE_HDS, kinds, (100, 257), (True, False)):
        q, k, v, do = flash_inputs(torch, gen, 2, S, 4, 2, hd, dtype)
        check_flash(torch, fa, f"{tag} wide S={S} causal={causal} hd={hd} "
                    f"G=2", q, k, v, do, causal, terms, rtol, atol)
    for i, (hd, dtype, blk) in enumerate(itertools.product(
            WIDE_HDS, (torch.float32, torch.bfloat16), (16, 64, 128))):
        name, kw = SPARSE_EDGE_LAYOUTS[i % len(SPARSE_EDGE_LAYOUTS)]
        per_head, empty = i % 3 == 0, i % 3 == 1
        H = 4
        S = 8 * blk - (5 if i % 2 else 0)
        layout = getattr(sc, name)(num_heads=H, block=blk,
                                   different_layout_per_head=per_head,
                                   **kw).make_layout(8 * blk)
        if empty:
            layout[:, 3] = False
        tables = bs.prepare_layout(layout, blk, H, DEVICE)
        q, k, v, do = sparse_inputs(torch, gen, 2, H, S, hd, dtype)
        f32 = dtype == torch.float32
        stag = (f"{'f32' if f32 else 'bf16'} wide {name[:-14]} block={blk} "
                f"hd={hd} S={S} per_head={per_head} empty_row={empty}")
        check_sparse(torch, bs, stag, q, k, v, do, tables,
                     SPARSE_F32_TERMS if f32 else FLASH_BF16_TERMS,
                     F32_RTOL if f32 else BF16_RTOL,
                     1e-5 if f32 else BF16_ATOL)
        if empty:
            o_k, lse_k = bs.block_sparse_fwd(q, k, v, tables)
            rows = slice(3 * blk, 4 * blk)
            check(bool((o_k[:, :, rows] == 0).all())
                  and bool((lse_k[:, :, rows] == -1e30).all()),
                  f"{stag}: the empty row is not O = 0, LSE = -1e30")
    del q, k, v, do
    torch.cuda.empty_cache()

    out = {}
    m = WIDE_FLASH
    B, S, H, hd = m["B"], m["S"], m["H"], m["hd"]
    q, k, v, do = flash_inputs(torch, gen, B, S, H, H, hd, torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    for name, fn, products, outputs, stats in (
            ("flash_attention_fwd",
             lambda: fa.flash_attention_fwd(q, k, v, True, scale), 2, 1, 0),
            ("flash_attention_bwd_dq",
             lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, True,
                                               scale), 3, 1, 2),
            ("flash_attention_bwd_dkv",
             lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                True, scale), 4, 2, 2)):
        ms = cuda_ms(torch, fn, 5)
        nbytes, flops = flash_work(B, S, H, hd, True, products, outputs,
                                   stats)
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        out[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                     "shape": dict(m, causal=True, dtype="bf16")}
        log(f"time {name} hd {hd} (B {B} S {S} H {H}, causal, exact tile "
            f"kernel): {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by})")
    del q, k, v, do, o, lse, delta
    m = WIDE_SPARSE
    B, H, S, hd = m["B"], m["H"], m["S"], m["hd"]
    q, k, v, do = sparse_inputs(torch, gen, B, H, S, hd, torch.bfloat16)
    cfg = sc.FixedSparsityConfig(num_heads=H, block=m["block"],
                                 num_local_blocks=4, num_global_blocks=1,
                                 attention="unidirectional")
    tables = bs.prepare_layout(cfg.make_layout(S), m["block"], H, DEVICE)
    o, lse = bs.block_sparse_fwd(q, k, v, tables, scale)
    delta = (do.float() * o.float()).sum(-1)
    for name, fn in (
            ("block_sparse_fwd",
             lambda: bs.block_sparse_fwd(q, k, v, tables, scale)),
            ("block_sparse_fwd_nolse",
             lambda: bs.block_sparse_fwd_nolse(q, k, v, tables, scale)),
            ("block_sparse_bwd_dq",
             lambda: bs.block_sparse_bwd_dq(q, k, v, do, lse, delta, tables,
                                            scale)),
            ("block_sparse_bwd_dkv",
             lambda: bs.block_sparse_bwd_dkv(q, k, v, do, lse, delta, tables,
                                             scale))):
        ms = cuda_ms(torch, fn, 5)
        nbytes, flops = sparse_work(name, B, H, S, hd,
                                    tables.active_blocks(H), m["block"])
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS)
        out[name] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by,
                     "shape": dict(m, layout="fixed", dtype="bf16",
                                   density=tables.density())}
        log(f"time {name} hd {hd} (B {B} H {H} S {S}, block {m['block']}, "
            f"fixed, exact tile kernel): {ms:.4f} ms (bound {b_ms:.4f} ms "
            f"by {b_by})")
    del q, k, v, do, o, lse, delta
    _free(torch)
    return out


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
        if name == "fixed":
            results["planted_faults_over_limit"] = check_bs_faults(
                torch, bs, "bf16 main shapes fixed", q, k, v, w, tables)
            torch.cuda.empty_cache()
        results["training"][name] = {"step_s": sorted(times),
                                     "loss": float(loss.detach()),
                                     "launches_timed": train}
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return launches, results, errs


def sparse_work(name, B, H, S, hd, active, blk=SPARSE_MAIN["block"]):
    """(bytes, flops) of one kernel: its [B, H, S, hd] bf16 inputs read once
    and outputs written once, float32 [B, H, S] statistics; 2*hd flops per
    product and (query, key) pair of the ``active`` blocks (over all heads,
    of blk**2 pairs each)."""
    n, stats = B * H * S * hd * 2, B * H * S * 4
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
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config as sc
    from deepspeed_tpu_torch.ops.transformer import flash_attention as fa
    from deepspeed_tpu_torch.utils import kernel_probe

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
        # the parent designs on the same inputs (their C entry points are
        # the tree's: each library swapped in under the wrapper), timing
        # only: K16/K17 before their redesign, and the bwd copy's K18 (as
        # it was before its redesign) and K19 (before its own)
        for name, (kern, _) in specs.items():
            src = SPARSE_SOURCES[name].rsplit("/", 1)[1][:-3]
            parent = kernel_probe.swapped(src, _PARENT_LIBS[src], kern)
            rows[name]["parent_ms"] = cuda_ms(torch, parent, 10)
            log(f"time {name} ({lname}) parent design: "
                f"{rows[name]['parent_ms']:.4f} ms (this tree's "
                f"{rows[name]['ms']:.4f} ms)")
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
    # K19 at the configs' default block, 16, on the exact mma.sync kernel
    # the redesign kept for blocks 16 and 32 (Fixed, unidirectional)
    cfg16 = sc.FixedSparsityConfig(num_heads=H, num_local_blocks=4,
                                   num_global_blocks=1,
                                   attention="unidirectional")
    t16 = bs.prepare_layout(cfg16.make_layout(S), cfg16.block, H, DEVICE)
    o, lse = bs.block_sparse_fwd(q, k, v, t16, scale)
    delta = (do.float() * o.float()).sum(-1)
    ms16 = cuda_ms(torch, lambda: bs.block_sparse_bwd_dkv(
        q, k, v, do, lse, delta, t16, scale), 10)
    flops16 = 8 * hd * t16.active_blocks(H) * cfg16.block ** 2
    b16, by16 = bound_ms(sparse_work("block_sparse_bwd_dkv", B, H, S, hd,
                                     0)[0], flops16, BF16_FLOPS)
    block16 = {"block": cfg16.block, "density": t16.density(), "ms": ms16,
               "bound_ms": b16, "bound_by": by16}
    log(f"time block_sparse_bwd_dkv (fixed, block {cfg16.block}, density "
        f"{100 * t16.density():.2f}%, the kept mma.sync path): {ms16:.4f} ms "
        f"(bound {b16:.4f} ms by {by16})")
    next(r for r in kernels
         if r["name"] == "block_sparse_bwd_dkv")["block16"] = block16
    results["timing"] = {"k1_causal_dense_ms": k1_ms, "by_layout": by_layout,
                         "dkv_block16": block16}
    del q, k, v, do, o, lse, delta
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
    check_ragged(torch, ops, "bf16 page 128", q, pages, kvl, pt, cu, KV)
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


# --------------------------------------------------------------------- #
# prefix reuse and the KV memory tier
# --------------------------------------------------------------------- #
PREFIX_SYSTEM = 1024               # the shared system prompt: 16 pages of 64
PREFIX_SUFFIXES = (100, 64, 80, 120, 150, 200, 256)   # requests 0-6
PREFIX_COW_EXTRA = 60              # request 7: request 0's prompt + 60
PREFIX_LATER = (96, 128, 72, 88)   # the four shared-prompt requests after
PREFIX_UNRELATED = 1280            # the four prompts that fill the pool,
PREFIX_UNRELATED_NEW = 256         # each reserving 256 new tokens (24 pages)
PREFIX_NEW = 32                    # greedy tokens a request
PREFIX_WINDOW = 8                  # fused decode window
PREFIX_ENGINE = dict(max_seqs=8, num_blocks=96)
PREFIX_HOST_MB = 512


def bf16_ulps(torch, a, b):
    """Largest |a - b| in units of b's bf16 ulp (2**(e-8) for |b| in
    [2**(e-1), 2**e)). Bit-identical pages read 0; a value one bf16 word
    away reads 1, so half an ulp is the identity check's limit."""
    a32, b32 = a.float(), b.float()
    _, e = torch.frexp(b32)
    ulp = torch.ldexp(torch.ones_like(b32), (e - 8).clamp(min=-133))
    return float(((a32 - b32).abs() / ulp).max())


def rel_l2(torch, a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def prefix_admit(eng, uid, prompt, new):
    """Admission in the lifecycle scheduler's order: graft the cached
    prefix (into a fresh sequence), then reserve the request's whole
    lifetime. → tokens grafted."""
    sm = eng.state_manager
    seq = sm.get_sequence(uid)
    matched = 0 if seq is not None else eng.graft_prefix(uid, prompt)
    seq = sm.get_or_create_sequence(uid)
    need = min(len(prompt) + new, eng.config.max_ctx)
    check(sm.maybe_allocate_kv(seq, need - seq.seen_tokens),
          f"prefix serving: uid {uid} does not fit the pool ({need} tokens)")
    return matched


def prefix_puts(eng, uid, prompt, start, align=0):
    """``put`` prompt[start:] in token-budget chunks (K6 over the grafted
    pages), the chunks restarting at ``align``: a cold twin of a request
    that grafted ``align`` tokens puts its prompt in the chunks that the
    grafted pages and the remainder were put in. → the last logits row."""
    budget = eng.config.max_tokens
    cuts = sorted({start, max(start, align), len(prompt)})
    for lo, hi in zip(cuts, cuts[1:]):
        for i in range(lo, hi, budget):
            logits = eng.put([uid], [prompt[i:min(i + budget, hi)]])
    return logits[0]


def prefix_prefill(eng, uid, prompt, start, align=0):
    """``prefix_puts``, then commit the full prompt pages. → the last
    logits row."""
    logits = prefix_puts(eng, uid, prompt, start, align)
    eng.commit_prefix(uid, prompt)
    return logits


def prefix_decode(eng, uids, seeds, n):
    """Fused windows (K7) until each stream holds ``n`` tokens, its seed
    first. → one token list per uid."""
    out = [[int(s)] for s in seeds]
    while len(out[0]) < n:
        steps = min(PREFIX_WINDOW, n - len(out[0]))
        toks = eng.decode_batch(uids, [o[-1] for o in out], steps)
        for o, col in zip(out, toks.T):
            o.extend(int(t) for t in col)
    return out


def prefix_retire(eng, uid, prompt):
    eng.commit_prefix(uid, prompt, allow_partial=True)
    eng.flush([uid])


def prefix_request(torch, eng, uid, prompt, align=0):
    """One request from admission to retirement; the time to first token
    runs from admission to the first token on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matched = prefix_admit(eng, uid, prompt, PREFIX_NEW)
    logits = prefix_prefill(eng, uid, prompt, matched, align)
    seed = int(logits.argmax())
    ttft = time.perf_counter() - t0
    tokens = prefix_decode(eng, [uid], [seed], PREFIX_NEW)[0]
    prefix_retire(eng, uid, prompt)
    return {"matched": matched, "ttft_s": ttft, "logits": logits.float(),
            "tokens": tokens}


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def phase_prefix_serving(torch, ops, model):
    """Prefix reuse and the KV memory tier on the llama3-8B serving model
    (bf16, page 64, max_ctx 2048): a prefix-cache engine with a 96-block
    pool and a 512 MB host tier, in the lifecycle scheduler's call order
    (graft, reserve, put the rest, commit at prefill end, fused windows,
    commit the tail and flush at retirement), beside a cache-off engine.

    1. a shared 1,024-token system prompt with 8 suffixes of 64-256
       tokens, 32 greedy tokens each: request 0 prefills it, requests 1-7
       graft it (request 7 extends request 0's whole prompt, so it grafts
       request 0's partial tail page by copy-on-write); each request's
       first-token logits against its cold twin, the same request on the
       cache-off engine put in the chunks that the grafted pages and the
       remainder were put in (SERVING_LOGITS_REL, and bit for bit with
       the greedy tokens: the same computation); the shared partial page's
       bits unchanged after the copy-on-write graft and its decode; a
       planted fault, one word of a copy-on-write copy flipped as the copy
       lands, must make the grafted run's logits differ from its twin's;
    2. four unrelated 1,280-token prompts at once, each reserving 256 new
       tokens (and stopping after 9, as at an end-of-sequence token), take
       the whole pool: every cached page is evicted, the full ones spilled
       to the host tier;
    3. four more shared-prompt requests graft the system prompt back, the
       evicted pages from the host: with one value of the tail page's host
       copy planted one bf16 ulp up, the grafted pages must differ from the
       pages as first committed in that value alone; with it put back,
       they equal them bit for bit;
    4. a decoding sequence is spilled (``kv_swap.spill``), flushed,
       restored and finished: its restored rows equal the spilled ones bit
       for bit, and its logits after the restore are held against the
       same request's run on the cache-off engine (SERVING_LOGITS_REL),
       greedy agreement reported;
    5. one window under ``site=decode_window,kind=nan`` flags exactly its
       first uid, and its batchmate's tokens equal the same window's on
       the cache-off engine. (The comparisons are across engines because a
       second request of one prompt on the prefix engine grafts the first
       one's pages and puts fewer tokens, which rounds otherwise in bf16;
       on the cache-off engine the twin's chunks fall where the grafted
       pages' and the remainder's did.)

    K6's and K7's counters are set to 0 at the start and must rise. →
    the results."""
    import numpy as np

    from deepspeed_tpu_torch import (InferenceEngineV2,
                                     RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2 import kv_ship
    from deepspeed_tpu_torch.runtime.fault import injection

    cfg = model.config
    rng = np.random.default_rng(SEED + 16)

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]

    system = toks(PREFIX_SYSTEM)
    prompts = [system + toks(n) for n in PREFIX_SUFFIXES]
    prompts.append(prompts[0] + toks(PREFIX_COW_EXTRA))
    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        prefix_cache=True, host_tier_mb=PREFIX_HOST_MB, **PREFIX_ENGINE),
        device=DEVICE)
    cold = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        **PREFIX_ENGINE), device=DEVICE)
    cache, swap = eng.prefix_cache, eng.kv_swap
    page_row_bytes = swap._page_row_bytes()
    log(f"prefix serving: {PREFIX_ENGINE['num_blocks']} blocks of "
        f"{eng.kv.mem_bytes() // PREFIX_ENGINE['num_blocks'] / 1e6:.2f} MB "
        f"(pool {eng.kv.mem_bytes() / 1e9:.2f} GB), host tier "
        f"{PREFIX_HOST_MB} MB = {PREFIX_HOST_MB * 1e6 / page_row_bytes:.1f} "
        f"float32 pages of {page_row_bytes / 1e6:.2f} MB; {CARD}")
    torch.cuda.synchronize()
    ops.ragged_paged_attention.launches = 0
    ops.decode_paged_attention.launches = 0
    t_phase = time.perf_counter()
    out = {"card": CARD}

    # 1. the shared system prompt ----------------------------------- #
    runs, colds = [], []
    for uid, prompt in enumerate(prompts):
        if uid == len(prompts) - 1:
            matched, blocks, partial = cache.match(prompt)
            check(partial > 0 and matched == len(prompts[0]),
                  f"prefix serving: request {uid} should graft request 0's "
                  f"partial tail page (matched {matched}, partial {partial})")
            shared_ids = eng.kv.phys_pages(blocks[-1:])
            shared_before = eng.kv.pages[shared_ids].clone()
            transfers = eng.heat.transfers
        runs.append(prefix_request(torch, eng, uid, prompt))
        colds.append(prefix_request(torch, cold, uid, prompt,
                                    align=runs[-1]["matched"]))
        if uid == 0:
            _, sys_blocks, _ = cache.match(system + [0])
            check(len(sys_blocks) == PREFIX_SYSTEM // 64,
                  f"prefix serving: the system prompt committed "
                  f"{len(sys_blocks)} pages")
            sys_rows = eng.kv.pages[eng.kv.phys_pages(sys_blocks)].clone()
    check(runs[0]["matched"] == 0, "prefix serving: request 0 grafted")
    rels, agree, same = [], [], []
    for uid in range(1, len(prompts)):
        check(runs[uid]["matched"] >= PREFIX_SYSTEM,
              f"prefix serving: request {uid} grafted "
              f"{runs[uid]['matched']} tokens")
        rel = rel_l2(torch, runs[uid]["logits"], colds[uid]["logits"])
        rels.append(rel)
        agree.append(float(np.mean([a == b for a, b in zip(
            runs[uid]["tokens"], colds[uid]["tokens"])])))
        same.append(same_bits(torch, runs[uid]["logits"],
                              colds[uid]["logits"])
                    and runs[uid]["tokens"] == colds[uid]["tokens"])
        check(rel <= SERVING_LOGITS_REL,
              f"prefix serving: request {uid}'s grafted first-token logits "
              f"differ from the cold engine's: rel {rel}")
        # the cold twin puts the same chunks over the same rows: the same
        # computation, so the same bits
        check(same[-1], f"prefix serving: request {uid}'s grafted run "
                        f"differs from its cold twin: logits rel {rel}, "
                        f"greedy agreement {agree[-1]}")
    shared_after = eng.kv.pages[shared_ids]
    cow_same = same_bits(torch, shared_after, shared_before)
    check(cow_same, "prefix serving: the copy-on-write graft changed the "
                    "shared partial page")
    check(eng.heat.transfers == transfers + 1,
          "prefix serving: the copy-on-write graft made no page copy")
    # planted fault: one word of a copy-on-write copy flipped as the copy
    # lands (the sign of the largest value of the page's first row in
    # layer 0); the grafted run must then differ from its cold twin
    uid, planted = len(prompts), prompts[0] + toks(PREFIX_COW_EXTRA)
    m, _, partial = cache.match(planted)
    check(partial > 0 and m == len(prompts[0]),
          f"prefix serving: the planted request should graft request 0's "
          f"partial tail page (matched {m}, partial {partial})")
    real_copy = eng._copy_pages

    def flipped_copy(src, dst):
        real_copy(src, dst)
        with torch.inference_mode():
            row = eng.kv.pages[int(eng.kv.phys_pages([dst])[0])][0].view(-1)
            i = int(row.float().abs().argmax())
            row[i] = -row[i]

    eng._copy_pages = flipped_copy
    try:
        m = prefix_admit(eng, uid, planted, PREFIX_NEW)
    finally:
        del eng._copy_pages
    bad = prefix_puts(eng, uid, planted, m).float()
    eng.flush([uid])                   # uncommitted: the trie never sees it
    prefix_admit(cold, uid, planted, PREFIX_NEW)
    twin = prefix_puts(cold, uid, planted, 0, align=m).float()
    cold.flush([uid])
    cow_fault_rel = rel_l2(torch, bad, twin)
    check(not same_bits(torch, bad, twin),
          "prefix serving: a flipped word in a copy-on-write copy passed "
          "the grafted-vs-cold check")
    saved = sum(r["matched"] for r in runs)
    ttft_g = [r["ttft_s"] for r in runs[1:4]]
    ttft_c = [r["ttft_s"] for r in colds[1:4]]
    log(f"prefix serving 1: {len(prompts)} requests on a {PREFIX_SYSTEM}-"
        f"token system prompt; grafted tokens {[r['matched'] for r in runs]}"
        f" ({saved} prefill tokens saved); grafted vs cold first-token "
        f"logits rel l2 {[float(f'{r:.3e}') for r in rels]} (limit "
        f"{SERVING_LOGITS_REL}), "
        f"greedy agreement {[round(a, 3) for a in agree]}, logits and "
        f"tokens bit-identical to the cold twin's {same}; the shared "
        f"partial page bit-identical after the copy-on-write graft and its "
        f"decode: {cow_same} (checksum "
        f"{int(shared_before.view(torch.int16).long().sum())}); planted "
        f"fault, one word of a copy-on-write copy's sign flipped: logits "
        f"against the cold twin's rel l2 {cow_fault_rel:.3e} "
        f"({cow_fault_rel / SERVING_LOGITS_REL:.3f}x the serving limit), "
        f"bit-identical False")
    ms_g = [round(1e3 * t, 1) for t in ttft_g]
    ms_c = [round(1e3 * t, 1) for t in ttft_c]
    log(f"prefix serving 1: time to first token, requests 1-3, median of 3: "
        f"grafted {_median(ms_g)} ms {ms_g}, cold {_median(ms_c)} ms "
        f"{ms_c}; {CARD}")
    out["shared_prompt"] = {
        "grafted_tokens": [r["matched"] for r in runs],
        "prefill_tokens_saved": saved,
        "logits_rel_l2": rels, "logits_limit": SERVING_LOGITS_REL,
        "greedy_agreement": agree, "bit_identical_to_cold": same,
        "cow_page_unchanged": cow_same,
        "planted_cow_fault_logits_rel_l2": cow_fault_rel,
        "ttft_grafted_s": [r["ttft_s"] for r in runs],
        "ttft_cold_s": [r["ttft_s"] for r in colds],
        "ttft_grafted_median3_s": _median(ttft_g),
        "ttft_cold_median3_s": _median(ttft_c)}
    del shared_before, shared_after, bad, twin

    # 2. four unrelated prompts fill the pool ----------------------- #
    unrelated = [toks(PREFIX_UNRELATED) for _ in range(4)]
    uids = [200 + i for i in range(4)]
    free0 = eng.state_manager.free_blocks
    for u, p in zip(uids, unrelated):
        check(prefix_admit(eng, u, p, PREFIX_UNRELATED_NEW) == 0,
              "prefix serving: an unrelated prompt grafted")
    seeds = [int(prefix_prefill(eng, u, p, 0).argmax())
             for u, p in zip(uids, unrelated)]
    prefix_decode(eng, uids, seeds, PREFIX_WINDOW + 1)
    for u, p in zip(uids, unrelated):
        prefix_retire(eng, u, p)
    on_device = len(cache.match(system + [0])[1])
    log(f"prefix serving 2: 4 unrelated {PREFIX_UNRELATED}-token prompts; "
        f"free blocks before {free0}; evicted {cache.evicted} cached pages, "
        f"{swap.prefix_spilled} full ones spilled to the host tier "
        f"({eng.host_tier.used_bytes / 1e6:.1f} MB held); the system "
        f"prompt keeps {on_device} of {len(sys_blocks)} pages on the card")
    check(swap.prefix_spilled > 0 and on_device < len(sys_blocks),
          "prefix serving: the pool pressure spilled no system-prompt page")
    out["pressure"] = {"evicted": cache.evicted,
                       "prefix_spilled": swap.prefix_spilled,
                       "system_pages_on_card": on_device}

    # 3. graft the system prompt back from the host ------------------ #
    later = [system + toks(n) for n in PREFIX_LATER]
    restored0 = swap.prefix_restored
    # planted fault: one value of the host copy of the system prompt's tail
    # page one bf16 ulp up (layer 0, its first nonzero value); the graft
    # back must carry it into the pool, and the identity check must see
    # exactly it
    tail = len(sys_blocks) - 1
    host_rows = swap.peek_prefix(tuple(system))
    check(host_rows is not None,
          "prefix serving: the system prompt's tail page is not on the host")
    with torch.inference_mode():
        flat = host_rows[0].view(-1)
        i = int(torch.nonzero(flat.isfinite() & (flat != 0))[0])
        orig = flat[i:i + 1].clone()
        up = orig.to(torch.bfloat16)
        up.view(torch.int16).add_(1)
        flat[i:i + 1] = up.float()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    matched = eng.graft_prefix(300, later[0])
    torch.cuda.synchronize()
    graft_s = time.perf_counter() - t0
    from_host = swap.prefix_restored - restored0
    t0 = time.perf_counter()
    check(prefix_admit(eng, 300, later[0], PREFIX_NEW) == 0,
          "prefix serving: a second graft into one sequence")
    torch.cuda.synchronize()
    reserve_s = time.perf_counter() - t0
    check(matched >= PREFIX_SYSTEM and from_host > 0,
          f"prefix serving: the graft back took {matched} tokens, "
          f"{from_host} pages from the host")
    blocks = eng.state_manager.get_sequence(300).blocks[:len(sys_blocks)]
    ids = eng.kv.phys_pages(blocks)      # layer-major: layer 0 comes first
    back = eng.kv.pages[ids]
    planted_ulps = bf16_ulps(torch, back, sys_rows)
    off = torch.nonzero((back.view(torch.int16)
                         != sys_rows.view(torch.int16)).view(-1)).view(-1)
    at_plant = off.tolist() == [tail * back[0].numel() + i]
    check(not same_bits(torch, back, sys_rows) and planted_ulps > 0.5
          and at_plant,
          f"prefix serving: the planted host value did not show as the one "
          f"difference of the grafted pages ({planted_ulps} bf16 ulps at "
          f"{off[:4].tolist()})")
    with torch.inference_mode():      # put the planted value back
        eng.kv.pages[int(ids[tail])].view(-1)[i:i + 1] = orig.to(
            eng.kv.pages.dtype)
    back = eng.kv.pages[ids]
    ulps = bf16_ulps(torch, back, sys_rows)
    identical = same_bits(torch, back, sys_rows)
    check(identical and ulps == 0.0,
          f"prefix serving: the grafted system pages differ from the ones "
          f"first committed ({ulps} bf16 ulps)")
    logits = prefix_prefill(eng, 300, later[0], matched)
    prefix_decode(eng, [300], [int(logits.argmax())], PREFIX_NEW)
    prefix_retire(eng, 300, later[0])
    log(f"prefix serving 3: graft back {matched} tokens, {from_host} pages "
        f"({from_host * page_row_bytes / 1e6:.1f} MB float32) from the host "
        f"in {1e3 * graft_s:.1f} ms (the lifetime reservation after it, "
        f"evictions and their spills included, {1e3 * reserve_s:.1f} ms); "
        f"planted fault, one value of the tail page's host copy one bf16 "
        f"ulp up: the grafted pages read {planted_ulps:.1f} ulps = "
        f"{planted_ulps / 0.5:.1f}x the limit 0.5, their one difference at "
        f"the planted value: {at_plant}; with that value put back, the "
        f"{len(sys_blocks)} system pages bit-identical to the ones first "
        f"committed: {identical} ({ulps} bf16 ulps); {CARD}")
    out["graft_back"] = {"matched": matched, "pages_from_host": from_host,
                         "bytes_from_host": from_host * page_row_bytes,
                         "seconds": graft_s, "reserve_s": reserve_s,
                         "bit_identical": identical,
                         "planted_fault_ulps": planted_ulps,
                         "planted_fault_x_limit": planted_ulps / 0.5,
                         "planted_fault_is_the_one_difference": at_plant}
    del back, sys_rows

    # 4. spill, flush and restore a decoding sequence --------------- #
    # its uninterrupted twin runs on the cache-off engine, whose chunks of
    # 256 fall where the grafted request's do: the same computation
    prompt = later[1]
    streams, logits_at = {}, {}
    for e in (eng, cold):
        m = prefix_admit(e, 310, prompt, PREFIX_NEW)
        seed = int(prefix_prefill(e, 310, prompt, m).argmax())
        streams[e] = prefix_decode(e, [310], [seed], PREFIX_WINDOW + 1)[0]
    cached = prompt + streams[eng][:-1]
    before = kv_ship.export_kv(eng, 310, cached).rows
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parked = swap.spill(310, cached)
    eng.host_tier.sync()                # the copy has landed on the host
    spill_s = time.perf_counter() - t0
    eng.flush([310])
    resume = prompt + streams[eng]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = swap.restore(310, resume)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(parked == len(cached) and restored == len(cached),
          f"prefix serving: spilled {parked} and restored {restored} of "
          f"{len(cached)} tokens")
    after = kv_ship.export_kv(eng, 310, cached).rows
    rows_same = same_bits(torch, after, before)
    check(rows_same, "prefix serving: the restored rows differ from the "
                     "spilled ones")
    check(prefix_admit(eng, 310, resume, PREFIX_NEW - len(streams[eng]))
          == 0, "prefix serving: the restored sequence grafted")
    for e in (eng, cold):
        logits_at[e] = e.put([310], [[streams[e][-1]]])[0].float()
        streams[e] += prefix_decode(
            e, [310], [int(logits_at[e].argmax())],
            PREFIX_NEW - len(streams[e]))[0]
        prefix_retire(e, 310, resume)
    rel = rel_l2(torch, logits_at[eng], logits_at[cold])
    swap_agree = float(np.mean([a == b for a, b in zip(streams[eng],
                                                       streams[cold])]))
    check(rel <= SERVING_LOGITS_REL,
          f"prefix serving: the restored sequence's logits differ from the "
          f"uninterrupted run's: rel {rel}")
    st = swap.stats()
    spill_bytes = int(before.numel()) * 4
    log(f"prefix serving 4: spilled {parked} tokens ({spill_bytes / 1e6:.1f}"
        f" MB float32) in {1e3 * spill_s:.1f} ms, restored "
        f"{st['swap_in_bytes'] / 1e6:.1f} MB in {1e3 * restore_s:.1f} ms; "
        f"rows bit-identical: {rows_same}; logits after the restore against "
        f"the uninterrupted run's rel l2 {rel:.3e} (limit "
        f"{SERVING_LOGITS_REL}), max abs "
        f"{max_abs(torch, logits_at[eng], logits_at[cold]):.3e}, greedy "
        f"tokens agree {swap_agree:.3f}; {CARD}")
    out["sequence_swap"] = {"tokens": parked, "spill_bytes": spill_bytes,
                            "spill_s": spill_s,
                            "restore_bytes": st["swap_in_bytes"],
                            "restore_s": restore_s,
                            "rows_bit_identical": rows_same,
                            "logits_rel_l2": rel,
                            "token_agreement": swap_agree}
    del before, after

    # 5. a NaN-poisoned window, and the same window clean on the
    # cache-off engine --------------------------------------------- #
    pair = {400: later[2], 401: later[3]}
    windows = {}
    for e in (cold, eng):
        seeds = [int(prefix_prefill(e, u, p, prefix_admit(
            e, u, p, PREFIX_NEW)).argmax()) for u, p in pair.items()]
        if e is cold:
            windows[e] = e.decode_batch(list(pair), seeds, PREFIX_WINDOW)
            continue
        injection.configure("site=decode_window,kind=nan,times=1")
        try:
            window = eng.decode_batch_async(list(pair), seeds,
                                            PREFIX_WINDOW)
            flagged = window.nonfinite_uids()
            windows[e] = window.tokens()
        finally:
            injection.clear()
    mate_same = windows[eng][:, 1].tolist() == windows[cold][:, 1].tolist()
    check(flagged == [400], f"prefix serving: the poisoned window flagged "
                            f"{flagged}, not [400]")
    check(mate_same, "prefix serving: the poisoned window's batchmate "
                     "decoded differently from the clean window")
    for e in (cold, eng):
        for uid, prompt in pair.items():
            prefix_retire(e, uid, prompt)
    log(f"prefix serving 5: decode_window nan flagged {flagged}; the "
        f"batchmate's {PREFIX_WINDOW} tokens equal the clean window's: "
        f"{mate_same}")
    out["poisoned_window"] = {"flagged": flagged,
                              "batchmate_equal": mate_same}

    torch.cuda.synchronize()
    launches = {"ragged_paged_attention": ops.ragged_paged_attention.launches,
                "decode_paged_attention": ops.decode_paged_attention.launches}
    for name, n in launches.items():
        check(n > 0, f"prefix serving never launched {name}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    out["swap_stats"] = swap.stats()
    out["host_tier"] = eng.host_tier.stats()
    log(f"prefix serving: launches {launches}; {out['phase_s']:.1f} s")
    del eng, cold
    _free(torch)
    return out


# --------------------------------------------------------------------- #
# Speculative decoding and the universal families (ROADMAP M7.5, M7.6)
# --------------------------------------------------------------------- #
SPEC_NEW = 32                      # new tokens a stream: the seed and 31
SPEC_K = 4                         # draft candidates a window
SPEC_DRAFT_LAYERS = 2              # the small draft model's depth
#: the content check's rule. SPEC_MARGIN = SPEC_MARGIN_FACTOR x the
#: largest |paged - gather| logit difference on the re-score batch: if two
#: paths' logits differ by at most d everywhere, a token that is the
#: argmax under one lies at most 2d below the other's largest logit. So an
#: emitted token may sit below the re-score's argmax by at most
#: SPEC_MARGIN (a near-tie of two kernels' roundings), and a planted fault
#: must read at least SPEC_FAULT_FACTOR x SPEC_MARGIN
SPEC_MARGIN_FACTOR = 2.0
SPEC_FAULT_FACTOR = 10.0
#: a ceiling on SPEC_MARGIN whatever the run reads. The rule reads 0.215
#: on llama3-8B and 0.219 on Bloom-7b1 (bf16, an H100), and the re-scores
#: are held to SERVING_LOGITS_REL as well: a verify path that drifted
#: from gather fails here instead of widening its own margin
SPEC_MARGIN_CAP = 0.5
#: bigscience/bloom-7b1 config.json: n_layer 30, n_head 32, hidden 4096,
#: vocab 250880, layer_norm_epsilon 1e-5, ALiBi, embedding LayerNorm,
#: tied head; FFN 4 x hidden, tanh gelu (modeling_bloom)
BLOOM_7B1 = dict(vocab_size=250880, hidden_size=4096,
                 intermediate_size=16384, num_layers=30, num_heads=32,
                 num_kv_heads=32, max_seq_len=2048, pos="alibi",
                 norm="layernorm", norm_eps=1e-5, mlp="gelu",
                 embed_layernorm=True, qkv_bias=True, out_bias=True,
                 tie_embeddings=True)
#: tiiuae/falcon-7b config.json: n_layer 32, n_head 71, multi_query (one
#: KV head), hidden 4544, vocab 65024, parallel_attn, bias false, rotary
#: (theta 10000), layer_norm_epsilon 1e-5; FFN 4 x hidden, erf gelu, tied
#: head (modeling_falcon). Depth cut to FALCON_LAYERS of 32 to bound the
#: run's time
FALCON_7B = dict(vocab_size=65024, hidden_size=4544,
                 intermediate_size=18176, num_layers=32, num_heads=71,
                 num_kv_heads=1, max_seq_len=2048, pos="rope",
                 rope_theta=10000.0, norm="layernorm", norm_eps=1e-5,
                 mlp="gelu", gelu_exact=True, parallel_attn=True,
                 qkv_bias=False, out_bias=False, tie_embeddings=True)
FALCON_LAYERS = 8
FAMILY_NEW = 64                    # generate's new tokens a prompt
FAMILY_SPEC_NEW = 16               # Bloom's speculative stream
FAMILY_MAX_SEQS = 8


class WrongDrafter:
    """Drafts the seed plus one, k times: rejected at the first candidate
    unless the model's greedy token is that, so every window rolls back."""

    def __init__(self, vocab):
        self.vocab = vocab

    def draft(self, uid, tokens, k):
        return [(int(tokens[-1]) + 1) % self.vocab] * k

    def flush(self, uid):
        pass


class RecordingDrafter:
    """A drafter that keeps each call's (uid, stream length, draft)."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def draft(self, uid, tokens, k):
        d = self.inner.draft(uid, tokens, k)
        self.calls.append((uid, len(tokens), list(d)))
        return d

    def flush(self, uid):
        self.inner.flush(uid)


def spec_prefill(eng, uids, prompts):
    """``put`` each prompt in the engine's token-budget chunks → the last
    chunk's logits rows ``[n, V]`` (float32, on the card)."""
    import torch

    budget = eng.config.max_tokens
    rows = []
    for uid, p in zip(uids, prompts):
        for i in range(0, len(p), budget):
            logits = eng.put([uid], [p[i:i + budget]])
        rows.append(logits[0])
    return torch.stack(rows)


def forced_logits(torch, eng, uids, chunks, bucket=None):
    """One ``verify_mode`` forward (the logits of every position; K6 on the
    paged path) over each uid's chunk, appended at its current length:
    teacher forcing in the engine's own batches (``bucket``: the (token,
    seq) budgets, by default ``eng.bucket_for``'s). → ``[sum len, V]``
    float32, the uids' rows in order."""
    from deepspeed_tpu_torch.inference.v2.model_runner import \
        build_ragged_step

    sm = eng.state_manager
    n = sum(len(c) for c in chunks)
    check(n <= eng.config.max_tokens, f"forced batch of {n} tokens")
    bucket = bucket or eng.bucket_for(n, len(uids))
    wrapper = eng._wrapper_for(bucket)
    wrapper.clear()
    for uid, c in zip(uids, chunks):
        seq = sm.get_or_create_sequence(uid)
        check(sm.maybe_allocate_kv(seq, len(c)), f"uid {uid}: no KV room")
        wrapper.insert_sequence(seq, [int(t) for t in c])
    batch = wrapper.finalize()
    step = build_ragged_step(
        eng.cfg, max_q=bucket[0], num_blocks=eng._num_blocks,
        attn_impl=eng.config.attn_impl, max_seqs=bucket[1],
        max_blocks=wrapper.max_blocks, verify_mode=True)
    with torch.inference_mode():
        logits = step(eng.model, eng.kv.pages, eng._upload(batch.pack()))
    for uid in uids:
        sm.get_sequence(uid).post_forward()
    return logits[:n]


def stream_rows(torch, eng, uids, prompt_lens, first, streams):
    """Each stream's re-score: row j holds the logits at the position that
    emitted ``stream[j]`` (row 0 is the prompt's last, ``first``; the rest
    come from one forced forward over ``stream[:-1]``); the uids are
    rolled back to their prompts afterwards. → list of ``[len, V]``."""
    forced = forced_logits(torch, eng, uids, [s[:-1] for s in streams])
    for uid, n in zip(uids, prompt_lens):
        eng.rollback_kv(uid, n)
    out, at = [], 0
    for i, s in enumerate(streams):
        out.append(torch.cat([first[i:i + 1], forced[at:at + len(s) - 1]]))
        at += len(s) - 1
    return out


def gaps_of(torch, rows, tokens):
    """Largest logit less the logit of ``tokens`` (one a row), a tensor."""
    idx = torch.tensor(tokens, device=rows.device)[:, None]
    return rows.max(-1).values - rows.gather(1, idx)[:, 0]


def rejected_candidates(calls, prompt_lens, streams, uids):
    """The first rejected candidate of every recorded draft: ``(stream,
    position j, candidate)``. A draft made on ``prompt + stream[:m]``
    proposes ``stream[m:]``; its first mismatch at ``m + a`` had the
    accepted stream up to there as context, as the re-score has."""
    out = []
    for uid, hist_len, d in calls:
        i = uids.index(uid)
        m = hist_len - prompt_lens[i]
        s = streams[i]
        a = 0
        while a < len(d) and m + a < len(s) and d[a] == s[m + a]:
            a += 1
        if a < len(d) and m + a < len(s):
            out.append((i, m + a, d[a]))
    return out


def spec_content_check(torch, model, prompts, runs, candidates=None,
                       fault=None, unheld=(), **engine_kw):
    """Speculation changes speed, never content: re-score every run's
    streams teacher-forced on a fresh paged engine (``stream_rows``) and
    hold each emitted token's gap (the re-score's largest logit less the
    token's) to ``SPEC_MARGIN``. The first run's batch, re-scored on a
    gather engine too, sets ``SPEC_MARGIN`` (the rule at
    ``SPEC_MARGIN_FACTOR``, at most ``SPEC_MARGIN_CAP``; the two re-scores
    within ``SERVING_LOGITS_REL``). ``candidates``: per run, the first rejected
    draft candidates ``(stream, position, token)``, held to the margin as
    well. ``fault``: a run with a planted fault, whose largest gap must
    read at least ``SPEC_FAULT_FACTOR`` x the margin, and is not held to
    it. ``unheld``: runs whose gaps are printed and not held (a lossy path
    by design). → (margin record, per-run results)."""
    from deepspeed_tpu_torch import (InferenceEngineV2,
                                     RaggedInferenceEngineConfig)

    uids = list(range(len(prompts)))
    lens = [len(p) for p in prompts]
    names = list(runs)
    rows = {}
    for impl in ("gather", "paged"):
        eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            attn_impl=impl, **engine_kw), device=DEVICE)
        first = spec_prefill(eng, uids, prompts)
        rows[impl] = stream_rows(torch, eng, uids, lens, first,
                                 runs[names[0]])
        if impl == "gather":
            del eng, first
            _free(torch)
    for r in rows["paged"] + rows["gather"]:
        check(bool(torch.isfinite(r).all()), "re-score logits not finite")
    diff = max(float((a - b).abs().max())
               for a, b in zip(rows["paged"], rows["gather"]))
    rel = max(rel_l2(torch, a, b)
              for a, b in zip(rows["paged"], rows["gather"]))
    margin = SPEC_MARGIN_FACTOR * diff
    check(margin > 0, "paged and gather re-scores are bit-identical: the "
                      "margin rule has no difference to scale")
    check(rel <= SERVING_LOGITS_REL,
          f"content check: paged vs gather re-scores differ: rel l2 "
          f"{rel:.3e} > {SERVING_LOGITS_REL}")
    check(margin <= SPEC_MARGIN_CAP,
          f"content check: SPEC_MARGIN {margin:.4e} > the cap "
          f"{SPEC_MARGIN_CAP}: the verify path drifted from gather")
    del rows["gather"]
    record = {"paged_vs_gather_max_abs": diff, "paged_vs_gather_rel_l2": rel,
              "spec_margin": margin, "spec_margin_cap": SPEC_MARGIN_CAP,
              "rule": f"{SPEC_MARGIN_FACTOR} x max |paged - gather| on the "
              f"{names[0]} re-score batch, at most {SPEC_MARGIN_CAP}"}
    log(f"content check: paged vs gather on the {names[0]} batch: max abs "
        f"{diff:.4e}, rel l2 {rel:.3e}; SPEC_MARGIN {margin:.4e}")
    out = {}
    for name in names:
        streams = runs[name]
        r = rows["paged"] if name == names[0] else stream_rows(
            torch, eng, uids, lens, first, streams)
        gaps = torch.cat([gaps_of(torch, ri, s) for ri, s in
                          zip(r, streams)])
        res = {"positions": int(gaps.numel()),
               "max_gap": float(gaps.max()),
               "off_argmax_share": float((gaps > 0).float().mean()),
               "agree_with_first_run": sum(
                   a == b for s, t in zip(streams, runs[names[0]])
                   for a, b in zip(s, t)) / sum(len(s) for s in streams)}
        cands = (candidates or {}).get(name, [])
        if cands:
            cg = [float(r[i][j].max() - r[i][j][c]) for i, j, c in cands]
            res["rejected_candidates"] = len(cg)
            res["rejected_candidate_max_gap"] = max(cg)
            check(max(cg) <= margin,
                  f"content check {name}: a rejected draft candidate lies "
                  f"{max(cg):.4e} below the argmax (> SPEC_MARGIN "
                  f"{margin:.4e}): the draft and the verify disagree beyond "
                  f"a near-tie")
        log(f"content check {name}: {res['positions']} positions, max gap "
            f"{res['max_gap']:.4e} ({res['max_gap'] / margin:.2f} x "
            f"SPEC_MARGIN), off the argmax {res['off_argmax_share']:.4f}, "
            f"tokens equal to {names[0]}'s {res['agree_with_first_run']:.3f}"
            + (f"; {len(cands)} rejected candidates, max gap "
               f"{res['rejected_candidate_max_gap']:.4e}" if cands else ""))
        if name in unheld:
            pass
        elif name == fault:
            check(res["max_gap"] >= SPEC_FAULT_FACTOR * margin,
                  f"planted fault {name}: max gap {res['max_gap']:.4e} < "
                  f"{SPEC_FAULT_FACTOR} x SPEC_MARGIN {margin:.4e}")
        else:
            check(res["max_gap"] <= margin,
                  f"content check {name}: an emitted token lies "
                  f"{res['max_gap']:.4e} below the re-score's argmax "
                  f"(> SPEC_MARGIN {margin:.4e})")
        out[name] = res
        del r, gaps
    del eng, first, rows
    _free(torch)
    return record, out


def spec_run(torch, ops, eng, drafter, uids, prompts, seeds, steps,
             rollback=True):
    """``speculative_decode`` from the prefilled prompts, timed, with K6's
    and K7's launches inside the target's verify windows counted (a draft
    engine's own launches are left out); ``rollback=False`` plants the
    fault: rejected rows stay in the context. The uids are rolled back to
    their prompts afterwards and the drafter flushed. → (streams, seed
    first, ``SPEC_NEW`` tokens; record)."""
    from deepspeed_tpu_torch.inference.v2.speculative import \
        speculative_decode

    inside = {"k6": 0, "k7": 0}
    verify = eng.verify_decode

    def counted(*args, **kw):
        k6 = ops.ragged_paged_attention.launches
        k7 = ops.decode_paged_attention.launches
        res = verify(*args, **kw)
        inside["k6"] += ops.ragged_paged_attention.launches - k6
        inside["k7"] += ops.decode_paged_attention.launches - k7
        return res

    eng.verify_decode = counted
    if not rollback:
        eng.rollback_kv = lambda uid, new_seen: None
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, stats = speculative_decode(
            eng, drafter, uids, seeds,
            [list(p) + [s] for p, s in zip(prompts, seeds)], steps, SPEC_K)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        del eng.verify_decode
        if not rollback:
            del eng.rollback_kv
    sm = eng.state_manager
    rec = {**stats, "wall_s": wall, "per_user_tok_s": steps / wall,
           "verify_k6_launches": inside["k6"],
           "verify_k7_launches": inside["k7"],
           "k6_launches_per_window": inside["k6"] / stats["windows"],
           "seen": [sm.get_sequence(u).seen_tokens for u in uids],
           "blocks": [sm.get_sequence(u).cur_allocated_blocks for u in uids]}
    check(inside["k6"] == eng.cfg.num_layers * stats["windows"],
          f"verify windows launched K6 {inside['k6']} times in "
          f"{stats['windows']} windows of {eng.cfg.num_layers} layers")
    check(inside["k7"] == 0, "a verify window launched K7")
    for uid, p in zip(uids, prompts):
        eng.rollback_kv(uid, len(p))
        drafter.flush(uid)
    streams = [[s] + out[u][:steps] for u, s in zip(uids, seeds)]
    return streams, rec


def phase_speculative(torch, ops, model, prompts):
    """Speculative decoding on the llama3-8B serving model (bf16, page 64,
    the default engine): the 8 prompts, ``SPEC_NEW`` new tokens each
    (the seed and 31), k = ``SPEC_K``, after one prefill whose KV every
    run reuses (each run ends with ``rollback_kv`` to the prompts).

    1. vanilla fused decode, one window of 31 steps (K7);
    2. ``speculative_decode`` (K6 in every verify window, once a layer,
       K7 never) with ``NGramDrafter`` twice (the same tokens), a
       same-weights draft engine (a second engine over this model object,
       its own small pool, no weight copy), a ``SPEC_DRAFT_LAYERS``-layer
       draft at llama3-8B widths from another seed, and an always-wrong
       drafter (one window a token, no draft accepted, the KV length the
       prompt plus the tokens produced, the window's blocks kept); then
       the always-wrong drafter with ``rollback_kv`` skipped (the planted
       fault);
    3. a ``decode_window``/``nan`` verify window (``DSTPU_FAULT_INJECT``)
       flags only its first uid and rolls its KV length back; its
       batchmate's chain and greedy vector equal a clean repeat's bit for
       bit; after ``flush`` the free count is back to its start;
    4. the content check (``spec_content_check``) of every run.
    Per-user tokens/s, acceptance, windows, drafting and verify seconds
    and K6 launches a window are printed beside the card; not gated."""
    import dataclasses

    from deepspeed_tpu_torch import (CausalLM, InferenceEngineV2,
                                     RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.speculative import (
        DraftModelDrafter, NGramDrafter)
    from deepspeed_tpu_torch.models.transformer import init_params
    from deepspeed_tpu_torch.runtime.fault import injection

    t_phase = time.perf_counter()
    cfg = model.config
    uids = list(range(len(prompts)))
    lens = [len(p) for p in prompts]
    steps = SPEC_NEW - 1
    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(),
                            device=DEVICE)
    sm = eng.state_manager
    bs = eng.config.block_size
    free0 = sm.free_blocks
    seeds = [int(t) for t in spec_prefill(eng, uids, prompts).argmax(-1)]
    runs, timing = {}, {}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks = eng.decode_batch(uids, seeds, steps)
    wall = time.perf_counter() - t0
    runs["vanilla"] = [[s] + [int(t) for t in toks[:, i]]
                       for i, s in enumerate(seeds)]
    timing["vanilla"] = {"wall_s": wall, "per_user_tok_s": steps / wall}
    for uid, n in zip(uids, lens):
        eng.rollback_kv(uid, n)

    def run(name, drafter, **kw):
        runs[name], timing[name] = spec_run(torch, ops, eng, drafter, uids,
                                            prompts, seeds, steps, **kw)
        t = timing[name]
        log(f"speculative {name}: {t['windows']} windows, acceptance "
            f"{t['acceptance_rate']:.3f} ({t['accepted_draft']} of "
            f"{t['drafted']}), draft {t['draft_s']:.3f} s vs verify "
            f"{t['verify_s']:.3f} s, K6 {t['k6_launches_per_window']:.0f} a "
            f"window, per-user {t['per_user_tok_s']:.1f} tok/s (vanilla "
            f"{timing['vanilla']['per_user_tok_s']:.1f}); {CARD}")

    run("ngram", NGramDrafter())
    run("ngram_repeat", NGramDrafter())
    check(runs["ngram_repeat"] == runs["ngram"],
          "two identical n-gram runs emitted different tokens")
    draft_blocks = sum(-(-(n + SPEC_NEW + 2 * SPEC_K) // bs) for n in lens)
    same_eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        num_blocks=draft_blocks), device=DEVICE)
    same = RecordingDrafter(DraftModelDrafter(same_eng))
    run("same_weights", same)
    cands = rejected_candidates(same.calls, lens, runs["same_weights"], uids)
    del same, same_eng
    dcfg = dataclasses.replace(cfg, num_layers=SPEC_DRAFT_LAYERS)
    small = CausalLM(dcfg, init_params(
        dcfg, torch.Generator(device=DEVICE).manual_seed(SEED + 1),
        torch.bfloat16, DEVICE))
    small_eng = InferenceEngineV2(small, RaggedInferenceEngineConfig(
        num_blocks=draft_blocks), device=DEVICE)
    run("draft_2_layers", DraftModelDrafter(small_eng))
    del small_eng, small
    _free(torch)
    blocks0 = [sm.get_sequence(u).cur_allocated_blocks for u in uids]
    run("always_wrong", WrongDrafter(cfg.vocab_size))
    t = timing["always_wrong"]
    check(t["windows"] == steps and t["accepted_draft"] == 0,
          f"always-wrong drafter: {t['windows']} windows, "
          f"{t['accepted_draft']} accepted")
    check(t["seen"] == [n + steps for n in lens],
          f"always-wrong drafter: KV lengths {t['seen']}, not the prompts "
          f"plus {steps}")
    want = [max(b, -(-(n + steps + SPEC_K) // bs))
            for b, n in zip(blocks0, lens)]
    check(t["blocks"] == want, f"always-wrong drafter: blocks {t['blocks']}"
                               f", not {want}: a rollback freed a block")
    run("skipped_rollback", WrongDrafter(cfg.vocab_size), rollback=False)

    # a decode_window nan verify window, and its clean repeat
    greedy_log = []
    step_for = eng._verify_step_for

    def recording(key):
        step = step_for(key)

        def rec(*args):
            greedy, bad = step(*args)
            greedy_log.append(greedy.clone())
            return greedy, bad
        return rec

    eng._verify_step_for = recording
    pair, pseeds = uids[:2], seeds[:2]
    drafts = [runs["vanilla"][u][1:1 + SPEC_K] for u in pair]
    mate = slice(1 + len(drafts[0]), 2 + len(drafts[0]) + len(drafts[1]))
    os.environ[injection.ENV_VAR] = "site=decode_window,kind=nan,times=1"
    injection.clear()
    try:
        bad = eng.verify_decode(pair, pseeds, drafts)
    finally:
        os.environ.pop(injection.ENV_VAR, None)
        injection.clear()
    bad_greedy = greedy_log[-1][mate]
    check(bad.poisoned and bad.nonfinite_uids == [pair[0]],
          f"nan verify window flagged {bad.nonfinite_uids}, not "
          f"[{pair[0]}]")
    check(sm.get_sequence(pair[0]).seen_tokens == lens[0],
          "the poisoned uid's KV length was not rolled back")
    eng.rollback_kv(pair[1], lens[1])
    clean = eng.verify_decode(pair, pseeds, drafts)
    del eng._verify_step_for
    mate_same = clean.accepted[1] == bad.accepted[1] and \
        torch.equal(greedy_log[-1][mate], bad_greedy)
    check(mate_same, "the poisoned window's batchmate differs from the "
                     "clean repeat's")
    log(f"speculative nan window: flagged {bad.nonfinite_uids}, the "
        f"batchmate's chain {bad.accepted[1]} and greedy vector equal the "
        f"clean repeat's (which flagged {clean.nonfinite_uids}: the "
        f"poisoned pages stay NaN)")
    eng.flush(uids)
    check(sm.free_blocks == free0, f"free blocks {sm.free_blocks} after "
                                   f"flush, {free0} before the phase")
    del eng
    _free(torch)

    margin, content = spec_content_check(
        torch, model, prompts,
        {name: runs[name] for name in ("vanilla", "ngram", "same_weights",
                                       "draft_2_layers", "always_wrong",
                                       "skipped_rollback")},
        candidates={"same_weights": cands}, fault="skipped_rollback")
    out = {"timing": timing, "content": content, "margin": margin,
           "nan_window": {"flagged": bad.nonfinite_uids,
                          "batchmate_equal": mate_same},
           "phase_s": time.perf_counter() - t_phase}
    log(f"speculative: {out['phase_s']:.1f} s; {CARD}")
    return out


# --------------------------------------------------------------------- #
# The serving lifecycle and its HTTP server (ROADMAP M7.7)
# --------------------------------------------------------------------- #
LIFE_NEW = 64                      # new tokens a request, as generate's
LIFE_WINDOW = 8                    # the scheduler's decode window
#: KV-pressure preemption: a pool of 40 pages of 64 (32 layers x 64
#: tokens x 2 x 8 KV heads x 128 x 2 B = 8.4 MB a page, 335 MB in all).
#: The priority-0 victim (the 1,024-token prompt, 64 new: 17 pages)
#: decodes when a priority-1 arrival of LIFE_BIG tokens (64 new: 25
#: pages, more than the 23 free) comes; the watermark lets 17 of 40 pages
#: in use count as pressure
LIFE_POOL = 40
LIFE_BIG = 1500
LIFE_WATERMARK = 0.4
LIFE_HOST_MB = 512                 # the host tier of the swap-in run
LIFE_RESCORE_TOKENS = 512          # the re-score engine's token budget:
#                                    8 streams x 63 forced tokens
LIFE_HTTP_REPEATS = 5              # timed single requests, each way


def _life_counters(ops, qz, zero=False):
    fns = {"ragged_paged_attention": ops.ragged_paged_attention,
           "decode_paged_attention": ops.decode_paged_attention,
           "quant_pack_wire": qz.quant_pack_wire,
           "unpack_dequant_wire": qz.unpack_dequant_wire}
    if zero:
        for f in fns.values():
            f.launches = 0
    return {name: f.launches for name, f in fns.items()}


def _http(port, path, body=None, timeout=600):
    """One HTTP call to the local server → (status, headers, JSON body)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _wait_for(cond, timeout=60.0):
    """Poll ``cond`` until it holds or ``timeout`` passes → its last
    value."""
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


def _gated_step(sched, hold):
    """Replace ``sched.step`` (the server's driver calls it outside the
    scheduler's lock) with one that waits, at most 60 s, while
    ``hold()`` is true; ``del sched.step`` restores it."""
    step = sched.step

    def gated():
        _wait_for(lambda: not hold(), timeout=60)
        return step()
    sched.step = gated


class _DupResume:
    """The planted fault of the preemption check: a resumed request
    re-prefills ``prompt + produced`` (its last token twice in the KV)
    instead of ``prompt + produced[:-1]``."""

    @property
    def resume_prompt(self):
        if self._resume_seed is None:
            return self.prompt
        return self.prompt + self.produced


def _life_preempt_run(torch, lc, model, victim_prompt, big_prompt,
                      host_mb=0.0, fault=False, pressure=True):
    """The preemption scenario on a LIFE_POOL-page engine → (the victim's
    stream, counters, {uid: state})."""
    from deepspeed_tpu_torch import (InferenceEngineV2,
                                     RaggedInferenceEngineConfig)

    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        num_blocks=LIFE_POOL, host_tier_mb=host_mb), device=DEVICE)
    s = lc.LifecycleScheduler(eng, window_steps=LIFE_WINDOW,
                              kv_high_watermark=LIFE_WATERMARK)
    cls = lc.ServeRequest
    if fault:
        cls = type("DupResumeRequest", (_DupResume, lc.ServeRequest), {})
    s.submit(cls(uid=0, prompt=victim_prompt, max_new_tokens=LIFE_NEW,
                 priority=0))
    if pressure:
        while s.request(0).state != lc.RequestState.DECODE:
            s.step()
        s.step()                              # one decode window
        s.submit(lc.ServeRequest(uid=1, prompt=big_prompt,
                                 max_new_tokens=LIFE_NEW, priority=1))
    s.run_until_idle()
    torch.cuda.synchronize()
    free_ok = eng.state_manager.free_blocks == LIFE_POOL
    states = {u: s.request(u).state.value for u in s._reqs}
    out = ([int(t) for t in s.request(0).produced], dict(s.counters),
           states, free_ok)
    del s, eng
    _free(torch)
    return out


def phase_serving_lifecycle(torch, ops, model, prompts, gen_out, serving):
    """The lifecycle scheduler and its HTTP server on the llama3-8B serving
    model (bf16, page 64, the default engine unless named), the main
    path's 8 prompts and ``generate``'s streams (``gen_out``):

    1. ``LifecycleScheduler(window_steps=8).run_until_idle()`` on the 8
       prompts, 64 new tokens each (K6 and K7 must launch);
    2. KV-pressure preemption on a ``LIFE_POOL``-page engine: a
       priority-1 arrival preempts the priority-0 decode of the 1,024-token
       prompt, resumed once by recompute and once from a
       ``LIFE_HOST_MB`` MB host tier (``serving/swap_in`` >= 1); both
       resumed streams are held to the margin of their re-scores, and the
       swap-in stream's equality with the unpreempted stream is printed;
       a planted fault (the resume re-prefills ``prompt + produced``, its
       last token twice) is reported in units of the margin and must read
       above it (it read 4.42 x on the H100, short of
       ``SPEC_FAULT_FACTOR``, so that factor is not held);
    3. ``DSTPU_FAULT_INJECT`` ``decode_window``/``nan``: only the
       poisoned uid ends FAILED/nan, its batchmates finish, ``/healthz``'s
       state reads degraded;
    then ``ServingServer(port=0, bind="127.0.0.1")`` over a default engine:
    4. the 8 prompts posted at once from 8 client threads, blocking; one
       SSE stream whose events concatenate to its ``n_total``; every
       answer's ``ttft_s`` and ``tpot_s`` set;
    5. shedding: with ``max_queue`` 2 filled (the driver held back), a
       POST gets 429 with an integer ``Retry-After`` >= 1; once a clean
       window has run, ``predicted_tok_per_s()`` equals
       ``last_decode_roofline["decode_tok_per_s"]``;
    6. ``/v1/prefill`` on fp32 and int8, then ``/v1/generate`` with
       ``kv_import``, on the 128-token prompt (a body is capped at 64 MB,
       ~190 tokens of base64 fp32 rows): the fp32 continuation within
       the margin of the locally prefilled stream's re-score (the int8
       one, whose KV is lossy by design, printed beside it), the int8
       frame <= 0.3 x the fp32 frame's bytes, K9a and K10a launched,
       ``serving/kv_import_tokens`` the shipped count;
    7. a client that drops its SSE stream (the driver held back until the
       cancellation arrives): CANCELLED, the pool's pages back;
    8. ``drain_and_stop()`` finishes the request in flight, a POST during
       the drain gets 503, the summary's counts match;
    9. ``python -m deepspeed_tpu_torch.inference.v2.server --model tiny
       --port 0 --bind 127.0.0.1`` answers a POST and exits 0 on SIGTERM.
    Every emitted token of checks 1 and 4 (and ``gen_out``) lies within
    ``SPEC_MARGIN`` of a teacher-forced re-score's argmax
    (``spec_content_check``). → the phase's record (one JSON line)."""
    import http.client
    import signal
    import threading

    import numpy as np

    from deepspeed_tpu_torch import (InferenceEngineV2,
                                     RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2 import lifecycle as lc
    from deepspeed_tpu_torch.inference.v2.server import ServingServer
    from deepspeed_tpu_torch.ops.quantizer import quantizer as qz
    from deepspeed_tpu_torch.runtime.fault import injection

    t_phase = time.perf_counter()
    n = len(prompts)
    uids = list(range(n))
    counts0 = _life_counters(ops, qz)
    out = {}

    # 1. the scheduler in process against generate
    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(),
                            device=DEVICE)
    sched = lc.LifecycleScheduler(eng, window_steps=LIFE_WINDOW)
    windows, reports = [], []
    enqueue, record = eng.decode_batch_async, eng._record_decode_roofline

    def kept(*args, **kw):
        w = enqueue(*args, **kw)
        windows.append(w)
        return w

    def kept_report(w):
        record(w)
        reports.append(eng.last_decode_roofline)

    eng.decode_batch_async = kept
    eng._record_decode_roofline = kept_report
    for u, p in zip(uids, prompts):
        check(sched.submit(lc.ServeRequest(uid=u, prompt=p,
                                           max_new_tokens=LIFE_NEW)).admitted,
              f"uid {u} not admitted")
    c1 = _life_counters(ops, qz)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k = {name: v - c1[name] for name, v in _life_counters(ops, qz).items()}
    del eng.decode_batch_async, eng._record_decode_roofline
    check(k["ragged_paged_attention"] > 0 and k["decode_paged_attention"] > 0,
          f"the scheduler's run launched K6 {k['ragged_paged_attention']} "
          f"and K7 {k['decode_paged_attention']} times")
    sched_streams = [[int(t) for t in sched.request(u).produced]
                     for u in uids]
    check(all(sched.request(u).state == lc.RequestState.FINISHED
              and len(s) == LIFE_NEW for u, s in zip(uids, sched_streams)),
          "the scheduler's requests did not all finish with 64 tokens")
    clean = [w for w in windows if not w.compiled]
    win_tok = sum(w.n_seqs * w.steps for w in clean)
    win_s = sum(w.duration_s for w in clean)
    same = sum(a == b for s, g in zip(sched_streams, gen_out)
               for a, b in zip(s, g)) / sum(len(g) for g in gen_out)
    # the decode roofline of the widest clean windows (all 8 sequences,
    # LIFE_WINDOW steps): the median of each number over them
    wide = [r for r in reports if not r["compile_polluted"]
            and r["n_seqs"] == n and r["steps"] == LIFE_WINDOW]
    check(wide, f"no clean {n}-sequence {LIFE_WINDOW}-step window")
    roof = {key: _median([r[key] for r in wide])
            for key in ("decode_tok_per_s", "hbm_gbps", "hbm_pct_peak",
                        "window_s")}
    roof.update(windows=len(wide), n_seqs=n, steps=LIFE_WINDOW,
                peak_hbm_gbps=wide[0]["peak_hbm_gbps"],
                device_kind=wide[0]["device_kind"],
                kernels_pct_of_window_bytes={
                    name: row["pct_of_window_bytes"]
                    for name, row in wide[0]["kernels"].items()})
    out["scheduler"] = {
        "wall_s": wall, "windows": len(windows), "clean_windows": len(clean),
        "decode_tok_per_s": win_tok / win_s if win_s else None,
        "generate_decode_tok_per_s": serving["decode_tok_per_s"]["median"],
        "k6_launches": k["ragged_paged_attention"],
        "k7_launches": k["decode_paged_attention"],
        "tokens_equal_to_generate": same,
        "decode_roofline": roof}
    log(f"lifecycle scheduler: {n} requests x {LIFE_NEW} tokens in "
        f"{wall:.3f} s, {len(windows)} windows ({len(clean)} clean), decode "
        f"{out['scheduler']['decode_tok_per_s']:.1f} tok/s in the clean "
        f"windows (generate's median "
        f"{serving['decode_tok_per_s']['median']:.1f}); K6 "
        f"{k['ragged_paged_attention']}, K7 {k['decode_paged_attention']} "
        f"launches; tokens equal to generate's {same:.3f}; decode roofline "
        f"of the {len(wide)} clean {n} x {LIFE_WINDOW} windows (median): "
        f"{roof['decode_tok_per_s']:.1f} tok/s, HBM {roof['hbm_gbps']:.1f} "
        f"GB/s ({roof['hbm_pct_peak']:.1f}% of {roof['peak_hbm_gbps']:.0f}"
        f" GB/s); {CARD}")
    del sched, eng, windows, clean, reports
    _free(torch)

    # 2. KV-pressure preemption: recompute, swap-in, the planted fault
    rng = np.random.default_rng(SEED + 18)
    victim = prompts[-1]
    big = [int(t) for t in rng.integers(0, model.config.vocab_size,
                                        LIFE_BIG)]
    preempt = {}
    for name, kw in (("uninterrupted", {"pressure": False}),
                     ("recompute", {}), ("swap_in", {"host_mb": LIFE_HOST_MB}),
                     ("dup_resume", {"fault": True})):
        stream, counters, states, free_ok = _life_preempt_run(
            torch, lc, model, victim, big, **kw)
        preempt[name] = {"stream": stream, "counters": counters,
                         "states": states, "free_ok": free_ok}
        check(free_ok, f"preemption {name}: the pool's pages did not all "
                       f"come back")
        check(all(v == "finished" for v in states.values()),
              f"preemption {name}: states {states}")
        if name != "uninterrupted":
            check(counters.get("serving/preempted", 0) >= 1,
                  f"preemption {name}: no preemption ({counters})")
    check(preempt["swap_in"]["counters"].get("serving/swap_in", 0) >= 1,
          f"the host-tier run resumed without a swap-in "
          f"({preempt['swap_in']['counters']})")
    check(preempt["recompute"]["counters"].get("serving/swap_in", 0) == 0,
          "the recompute run swapped in")
    swap_same = preempt["swap_in"]["stream"] == \
        preempt["uninterrupted"]["stream"]
    margin, pcontent = spec_content_check(
        torch, model, [victim],
        {name: [preempt[name]["stream"]] for name in preempt},
        unheld=("dup_resume",))
    dup = pcontent["dup_resume"]["max_gap"] / margin["spec_margin"]
    check(dup > 1.0, f"the planted duplicate resume reads {dup:.2f} x "
                     f"SPEC_MARGIN: the content check cannot see it")
    out["preemption"] = {
        "pool_pages": LIFE_POOL, "watermark": LIFE_WATERMARK,
        "arrival_tokens": LIFE_BIG, "margin": margin, "content": pcontent,
        "swap_in_bit_identical_to_uninterrupted": swap_same,
        "counters": {name: r["counters"] for name, r in preempt.items()}}
    log(f"preemption: swap-in stream bit-identical to the uninterrupted "
        f"one: {swap_same}; recompute's tokens equal "
        f"{pcontent['recompute']['agree_with_first_run']:.3f}, swap-in's "
        f"{pcontent['swap_in']['agree_with_first_run']:.3f}; the planted "
        f"duplicate resume reads {dup:.2f} x SPEC_MARGIN (reported, not "
        f"held to {SPEC_FAULT_FACTOR} x: it read 4.42 x on an H100 80GB "
        f"HBM3 at 700 W)")

    # 3. NaN isolation through the port's injector
    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(),
                            device=DEVICE)
    sched = lc.LifecycleScheduler(eng, window_steps=LIFE_WINDOW)
    for u in range(3):
        sched.submit(lc.ServeRequest(uid=u, prompt=prompts[u],
                                     max_new_tokens=16))
    while any(sched.request(u).state != lc.RequestState.DECODE
              for u in range(3)):
        sched.step()
    os.environ[injection.ENV_VAR] = "site=decode_window,kind=nan,times=1"
    injection.clear()
    try:
        sched.run_until_idle()
    finally:
        os.environ.pop(injection.ENV_VAR, None)
        injection.clear()
    states = {u: (sched.request(u).state.value, sched.request(u).finish_reason)
              for u in range(3)}
    failed = [u for u, s in states.items() if s[0] == "failed"]
    health = sched.health_state()[0]
    check(len(failed) == 1 and states[failed[0]][1] == "nan"
          and sched.counters["serving/nan_isolated"] == 1,
          f"nan window: states {states}")
    check(all(s == ("finished", "length") for u, s in states.items()
              if u not in failed), f"nan window: batchmates {states}")
    check(health == "degraded", f"nan window: health {health}")
    check(eng.state_manager.free_blocks ==
          eng.state_manager.allocator.total_blocks,
          "nan window: pages not returned")
    out["nan_isolation"] = {"states": states, "health": health}
    log(f"nan window: uid {failed} FAILED/nan alone, health {health}")
    del sched, eng
    _free(torch)

    # 4-8 over HTTP
    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(),
                            device=DEVICE)
    sched = lc.LifecycleScheduler(eng, window_steps=LIFE_WINDOW)
    srv = ServingServer(sched, port=0, bind="127.0.0.1").start()
    port = srv.port
    try:
        # 4. concurrent blocking generates, one SSE stream
        answers = [None] * n

        def client(i):
            answers[i] = _http(port, "/v1/generate",
                               {"prompt": prompts[i],
                                "max_new_tokens": LIFE_NEW})

        threads = [threading.Thread(target=client, args=(i,)) for i in uids]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        http_wall = time.perf_counter() - t0
        for i, a in enumerate(answers):
            check(a is not None and a[0] == 200
                  and a[2]["state"] == "finished"
                  and len(a[2]["tokens"]) == LIFE_NEW,
                  f"HTTP generate {i}: {a and (a[0], a[2].get('state'))}")
            check(a[2]["ttft_s"] is not None and a[2]["tpot_s"] is not None,
                  f"HTTP generate {i}: ttft_s/tpot_s not set")
        http_streams = [a[2]["tokens"] for a in answers]
        ttft = sorted(a[2]["ttft_s"] for a in answers)
        tpot = sorted(a[2]["tpot_s"] for a in answers)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        conn.request("POST", "/v1/generate", body=json.dumps(
            {"prompt": prompts[0], "max_new_tokens": 16, "stream": True}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = resp.read().decode()
        conn.close()
        events = [json.loads(line[len("data: "):])
                  for line in body.splitlines() if line.startswith("data: ")]
        sse = [t for e in events for t in e["tokens"]]
        check(len(events) >= 2 and events[-1].get("state") == "finished"
              and len(sse) == events[-1]["n_total"] == 16,
              f"SSE: {len(events)} events, {len(sse)} tokens, n_total "
              f"{events[-1].get('n_total') if events else None}")
        out["sse"] = {"events": len(events),
                      "equal_to_blocking_prefix": sse == http_streams[0][:16]}

        # the HTTP cost of one request: a blocking POST against the same
        # request on a second scheduler in process, in turns
        single = {"prompt": prompts[0], "max_new_tokens": LIFE_WINDOW}
        http_s, local_s = [], []
        ieng = InferenceEngineV2(model, RaggedInferenceEngineConfig(),
                                 device=DEVICE)
        isched = lc.LifecycleScheduler(ieng, window_steps=LIFE_WINDOW)
        for i in range(LIFE_HTTP_REPEATS):
            t0 = time.perf_counter()
            _http(port, "/v1/generate", single)
            http_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            isched.submit(lc.ServeRequest(uid=i, prompt=prompts[0],
                                          max_new_tokens=LIFE_WINDOW))
            isched.run_until_idle()
            torch.cuda.synchronize()
            local_s.append(time.perf_counter() - t0)
        del isched, ieng

        # 5. shedding with max_queue 2 filled, then the drain rate
        sched.max_queue = 2
        hold = {"on": True}
        _gated_step(sched, lambda: hold["on"])
        queued = []
        qthreads = [threading.Thread(target=lambda i=i: queued.append(_http(
            port, "/v1/generate", {"prompt": prompts[i],
                                   "max_new_tokens": LIFE_WINDOW})))
            for i in (1, 2)]
        try:
            for t in qthreads:
                t.start()
            check(_wait_for(lambda: len(sched._waiting) == 2, 60),
                  "the queue did not fill")
            code, headers, shed = _http(port, "/v1/generate", single)
        finally:
            hold["on"] = False
            for t in qthreads:
                t.join(timeout=600)
            del sched.step
            sched.max_queue = 64
        retry = headers.get("Retry-After")
        check(code == 429 and shed["reason"] == "queue_full"
              and retry is not None and retry.isdigit() and int(retry) >= 1,
              f"shed: {code} {shed} Retry-After {retry}")
        check(len(queued) == 2 and all(q[0] == 200 for q in queued),
              "the queued requests did not finish")
        for _ in range(3):               # a clean window last
            r = eng.last_decode_roofline
            if r and not r["compile_polluted"]:
                break
            _http(port, "/v1/generate", single)
        r = eng.last_decode_roofline
        pred = sched.predicted_tok_per_s()
        check(r is not None and not r["compile_polluted"]
              and pred == r["decode_tok_per_s"]
              and pred != sched.fallback_tok_per_s,
              f"predicted_tok_per_s {pred} against the roofline's "
              f"{r and r['decode_tok_per_s']}")
        out["shedding"] = {"status": code, "retry_after": int(retry),
                           "predicted_tok_per_s": pred,
                           "roofline": r}

        # 6. /v1/prefill -> kv_import on both wires, on the 128-token
        # prompt: a /v1/generate body is capped at 64 MB (the JAX
        # server's ceiling), and base64 fp32 rows of llama3-8B take
        # 349,525 B a token, so ~190 tokens fit
        kp = prompts[0]
        counts = _life_counters(ops, qz)
        imported0 = sched.counters["serving/kv_import_tokens"]
        cont, frames = {}, {}
        for wire in ("fp32", "int8"):
            code, _, pre = _http(port, "/v1/prefill",
                                 {"prompt": kp[:-1], "wire": wire})
            check(code == 200 and pre["n_tokens"] == len(kp) - 1,
                  f"/v1/prefill {wire}: {code}")
            frames[wire] = len(pre["kv"])
            code, _, a = _http(port, "/v1/generate",
                               {"prompt": kp, "max_new_tokens": LIFE_NEW,
                                "kv_import": pre["kv"]})
            check(code == 200 and a["state"] == "finished",
                  f"kv_import {wire}: {code}")
            cont[wire] = a["tokens"]
        kd = {name: v - counts[name]
              for name, v in _life_counters(ops, qz).items()}
        check(kd["quant_pack_wire"] >= 1 and kd["unpack_dequant_wire"] >= 1,
              f"the int8 wire launched K9a {kd['quant_pack_wire']} and K10a "
              f"{kd['unpack_dequant_wire']} times")
        check(frames["int8"] <= 0.3 * frames["fp32"],
              f"int8 frame {frames['int8']} B > 0.3 x fp32's "
              f"{frames['fp32']} B")
        shipped = sched.counters["serving/kv_import_tokens"] - imported0
        check(shipped == 2 * (len(kp) - 1),
              f"serving/kv_import_tokens rose by {shipped}, not "
              f"{2 * (len(kp) - 1)}")
        local = http_streams[0]
        dmargin, dcontent = spec_content_check(
            torch, model, [kp], {"local": [local],
                                 "import_fp32": [cont["fp32"]],
                                 "import_int8": [cont["int8"]]},
            unheld=("import_int8",))
        out["kv_import"] = {"frame_b64_bytes": frames,
                            "k9a_launches": kd["quant_pack_wire"],
                            "k10a_launches": kd["unpack_dequant_wire"],
                            "kv_import_tokens": shipped,
                            "margin": dmargin, "content": dcontent}

        # 7. client disconnect, with the driver held until the cancel
        total = eng.state_manager.allocator.total_blocks
        req0 = sched.counters["serving/requests"]
        watch = {"uid": None}

        def holding():
            u = watch["uid"]
            r_ = sched.request(u) if u is not None else None
            return (r_ is not None and bool(r_.produced)
                    and u not in sched._cancel_requested
                    and r_.state not in lc.TERMINAL_STATES)

        _gated_step(sched, holding)
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
            conn.request("POST", "/v1/generate", body=json.dumps(
                {"prompt": prompts[2], "max_new_tokens": 512,
                 "stream": True}),
                headers={"Content-Type": "application/json"})
            check(_wait_for(lambda: sched.counters["serving/requests"]
                            > req0), "the streaming request never arrived")
            watch["uid"] = uid = max(sched._reqs)
            resp = conn.getresponse()
            resp.read(32)                # its first event arrived
            resp.close()
            conn.close()
            cancelled = _wait_for(lambda: sched.request(uid).state ==
                                  lc.RequestState.CANCELLED, 60)
        finally:
            del sched.step
        freed = _wait_for(lambda: eng.state_manager.free_blocks == total, 60)
        check(cancelled and freed,
              f"disconnect: state {sched.request(uid).state}, free "
              f"{eng.state_manager.free_blocks} of {total}")
        out["disconnect"] = {"produced_before_cancel":
                             len(sched.request(uid).produced)}

        # 8. drain: the request in flight finishes, a POST gets 503
        results = []
        req0 = sched.counters["serving/requests"]
        done0 = sched.counters["serving/completed"]
        t = threading.Thread(target=lambda: results.append(_http(
            port, "/v1/generate", {"prompt": prompts[1],
                                   "max_new_tokens": LIFE_NEW})))
        t.start()
        check(_wait_for(lambda: sched.counters["serving/requests"] > req0),
              "the drain's request never arrived")
        sched.start_drain()
        code, headers, refused = _http(port, "/v1/generate", single)
        check(code == 503 and refused["reason"] == "draining",
              f"POST during the drain: {code} {refused}")
        done1 = sched.counters["serving/completed"]
        summary = srv.drain_and_stop(deadline_s=120)
        t.join(timeout=120)
        check(len(results) == 1 and results[0][0] == 200
              and len(results[0][2]["tokens"]) == LIFE_NEW,
              "the request in flight did not finish")
        check(summary == {"completed": sched.counters["serving/completed"]
                          - done1, "expired": 0}
              and sched.counters["serving/completed"] - done0 == 1,
              f"drain summary {summary}")
        out["drain"] = summary
    finally:
        srv.stop()
    del sched, eng
    _free(torch)

    # 1 and 4: every stream against its re-score
    margin, content = spec_content_check(
        torch, model, prompts, {"generate": gen_out,
                                "scheduler": sched_streams,
                                "http": http_streams},
        max_tokens=LIFE_RESCORE_TOKENS)
    out["content"] = {"margin": margin, "runs": content}

    # 9. the command line
    cmd = [sys.executable, "-m", "deepspeed_tpu_torch.inference.v2.server",
           "--model", "tiny", "--port", "0", "--bind", "127.0.0.1"]
    if DEVICE != "cuda":
        cmd += ["--device", DEVICE]
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            env=dict(os.environ, PYTHONPATH=root))
    try:
        cport = None
        for line in proc.stdout:
            if "listening on http://" in line:
                cport = int(line.rsplit(":", 1)[1])
                break
        check(cport is not None, "the CLI server printed no listening line")
        code, _, a = _http(cport, "/v1/generate",
                           {"prompt": [3, 5, 7, 11], "max_new_tokens": 8})
        check(code == 200 and len(a["tokens"]) == 8, f"CLI POST: {code}")
        t_term = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"the CLI server exited {rc} on SIGTERM")
        out["cli"] = {"start_to_exit_s": time.perf_counter() - t0,
                      "sigterm_to_exit_s": time.perf_counter() - t_term}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    out["launches"] = {name: v - counts0[name]
                       for name, v in _life_counters(ops, qz).items()}
    out["summary"] = {
        "ttft_s": {"p50": ttft[len(ttft) // 2],
                   "p95": ttft[min(len(ttft) - 1,
                                   math.ceil(0.95 * len(ttft)) - 1)]},
        "tpot_s": {"p50": tpot[len(tpot) // 2], "max": tpot[-1]},
        "http_8_clients_wall_s": http_wall,
        "scheduler_decode_tok_per_s": out["scheduler"]["decode_tok_per_s"],
        "generate_decode_tok_per_s":
            serving["decode_tok_per_s"]["median"],
        "http_request_s": _median(http_s),
        "in_process_request_s": _median(local_s),
        "http_request_runs_s": http_s, "in_process_request_runs_s": local_s,
        "http_cost_s": _median(http_s) - _median(local_s),
        "launches": out["launches"],
        "decode_roofline": {
            key: roof[key] for key in ("decode_tok_per_s", "hbm_gbps",
                                       "hbm_pct_peak", "n_seqs", "steps",
                                       "windows")},
        "card": CARD}
    out["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"serving_lifecycle_summary": out["summary"],
                    "phase_s": out["phase_s"]}))
    log(f"serving lifecycle: {out['phase_s']:.1f} s; {CARD}")
    return out


def family_model(torch, arch, layers=None):
    """A universal-family model at the published widths of ``arch``
    (depth cut to ``layers`` if given), random bf16 weights from the
    seeded generator, on the card."""
    from deepspeed_tpu_torch.models.families import (ArchConfig,
                                                     UniversalCausalLM,
                                                     init_universal_params)

    cfg = ArchConfig(**dict(arch, **({} if layers is None
                                     else {"num_layers": layers})))
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    return UniversalCausalLM(cfg, init_universal_params(
        cfg, gen, torch.bfloat16, DEVICE))


def family_serving(torch, ops, name, arch, layers=None, spec=False):
    """One family through the serving path: ``generate`` on 8 prompts of
    128-1024 tokens, ``FAMILY_NEW`` new tokens each (one untimed run, then
    ``REPEATS`` timed: K6's and K7's counters must rise in each), paged vs
    gather on one batch, and with ``spec`` ``speculative_decode`` with
    ``NGramDrafter`` under the content check. No planted fault here:
    random-weight Bloom's greedy stream repeats (the n-gram drafter's
    drafts are all accepted) and does not move when rejected rows stay
    in the context, so a skipped rollback reads every gap 0; the
    margin's cap is this check's ceiling."""
    import numpy as np

    from deepspeed_tpu_torch import (InferenceEngineV2,
                                     RaggedInferenceEngineConfig)
    from deepspeed_tpu_torch.inference.v2.speculative import NGramDrafter

    t_phase = time.perf_counter()
    model = family_model(torch, arch, layers)
    cfg = model.config
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    rng = np.random.default_rng(SEED)
    prompt_lens = [128, 256, 384, 512, 640, 768, 896, 1024]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in prompt_lens]
    engine_kw = dict(max_seqs=FAMILY_MAX_SEQS)
    engine = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        **engine_kw), device=DEVICE)
    pool_bytes = engine.kv.mem_bytes()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    log(f"{name}: {cfg.num_layers} layers, hidden {cfg.hidden_size}, "
        f"{cfg.num_heads} heads on {cfg.num_kv_heads} KV heads (hd "
        f"{cfg.head_dim}), vocab {cfg.vocab_size}, pos {cfg.pos}; "
        f"{model.num_params() / 1e9:.3f} B params: weights "
        f"{weight_bytes / 1e9:.2f} GB + KV pool {pool_bytes / 1e9:.2f} GB "
        f"({engine.kv.config.num_blocks} blocks of "
        f"{engine.config.block_size}, max_seqs {FAMILY_MAX_SEQS}) of "
        f"{card_bytes / 1e9:.1f} GB; {CARD}")
    check(weight_bytes + pool_bytes < 0.6 * card_bytes,
          f"{name}: weights and pool fill the card")
    log(f"{name} warm-up (untimed):")
    first_out, launches, first = _run_generate(
        torch, ops, engine, prompts, FAMILY_NEW, cfg.vocab_size)
    runs = []
    for i in range(REPEATS):
        log(f"{name} timed run {i + 1}/{REPEATS}:")
        _, n, r = _run_generate(torch, ops, engine, prompts, FAMILY_NEW,
                                cfg.vocab_size)
        check(n == launches, f"{name}: launch counts changed between runs")
        runs.append(r)
    del engine
    _free(torch)
    out = {k: {"median": _median([r[k] for r in runs]),
               "min": min(r[k] for r in runs),
               "max": max(r[k] for r in runs)}
           for k in ("generate_s", "prefill_tok_per_s", "decode_tok_per_s")}
    out.update(layers=cfg.num_layers, params=model.num_params(),
               weight_bytes=weight_bytes, pool_bytes=pool_bytes,
               launches_per_generate=launches, first_run=first)
    log(f"{name} median of {REPEATS}: prefill "
        f"{out['prefill_tok_per_s']['median']:.1f} tok/s "
        f"[{out['prefill_tok_per_s']['min']:.1f}, "
        f"{out['prefill_tok_per_s']['max']:.1f}], decode "
        f"{out['decode_tok_per_s']['median']:.1f} tok/s "
        f"[{out['decode_tok_per_s']['min']:.1f}, "
        f"{out['decode_tok_per_s']['max']:.1f}]; {CARD}")
    out["paged_vs_gather"] = paged_vs_gather(
        torch, model, [prompts[1][:100], prompts[2][:120], prompts[3][:36]],
        name, **engine_kw)
    if spec:
        uids = list(range(len(prompts)))
        eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            **engine_kw), device=DEVICE)
        seeds = [int(t) for t in
                 spec_prefill(eng, uids, prompts).argmax(-1)]
        streams, rec = spec_run(torch, ops, eng, NGramDrafter(), uids,
                                prompts, seeds, FAMILY_SPEC_NEW - 1)
        eng.flush(uids)
        del eng
        _free(torch)
        log(f"{name} speculative ngram: {rec['windows']} windows, "
            f"acceptance {rec['acceptance_rate']:.3f}, K6 "
            f"{rec['k6_launches_per_window']:.0f} a window, per-user "
            f"{rec['per_user_tok_s']:.1f} tok/s; {CARD}")
        margin, content = spec_content_check(
            torch, model, prompts, {"ngram": streams}, **engine_kw)
        out["speculative"] = {"timing": rec, "content": content,
                              "margin": margin}
    del model
    _free(torch)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"{name}: {out['phase_s']:.1f} s; {CARD}")
    return out


def phase_families(torch, ops):
    """Bloom-7b1 at its published widths and depth (K6/K7's ALiBi on a
    model path) and Falcon-7b at its published widths, depth cut to
    ``FALCON_LAYERS`` (K6/K7's G = 71), through ``family_serving``."""
    return {"bloom_7b1": family_serving(torch, ops, "bloom_7b1", BLOOM_7B1,
                                        spec=True),
            "falcon_7b": family_serving(torch, ops, "falcon_7b", FALCON_7B,
                                        layers=FALCON_LAYERS)}


def paged_vs_gather(torch, model, batch, tag, **engine_kw):
    """One ``put`` of ``batch`` with ``attn_impl="paged"`` and one with
    ``"gather"``, fresh engines on the same weights: finite logits within
    ``SERVING_LOGITS_REL`` (bf16 activations through every layer's
    residual stream: the two attention paths round at different
    places). → their relative l2 error."""
    from deepspeed_tpu_torch import (InferenceEngineV2,
                                     RaggedInferenceEngineConfig)

    vocab = model.config.vocab_size
    uids = list(range(len(batch)))
    logits = {}
    for impl in ("paged", "gather"):
        eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
            attn_impl=impl, **engine_kw), device=DEVICE)
        logits[impl] = eng.put(uids, batch)
        check(tuple(logits[impl].shape) == (len(batch), vocab),
              f"{tag} put({impl}) logits shape "
              f"{tuple(logits[impl].shape)}")
        check(bool(torch.isfinite(logits[impl]).all()),
              f"{tag} put({impl}) logits not finite")
        del eng
        torch.cuda.empty_cache()
    diff = logits["paged"] - logits["gather"]
    rel = float(diff.norm() / logits["gather"].norm())
    agree = float((logits["paged"].argmax(-1) ==
                   logits["gather"].argmax(-1)).float().mean())
    log(f"{tag} paged vs gather put: rel l2 err {rel:.3e} (tol "
        f"{SERVING_LOGITS_REL}), max abs {float(diff.abs().max()):.3e}, "
        f"argmax agree {agree:.2f}")
    check(rel <= SERVING_LOGITS_REL,
          f"{tag} paged vs gather logits differ: rel {rel}")
    torch.cuda.synchronize()
    return rel


# --------------------------------------------------------------------- #
# MoE serving (ROADMAP M7.9)
# --------------------------------------------------------------------- #
#: mistralai/Mixtral-8x7B-v0.1 config.json (``TransformerConfig.
#: mixtral_8x7b``): hidden 4096, intermediate 14336, 32 layers, 32 heads
#: on 8 KV heads (head dim 128), vocab 32000, 8 local experts, 2 a token,
#: rope_theta 1e6. Depth cut to MIXTRAL_LAYERS: the whole model is 93.4 GB
#: in bf16, more than the card's 80 GB; 16 layers are 46.97 GB
MIXTRAL_LAYERS = 16
MOE_NEW = 64                       # generate's new tokens a prompt
MOE_MAX_SEQS = 8
MOE_ROUTE_TOKENS = 64              # the routing check's flat batch
MOE_ROUTE_PAD = 8                  # of which padding, the last rows
MOE_ROUTE_CFS = (2.0, 0.5)         # the engine's default; one that drops
#: the routing check's gate values: the card's float32 softmax (CUDA's
#: expf) and the CPU's (SLEEF's) may round an exp one ulp apart and sum
#: eight of them in another order, so the renormalised top-k values may
#: sit a few float32 ulps apart; slots, capacity and counts must be equal
MOE_GATE_ULPS = 16
#: the routed block in bf16 against its float32 run on the CPU from the
#: card's slots and gate values: the output roundings, 2**-8 of |got| +
#: |ref| + sum_c |g_c eo_c|, plus MOE_SIGMAS x 2**-8 x sqrt(sum_c g_c**2
#: (a_c**2 @ W_c**2)): the bf16 roundings of the gate and up products,
#: SiLU and their product a (a few 2**-9 of each term) carried through
#: the down projection's F-long sums (a_c: token's SwiGLU row of its
#: choice c, W_c that expert's down projection)
MOE_SIGMAS = 16.0
MOE_LIMIT = ("2**-8 x (|got| + |ref| + sum_c |g_c eo_c|) + "
             f"{MOE_SIGMAS:g} x 2**-8 x sqrt(sum_c g_c**2 (a_c**2 @ "
             "W_c**2))")


class GateRecorder:
    """``moe.sharded_moe.topkgating_sparse`` wrapped while in use
    (``moe_mlp_block`` looks it up at each call): every call's output, and
    on the device without a sync the real tokens' assignments and drops
    under the current ``label``. With ``forced`` (another run's outputs,
    call by call) each call returns the forced output instead, after
    counting the assignments its own gate would route to another expert
    (or drop in one run only)."""

    def __init__(self, forced=None):
        self.label = None
        self.outputs = []
        self.assigned = {}
        self.dropped = {}
        self.forced = forced
        self.flip_calls = self.flips = 0

    def __enter__(self):
        from deepspeed_tpu_torch.moe import sharded_moe

        self._module = sharded_moe
        self._gate = gate = sharded_moe.topkgating_sparse

        def recording(logits, *args, valid=None, **kw):
            out = gate(logits, *args, valid=valid, **kw)
            if self.forced is not None:
                f = self.forced[len(self.outputs)]
                # a slot's position in its expert does not change the
                # output: compare experts, E standing for a drop
                n = int((out.slot // out.capacity
                         != f.slot // f.capacity).sum())
                self.flip_calls += n > 0
                self.flips += n
                out = f
            self.outputs.append(out)
            trash = out.slot == logits.shape[1] * out.capacity
            for tally, n in ((self.assigned, valid.sum() * out.slot.shape[1]),
                             (self.dropped, (trash & valid[:, None]).sum())):
                tally[self.label] = tally.get(self.label, 0) + n
            return out

        sharded_moe.topkgating_sparse = recording
        return self

    def __exit__(self, *exc):
        self._module.topkgating_sparse = self._gate


def record_schedule(eng, gates):
    """Wrap ``eng.put`` and ``eng.decode_batch_async`` (instance
    attributes, which ``generate``'s batcher calls) → the list of the
    forwards they run in order: ``("put", uids, chunks, logits)`` and
    ``("window", uids, seeds, steps, DecodeWindow)``; ``gates.label``
    follows. ``del eng.put, eng.decode_batch_async`` restores them."""
    events = []
    put, window = eng.put, eng.decode_batch_async

    def rec_put(uids, chunks):
        gates.label = "put"
        logits = put(uids, chunks)
        events.append(("put", list(uids), [[int(t) for t in c]
                                           for c in chunks], logits))
        return logits

    def rec_window(uids, seeds, steps, *args, **kw):
        gates.label = "window"
        w = window(uids, seeds, steps, *args, **kw)
        events.append(("window", list(uids), [int(t) for t in seeds], steps,
                       w))
        return w

    eng.put, eng.decode_batch_async = rec_put, rec_window
    return events


def moe_replay(torch, model, events, attn_impl):
    """Teacher-force ``generate``'s recorded schedule on a fresh engine in
    the same batches: each put as it was, each decode window's step as one
    ``verify_mode`` forward of the window's rows in its order and seq
    bucket (K6 where the window ran K7). Routing depends on the batch
    (capacity counts its padded length; earlier tokens take capacity
    first), so the re-score keeps the batches. → (logits rows ``[V]``,
    the token each row emitted, its uid), one row per sequence and
    forward."""
    from deepspeed_tpu_torch import (InferenceEngineV2,
                                     RaggedInferenceEngineConfig)

    eng = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        attn_impl=attn_impl, max_seqs=MOE_MAX_SEQS), device=DEVICE)
    rows, emitted, owners = [], [], []
    for ev in events:
        if ev[0] == "put":
            _, uids, chunks, logits = ev
            rows += list(eng.put(uids, chunks))
            emitted += [int(t) for t in logits.argmax(-1)]
            owners += uids
            continue
        _, uids, seeds, steps, window = ev
        toks = window.tokens()
        s_b = eng._seq_bucket(len(uids))
        prev = seeds
        for s in range(steps):
            rows += list(forced_logits(torch, eng, uids,
                                       [[t] for t in prev], (s_b, s_b)))
            prev = [int(t) for t in toks[s]]
            emitted += prev
            owners += uids
    eng.flush(sorted(set(owners)))
    del eng
    _free(torch)
    return torch.stack(rows), emitted, owners


def moe_undropped_gate(torch, logits, k, cf, valid):
    """A planted fault: ``topkgating_sparse`` with the drop mask left out,
    so an assignment past capacity keeps slot ``idx*C + pos`` and lands in
    the next expert's rows (the last expert's overflow in the trash row).
    → (slots, gate values)."""
    from deepspeed_tpu_torch.moe import sharded_moe as sm

    S, E = logits.shape
    C = sm._capacity(S * k, E, cf, 4)
    vals, idx = sm._top_k(torch.softmax(logits, 1), k)
    vals = vals / vals.sum(1, keepdim=True)
    counts = torch.zeros(E)
    slots, gv = [], []
    for c in range(k):
        mask = sm._one_hot(idx[:, c], E) * valid.float()[:, None]
        pos = torch.cumsum(mask, 0) - mask + counts
        counts = counts + mask.sum(0)
        slot = idx[:, c] * C + (pos * mask).sum(1).long()
        kept = valid & (slot < E * C)
        slots.append(torch.where(kept, slot, E * C))
        gv.append(torch.where(kept, vals[:, c], 0.0))
    return torch.stack(slots, 1).int(), torch.stack(gv, 1)


def moe_routing_check(torch, model, cf):
    """Layer 0 of the served model at full width on 64 flat tokens, the
    last 8 padding: the card's gate (router product, softmax, stable top-k,
    capacity) against the CPU's on the same logits, also with planted
    ties; the card's bf16 block against its float32 CPU run from the
    card's slots within ``MOE_LIMIT``; the undropped-gate fault read
    against the same limit. → numbers."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.moe import sharded_moe as sm

    lw = model.layers
    lp = {n: {"kernel": getattr(lw, n).kernel[0]}
          for n in ("router", "gate_proj", "up_proj", "down_proj")}
    E = lp["router"]["kernel"].shape[1]
    T, D = MOE_ROUTE_TOKENS, lp["router"]["kernel"].shape[0]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 19)
    h = torch.randn(T, D, generator=gen, device=DEVICE).to(torch.bfloat16)
    valid = torch.arange(T, device=DEVICE) < T - MOE_ROUTE_PAD
    logits = sm._f32_matmul(h, lp["router"]["kernel"])
    tied = logits.clone()
    tied[:3] = torch.tensor([[0.0] * 8, [0, 1, 1, .5, 0, 0, 0, 0],
                             [2, 1, 0, 1, 1, 0, 0, 0]], device=DEVICE)[:, :E]
    out = {"capacity_factor": cf}
    for tag, lg in (("router logits", logits), ("planted ties", tied)):
        card = sm.topkgating_sparse(lg, 2, cf, valid=valid)
        cpu = sm.topkgating_sparse(lg.cpu(), 2, cf, valid=valid.cpu())
        ulps = _ulps(torch, card.gate_val.cpu(), cpu.gate_val)
        check(card.capacity == cpu.capacity
              and torch.equal(card.slot.cpu(), cpu.slot)
              and torch.equal(card.exp_counts.cpu(), cpu.exp_counts),
              f"MoE gate at cf {cf} ({tag}): the card's slots or counts "
              f"differ from the CPU's")
        check(ulps <= MOE_GATE_ULPS,
              f"MoE gate at cf {cf} ({tag}): gate values {ulps} float32 "
              f"ulps from the CPU's (> {MOE_GATE_ULPS})")
        out[f"gate_value_ulps ({tag})"] = ulps
    C = card.capacity
    gate = sm.topkgating_sparse(logits, 2, cf, valid=valid)
    dropped = int(((gate.slot == E * C) & valid[:, None]).sum())
    got, _ = sm.moe_mlp_block(lp, h, k=2, capacity_factor=cf, valid=valid)

    W = {n: lp[n]["kernel"].cpu().float()
         for n in ("gate_proj", "up_proj", "down_proj")}
    hc = h.cpu().float()

    def block_f32(slot, gv):
        disp = sm.dispatch_sparse(slot, hc, E, C, torch.float32)
        a = F.silu(torch.bmm(disp, W["gate_proj"])) * \
            torch.bmm(disp, W["up_proj"])
        eo = torch.bmm(a, W["down_proj"])
        return sm.combine_sparse(slot, gv, eo, torch.float32), a, eo

    slot, gv = gate.slot.cpu(), gate.gate_val.cpu()
    ref, a, eo = block_f32(slot, gv)
    spread = sm.combine_sparse(slot, gv.square(), torch.bmm(
        a.square(), W["down_proj"].square()), torch.float32).sqrt()
    terms = sm.combine_sparse(slot, gv.abs(), eo.abs(), torch.float32)
    gotc = got.float().cpu()
    limit = (2.0 ** -8 * (gotc.abs() + ref.abs() + terms)
             + MOE_SIGMAS * 2.0 ** -8 * spread).clamp_min(
                 torch.finfo(torch.float32).tiny)
    worst = float(((gotc - ref).abs() / limit).max())
    fslot, fgv = moe_undropped_gate(torch, logits.cpu(), 2, cf, valid.cpu())
    ferr = (block_f32(fslot, fgv)[0] - ref).abs()
    # where both of a token's assignments were dropped the output is 0
    # and so is its limit: the fault's reading there is infinite, so it
    # is read on the other entries and those rows are counted
    live = limit > torch.finfo(torch.float32).tiny
    fault = float((ferr / limit)[live].max())
    filled = int(((ferr > 0) & ~live).any(1).sum())
    out.update(capacity=C, dropped=dropped,
               assignments=2 * (T - MOE_ROUTE_PAD),
               block_max_abs_err=float((gotc - ref).abs().max()),
               block_err_over_limit=worst, fault_over_limit=fault,
               fault_filled_zero_rows=filled, limit=MOE_LIMIT)
    log(f"MoE routing at cf {cf}: C {C}, {dropped} of "
        f"{out['assignments']} assignments dropped; gates equal to the "
        f"CPU's (values within {out['gate_value_ulps (router logits)']:.0f}"
        f" and {out['gate_value_ulps (planted ties)']:.0f} ulps with "
        f"planted ties); block max abs err {out['block_max_abs_err']:.3e}, "
        f"{worst:.3f} x the limit; planted fault (drop mask left out) "
        f"{fault:.1f} x the limit, and {filled} all-dropped rows filled")
    check(worst <= 1.0, f"MoE block at cf {cf}: {worst:.3f} x the limit "
                        f"({MOE_LIMIT})")
    if dropped:
        check(fault > 1.0 or filled,
              f"MoE block at cf {cf}: the limit would pass a planted fault "
              f"(drop mask left out, {fault:.3f} x)")
    del W, hc, a, eo, got
    return out


def phase_moe_serving(torch, ops):
    """Mixtral-8x7B widths, ``MIXTRAL_LAYERS`` of 32 layers, random bf16
    weights from the seed with the router float32, served by the default
    engine (cf 2.0, page 64, max_ctx 2048, ``MOE_MAX_SEQS``): the routing
    check at cf 2.0 and 0.5 (``moe_routing_check``), ``generate`` on 8
    prompts of 128-1024 tokens, ``MOE_NEW`` new tokens each (one untimed
    run with the schedule and the gates recorded, then ``REPEATS`` timed:
    K6 and K7 must launch), dropped assignments per put and per decode
    step, the decode roofline of the timed windows, and every emitted
    token within ``SPEC_MARGIN`` of the argmax of a teacher-forced
    re-score in the same batches (``moe_replay``; the margin from the
    paged and gather re-scores, as ``spec_content_check`` sets it)."""
    import numpy as np

    from deepspeed_tpu_torch import (CausalLM, InferenceEngineV2,
                                     RaggedInferenceEngineConfig,
                                     TransformerConfig)
    from deepspeed_tpu_torch.models.transformer import (init_params,
                                                        param_shapes)

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(TransformerConfig.mixtral_8x7b(),
                              num_layers=MIXTRAL_LAYERS)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    model = CausalLM(cfg, init_params(cfg, gen, torch.bfloat16, DEVICE))
    torch.cuda.synchronize()
    shapes = param_shapes(cfg)
    per_layer = {n: math.prod(s[1:]) for n, s in shapes.items()
                 if n.startswith("layers.")}
    experts = sum(v for n, v in per_layer.items() if "_proj" in n
                  and len(shapes[n]) == 4)
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    log(f"mixtral_8x7b: {cfg.num_layers} of 32 layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_experts} experts top-"
        f"{cfg.moe_top_k} of FFN {cfg.intermediate_size}, {cfg.num_heads} "
        f"heads on {cfg.num_kv_heads} KV heads, vocab {cfg.vocab_size}; a "
        f"layer {sum(per_layer.values()) / 1e6:.1f} M params ({experts / 1e6:.1f}"
        f" M of experts), embedding and head "
        f"{2 * cfg.vocab_size * cfg.hidden_size / 1e6:.1f} M; weights "
        f"{weight_bytes / 1e9:.2f} GB (router "
        f"{model.layers.router.kernel.dtype}) of {card_bytes / 1e9:.1f} GB; "
        f"{CARD}")
    check(model.layers.router.kernel.dtype == torch.float32,
          "the MoE router is not float32")
    routing = [moe_routing_check(torch, model, cf) for cf in MOE_ROUTE_CFS]
    check(routing[-1]["dropped"] > 0,
          f"the routing check at cf {MOE_ROUTE_CFS[-1]} dropped nothing: "
          f"its planted fault cannot show")

    rng = np.random.default_rng(SEED)
    prompt_lens = [128, 256, 384, 512, 640, 768, 896, 1024]
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in prompt_lens]
    engine = InferenceEngineV2(model, RaggedInferenceEngineConfig(
        max_seqs=MOE_MAX_SEQS), device=DEVICE)
    check(model.layers.router.kernel.dtype == torch.float32,
          "the engine cast the MoE router")
    pool_bytes = engine.kv.mem_bytes()
    log(f"MoE engine: cf {cfg.moe_capacity_factor}, KV pool "
        f"{pool_bytes / 1e9:.2f} GB ({engine.kv.config.num_blocks} blocks "
        f"of {engine.config.block_size}); weights as counted "
        f"{engine._param_bytes / 1e9:.3f} GB")
    log("MoE warm-up (untimed; schedule and gates recorded):")
    with GateRecorder() as gates:
        events = record_schedule(engine, gates)
        first_out, launches, first = _run_generate(
            torch, ops, engine, prompts, MOE_NEW, cfg.vocab_size)
        del engine.put, engine.decode_batch_async
    n_puts = sum(ev[0] == "put" for ev in events)
    n_steps = sum(ev[3] for ev in events if ev[0] == "window")
    dropped = {k: int(v) for k, v in gates.dropped.items()}
    assigned = {k: int(v) for k, v in gates.assigned.items()}
    drops = {"put_forwards": n_puts, "decode_steps": n_steps,
             "per_put": dropped.get("put", 0) / max(n_puts, 1),
             "per_decode_step": dropped.get("window", 0) / max(n_steps, 1),
             "share_put": dropped.get("put", 0) / max(assigned.get("put", 0),
                                                      1),
             "share_decode": dropped.get("window", 0) / max(
                 assigned.get("window", 0), 1),
             "layers": cfg.num_layers}
    log(f"MoE dropped assignments (all {cfg.num_layers} layers): "
        f"{drops['per_put']:.2f} a put ({n_puts} puts; "
        f"{100 * drops['share_put']:.2f}% of their real tokens' "
        f"assignments), {drops['per_decode_step']:.2f} a decode step "
        f"({n_steps} steps; {100 * drops['share_decode']:.2f}%)")

    reports = []
    record = engine._record_decode_roofline

    def keep(window):
        record(window)
        reports.append(engine.last_decode_roofline)

    engine._record_decode_roofline = keep
    runs, same = [], True
    for i in range(REPEATS):
        log(f"MoE timed run {i + 1}/{REPEATS}:")
        out, n, r = _run_generate(torch, ops, engine, prompts, MOE_NEW,
                                  cfg.vocab_size)
        check(n == launches, "MoE: launch counts changed between runs")
        runs.append(r)
        same = same and out == first_out
    del engine._record_decode_roofline
    profiled = moe_decode_profile(torch, engine, prompts)
    del engine
    _free(torch)
    clean = [r for r in reports
             if r is not None and not r["compile_polluted"]]
    big = max(r["steps"] for r in clean)
    roof = [r["hbm_pct_peak"] for r in clean if r["steps"] == big]
    res = {k: {"median": _median([r[k] for r in runs]),
               "min": min(r[k] for r in runs),
               "max": max(r[k] for r in runs)}
           for k in ("generate_s", "prefill_tok_per_s", "decode_tok_per_s")}
    res.update(layers=cfg.num_layers, params=model.num_params(),
               weight_bytes=weight_bytes, pool_bytes=pool_bytes,
               launches_per_generate=launches, first_run=first,
               timed_tokens_equal_warmup=same, drops=drops, routing=routing,
               decode_profile=profiled,
               decode_roofline={
                   "windows": len(clean), "largest_steps": big,
                   "n_seqs": clean[-1]["n_seqs"],
                   "hbm_pct_peak_median": _median(roof),
                   "hbm_pct_peak_min": min(roof),
                   "hbm_pct_peak_max": max(roof),
                   "param_bytes_share": clean[-1]["kernels"]["param_stream"][
                       "pct_of_window_bytes"]})
    log(f"MoE median of {REPEATS}: prefill "
        f"{res['prefill_tok_per_s']['median']:.1f} tok/s "
        f"[{res['prefill_tok_per_s']['min']:.1f}, "
        f"{res['prefill_tok_per_s']['max']:.1f}], decode "
        f"{res['decode_tok_per_s']['median']:.1f} tok/s "
        f"[{res['decode_tok_per_s']['min']:.1f}, "
        f"{res['decode_tok_per_s']['max']:.1f}]; K6 {launches['ragged_paged_attention']}"
        f" and K7 {launches['decode_paged_attention']} launches a generate; "
        f"decode roofline of the {len(roof)} {big}-step windows "
        f"{_median(roof):.1f}% of {HBM_BYTES_PER_S / 1e12:.2f} TB/s "
        f"[{min(roof):.1f}, {max(roof):.1f}]; timed tokens equal to the "
        f"warm-up's: {same}; {CARD}")

    res["content"] = moe_content_check(torch, model, events, gates.outputs)
    del model, events, gates
    _free(torch)
    res["phase_s"] = time.perf_counter() - t_phase
    log(f"MoE serving: {res['phase_s']:.1f} s; {CARD}")
    return res


def moe_decode_profile(torch, eng, prompts):
    """One decode window of the prompts, 8 steps a sequence, under
    ``torch.profiler``: device time by kernel group and the device's
    idle share (``device_breakdown``)."""
    from torch.profiler import ProfilerActivity, profile

    uids = list(range(len(prompts)))
    seeds = [int(t) for t in spec_prefill(eng, uids, prompts).argmax(-1)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decode_batch(uids, seeds, 8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.flush(uids)
    return device_breakdown(prof, wall, f"MoE decode window of {len(uids)} "
                            f"sequences x 8 steps, profiled", CARD)


def moe_content_check(torch, model, events, routed):
    """Every token the warm-up ``generate`` emitted within ``SPEC_MARGIN``
    of the argmax of its teacher-forced re-score (``moe_replay``, paged);
    ``SPEC_MARGIN`` is ``SPEC_MARGIN_FACTOR`` x the largest |paged -
    gather| logit of the two re-scores, at most ``SPEC_MARGIN_CAP``, the
    re-scores within ``SERVING_LOGITS_REL`` a sequence (the rule of
    ``spec_content_check``).

    The re-scores route by ``generate``'s gate outputs (``routed``, call
    by call). A free re-score's router sees other bf16 roundings of its
    input (K6 for K7, gather for paged), and at cf 2.0 one near-tie flip
    moves every later token in that expert's capacity queue: on the H100
    263 of 1,312 gate calls of a free paged re-score routed otherwise than
    ``generate`` and the free paged and gather re-scores were 0.17 apart
    in rel l2. The routing itself is held by ``moe_routing_check``; the
    assignments each free gate would route otherwise are printed."""
    rows, flips = {}, {}
    for impl in ("gather", "paged"):
        with GateRecorder(forced=routed) as g:
            rows[impl], emitted, owners = moe_replay(torch, model, events,
                                                     impl)
        check(len(g.outputs) == len(routed),
              f"MoE re-score ({impl}) made {len(g.outputs)} gate calls, "
              f"generate {len(routed)}")
        flips[impl] = {"gate_calls": len(routed),
                       "calls_routed_otherwise": g.flip_calls,
                       "assignments_routed_otherwise": g.flips}
    check(bool(torch.isfinite(rows["paged"]).all())
          and bool(torch.isfinite(rows["gather"]).all()),
          "MoE re-score logits not finite")
    owner = torch.tensor(owners, device=rows["paged"].device)
    diff = float((rows["paged"] - rows["gather"]).abs().max())
    rel = max(rel_l2(torch, rows["paged"][owner == u],
                     rows["gather"][owner == u]) for u in set(owners))
    margin = SPEC_MARGIN_FACTOR * diff
    gaps = gaps_of(torch, rows["paged"], emitted)
    out = {"positions": int(gaps.numel()), "max_gap": float(gaps.max()),
           "off_argmax_share": float((gaps > 0).float().mean()),
           "paged_vs_gather_max_abs": diff, "paged_vs_gather_rel_l2": rel,
           "spec_margin": margin, "free_gate_vs_generate": flips}
    log(f"MoE content check (re-scores routed as generate): "
        f"{out['positions']} positions; paged vs gather max abs "
        f"{diff:.4e}, rel l2 {rel:.3e}; SPEC_MARGIN {margin:.4e}; max gap "
        f"{out['max_gap']:.4e} ({out['max_gap'] / max(margin, 1e-30):.2f} "
        f"x), off the argmax {out['off_argmax_share']:.4f}; a free gate "
        f"would route otherwise: {flips}")
    check(margin > 0, "MoE paged and gather re-scores are bit-identical: "
                      "the margin rule has no difference to scale")
    check(rel <= SERVING_LOGITS_REL,
          f"MoE content check: paged vs gather re-scores differ: rel l2 "
          f"{rel:.3e} > {SERVING_LOGITS_REL}")
    check(margin <= SPEC_MARGIN_CAP,
          f"MoE content check: SPEC_MARGIN {margin:.4e} > the cap "
          f"{SPEC_MARGIN_CAP}")
    check(out["max_gap"] <= margin,
          f"MoE content check: an emitted token lies {out['max_gap']:.4e} "
          f"below the re-score's argmax (> SPEC_MARGIN {margin:.4e})")
    del rows, gaps
    return out


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

    global _flush_buf
    _flush_buf = None                  # the L2 flush buffer, 256 MB
    _free(torch)
    free, total = torch.cuda.mem_get_info()
    log(f"before the world: this process holds "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved; the card "
        f"has {free / 1e9:.2f} of {total / 1e9:.2f} GB free")
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


# K12's 16-deep k-stage (csrc/collective_matmul.cu, gd::kBK)
K12_STAGE = 16
# K12's edges: (M, k a shard, N, shards, bits, group size, x dtype): M, k
# and N off the 128 x 128 tile and the 16-deep stage; groups straddling
# weight rows and k*N off the group grid; group 200 (int4 halves of 100,
# runs crossing them and runs off 8-byte alignment, element by element);
# N odd (the stores element by element); a tall k; float32 and bf16 x
K12_EDGES = ((130, 100, 136, 3, 4, 200, "f32"),
             (300, 100, 200, 2, 8, 256, "bf16"),
             (300, 100, 200, 2, 4, 256, "bf16"),
             (257, 72, 203, 3, 4, 200, "bf16"),
             (257, 72, 203, 3, 8, 200, "f32"),
             (64, 4096, 40, 2, 4, 256, "bf16"))


def k12_wires(torch, qz, w, n, bits, gs):
    """The wires (int8 ``[n, groups, W]``, scales ``[n, groups, 1]``) of n
    row blocks of ``w [n*k, N]``, each quantized as a rank's shard."""
    kk = w.shape[0] // n
    wires = [qz.quant_pack_wire(w[r * kk:(r + 1) * kk], bits, gs)
             for r in range(n)]
    return (torch.stack([a for a, _ in wires]),
            torch.stack([b for _, b in wires]))


def k12_dequantized(torch, fcm, wst, sst, bits, kk, N):
    """The float32 weight ``[n*kk, N]`` the wires stand for."""
    return torch.cat([fcm.unpack_dequant_wire_values(
        wst[r], sst[r], bits).reshape(-1)[:kk * N].reshape(kk, N)
        for r in range(wst.shape[0])])


def check_gathered(torch, fcm, tag, x, wst, sst, bits, kk, N, out_dtype):
    """K12 twice, bit for bit, and against its plain version within
    ``matmul_limit`` of x by the dequantized weight. → (max abs error,
    plain result, limit)."""
    got = fcm._gathered_dequant_matmul(x, wst, sst, bits, kk, N, out_dtype)
    again = fcm._gathered_dequant_matmul(x, wst, sst, bits, kk, N, out_dtype)
    check(torch.equal(got, again), f"{tag}: two calls differ")
    del again
    ref = fcm._gathered_dequant_matmul_reference(x, wst, sst, bits, kk, N,
                                                 out_dtype)
    deq = k12_dequantized(torch, fcm, wst, sst, bits, kk, N)
    limit = matmul_limit(torch, x, deq, got, ref)
    del deq
    return (_compare_limit(torch, tag, got, ref, limit, MATMUL_LIMIT), ref,
            limit)


def check_gathered_edge(torch, fcm, qz, gen, M, kk, N, n, bits, gs, dt):
    """K12 on one of K12_EDGES (random x and weight). → max abs error."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    x = torch.randn(M, n * kk, generator=gen, device=DEVICE).to(dtype)
    w = torch.randn(n * kk, N, generator=gen, device=DEVICE)
    wst, sst = k12_wires(torch, qz, w, n, bits, gs)
    err, _, _ = check_gathered(
        torch, fcm, f"K12 {dt} [{M}, {n * kk}] x {n} int{bits} shards of "
        f"[{kk}, {N}], group {gs}", x, wst, sst, bits, kk, N, torch.float32)
    return err


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
    # each element's sum runs in one k order wherever its tile lies
    for n in (1, 4, WORLD_SIZE):
        check(torch.equal(got, fcm.shard_major_matmul(x, wm, n)),
              f"K11: {n} shards give other bits than {WORLD_SIZE}")
    log("check K11: the same bits at 1, 2 and 4 shards and across two "
        "calls")
    faults = {"K11 with a 32-wide K tile dropped": dropped_tile(
        torch, lambda xd: fcm.matmul_reference(xd, wm), x),
              "K11 with its sums carried in bfloat16": bf16_sums(
        torch, x, wm)}
    planted = {name: planted_fault(torch, name, f, ref, limit)
               for name, f in faults.items()}
    del got, ref, limit, faults
    # the edges: K and N off the 64-deep k-stage and the 256-wide tile
    # (zeros from TMA), shards ending inside a 128-row tile
    for (m, k, nn, shards) in ((300, 72, 200, 3), (64, 4096, 40, 2)):
        for dtype in (bf16, f32):
            xe = torch.randn(m, k, generator=gen, device=DEVICE).to(dtype)
            we = torch.randn(k, nn, generator=gen, device=DEVICE).to(dtype)
            got = fcm.shard_major_matmul(xe, we, shards)
            ref = fcm.matmul_reference(xe, we)
            errs["shard_major_matmul"] = max(
                errs["shard_major_matmul"], _compare_limit(
                    torch, f"K11 {str(dtype)[6:]} [{m}, {k}] @ [{k}, {nn}] "
                    f"{shards} shards", got, ref,
                    matmul_limit(torch, xe, we, got, ref), MATMUL_LIMIT))
    # K and N off multiples of 8 (zero-padded by the wrapper, N sliced
    # back), and x off 16-byte alignment (copied)
    for (m, k, nn, shards, off) in ((300, 75, 203, 3, 0), (64, 61, 45, 2, 0),
                                    (128, 4096, 40, 2, 1)):
        for dtype in (bf16, f32):
            buf = torch.randn(m * k + 8, generator=gen,
                              device=DEVICE).to(dtype)
            xe = buf[off:off + m * k].view(m, k)
            we = torch.randn(k, nn, generator=gen, device=DEVICE).to(dtype)
            got = fcm.shard_major_matmul(xe, we, shards)
            ref = fcm.matmul_reference(xe, we)
            check(tuple(got.shape) == (m, nn), f"K11 odd widths: shape "
                  f"{tuple(got.shape)}")
            errs["shard_major_matmul"] = max(
                errs["shard_major_matmul"], _compare_limit(
                    torch, f"K11 {str(dtype)[6:]} [{m}, {k}] @ [{k}, {nn}] "
                    f"{shards} shards, x offset {off}", got, ref,
                    matmul_limit(torch, xe, we, got, ref), MATMUL_LIMIT))
    # K12: x against the two shards of the same weight on the int4 and
    # int8 wires (the prologue's operands at world 2), two calls bit for
    # bit, a planted fault; then the edges (K12_EDGES)
    kk = K // WORLD_SIZE
    k12 = {}
    for bits in (4, 8):
        wst, sst = k12_wires(torch, qz, wm, WORLD_SIZE, bits, gs)
        tag = (f"K12 gathered_dequant_matmul int{bits} [4096, 14336] x 2 "
               f"shards of [7168, 4096]")
        err, ref, limit = check_gathered(torch, fcm, tag, x, wst, sst, bits,
                                         kk, N, bf16)
        errs["gathered_dequant_matmul"] = max(
            errs["gathered_dequant_matmul"], err)
        name = f"K12 int{bits} with a {K12_STAGE}-deep k-stage dropped"
        planted[name] = planted_fault(torch, name, dropped_tile(
            torch, lambda xd: fcm._gathered_dequant_matmul_reference(
                xd, wst, sst, bits, kk, N, bf16), x, width=K12_STAGE),
            ref, limit)
        check(planted[name] >= 10.0, f"K12's limit reads a dropped k-stage "
                                     f"at only {planted[name]:.2f}x, not "
                                     f">= 10x")
        k12[bits] = (wst, sst)
        del ref, limit
    for edge in K12_EDGES:
        err = check_gathered_edge(torch, fcm, qz, gen, *edge)
        errs["gathered_dequant_matmul"] = max(
            errs["gathered_dequant_matmul"], err)
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
    # K12's companions, timing only: the int8 wire; the parent design; the
    # yardstick, float32 torch.matmul (TF32 off) of x by the weight already
    # dequantized, which lacks the dequantize
    from deepspeed_tpu_torch.utils import kernel_probe

    parent = kernel_probe.parent_gathered(_PARENT_LIBS["collective_matmul"])
    deq = k12_dequantized(torch, fcm, *k12[4], 4, kk, N)
    x32 = x.float()

    def yardstick():
        with fcm._full_float32():
            return torch.matmul(x32, deq)

    k12_more = {
        "int8_ms": cuda_ms(torch, lambda: fcm._gathered_dequant_matmul(
            x, *k12[8], 8, kk, N, bf16), 10),
        "parent_ms": cuda_ms(torch, lambda: parent(
            x, *k12[4], 4, kk, N, bf16), 5),
        "yardstick_ms": cuda_ms(torch, yardstick, 10),
        "yardstick": "torch.matmul(x.float(), W) of the weight already "
                     "dequantized, float32, TF32 off: lacks the dequantize"}
    log(f"time gathered_dequant_matmul int8 wire: {k12_more['int8_ms']:.4f} "
        f"ms; parent design (int4): {k12_more['parent_ms']:.4f} ms; "
        f"yardstick {k12_more['yardstick_ms']:.4f} ms "
        f"({k12_more['yardstick']})")
    del deq, x32
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
                     "bytes": nbytes, "flops": flops, "shape": shape,
                     **(k12_more if name == "gathered_dequant_matmul"
                        else {})})
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
                    **{k: row[k] for k in row if k not in (
                        "name", "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")}})
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
        paged_edges = phase_paged_edge_checks(torch, ops)
        tiny = phase_tiny_config(torch, ops)
        train_errs = phase_train_kernel_checks(torch)
        opt_errs = phase_optimizer_kernel_checks(torch)
        phase_sparse_kernel_checks(torch)
        wide_heads = phase_wide_head_checks(torch)
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
        prefix_serving = phase_prefix_serving(torch, ops, model)
        speculative = phase_speculative(torch, ops, model, prompts)
        serving_lifecycle = phase_serving_lifecycle(torch, ops, model,
                                                    prompts, bf16_out,
                                                    serving)
        del model
        _free(torch)
        families = phase_families(torch, ops)
        moe_serving = phase_moe_serving(torch, ops)
        train_launches, training = phase_train_main_path(torch)
        fa_launches, fused_adam = phase_fused_adam_main_path(torch, training)
        others = phase_other_fused(torch, fused_adam["losses"][0])
        checkpoint = phase_checkpoint(torch)
        zero_offload = phase_zero_offload(torch)
        kernels += phase_train_timing(torch, train_launches, train_errs)
        opt_launches = {"fused_adam": fa_launches["fused_adam"],
                        **{n: o["launches"] for n, o in others.items()}}
        kernels += phase_optimizer_timing(torch, opt_launches, opt_errs)
        # K5 on the offloaded path: one launch a piece, not a leaf
        next(r for r in kernels if r["name"] == "fused_adam")[
            "launches_offloaded_path"] = round(
                zero_offload["variants"]["cpu"]["launches_per_step"][
                    "fused_adam"] * ZERO_TIMED)
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
        for src, names in REDESIGNED.items():
            for n in names:
                row = next(r for r in kernels
                           if r["name"] == REDESIGNED_ROWS.get(n, src))
                if n in ptxas:
                    row.setdefault("ptxas", {})[n] = ptxas[n]
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"serving": serving, "paged_edge_checks": paged_edges,
                    "tiny_config": tiny}))
    log(json.dumps({"training": training}))
    log(json.dumps({"training_fused_adam": fused_adam,
                    "other_fused_optimizers": others,
                    "checkpoint": checkpoint}))
    log(json.dumps({"zero_offload": zero_offload}))
    log(json.dumps({"sparse_attention": sparse}))
    log(json.dumps({"head_dim_256": {
        "timing": wide_heads,
        "ptxas": {n[len("hd256 "):]: r for n, r in ptxas.items()
                  if n.startswith("hd256 ")}}}))
    log(json.dumps({"quantization": {"edge_checks": quant_checks,
                                     "weight_only": quant,
                                     "handoff": handoff}}))
    log(json.dumps({"prefix_serving": prefix_serving}))
    log(json.dumps({"speculative": speculative, "families": families}))
    log(json.dumps({"moe_serving": moe_serving}))
    log(json.dumps({"serving_lifecycle": serving_lifecycle}))
    log(json.dumps({"data_parallel_world": world,
                    "matmul_planted_faults_over_limit": planted}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

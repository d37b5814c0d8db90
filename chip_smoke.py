#!/usr/bin/env python3
"""Drive the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero before the last line is printed:

  1. the card: ``nvidia-smi`` name and power limit, ``nvcc``;
  2. build the CUDA kernels from ``deepspeed_tpu_torch/csrc`` (one ``nvcc``
     per source, in parallel) and print the build time and ptxas report;
  3. hold each kernel against its plain PyTorch version on the card: at the
     serving path's shapes (hd 128, 8 KV heads, G 4, page 64, bf16) and on
     float32 edge batches (padding rows, zero-length rows, contexts ending
     on a page edge, a NaN-poisoned sequence);
  4. the main path: ``InferenceEngineV2.generate`` at the full width and
     depth of ``TransformerConfig.llama3_8b()`` (random bf16 weights from a
     seeded generator), 8 prompts of 128-1024 tokens, 64 new tokens each:
     one untimed run at these shapes pays the first-touch costs, then
     ``REPEATS`` timed runs (median and spread printed); in each, both
     kernels' launch counters must rise from 0, every token must be in
     range; then one ``put`` with ``attn_impl="paged"`` and one with
     ``"gather"`` on the same batch must give finite, agreeing logits;
  5. time each kernel, its plain version and one PyTorch library call
     (``scaled_dot_product_attention`` on the gathered dense K/V, timing
     only) at the main path's shapes, with the L2 cache flushed before
     every timed launch, beside the card's bound; print the ``kernels``
     JSON line;
  6. print ``{"ok": true, "device": {...}}`` as the last line.
"""
from __future__ import annotations

import json
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

K6_REPLACES = "deepspeed_tpu/inference/v2/kernels/ragged_ops.py:65"
K7_REPLACES = "deepspeed_tpu/inference/v2/kernels/ragged_ops.py:381"


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


def phase_build(torch):
    from deepspeed_tpu_torch.ops.op_builder import get_builder, load_kernels

    t0 = time.perf_counter()
    libs = load_kernels()
    builder = get_builder()
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {builder.build_seconds:.1f} s)")
    for name, text in builder.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas[{name}]: {line.strip()}")
    torch.cuda.synchronize()


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
    return launches, serving, model


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
        phase_build(torch)
        shapes = main_shapes()
        errs = phase_kernel_checks(torch, ops, shapes)
        launches, serving, model = phase_main_path(torch, ops)
        del model
        torch.cuda.empty_cache()
        kernels = phase_timing(torch, ops, shapes, launches, errs)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"serving": serving}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Variants of the port's CUDA kernels side by side on the card.

    python -m deepspeed_tpu_torch.utils.kernel_probe [probe ...]

A variant is a source of ``csrc/`` with textual substitutions (a tile
width, a ring depth, a wait depth), compiled with ``NVCC_FLAGS`` into
``build/probe/`` beside the tree's libraries; the tree's own source is the
first variant of each probe. A probe swaps each variant in for the tree's
library (the wrappers look their launcher up on every call), holds it
against the plain version with ``chip_smoke.py``'s limits on edge batches
and at the main path's shapes, and times the variants in turns (in order,
in reverse, in order again) with ``chip_smoke.cuda_ms``, beside the card's
name and power limit and ptxas's report. It needs a card and ``nvcc``, and runs from a checkout
(it imports ``chip_smoke``). Probes: ``flash_fwd`` (K1 at B 4, S 2048, H
32, hd 128, causal; K2 and K3 timed beside it), ``shard_major`` (K11 at x
[4096, 14336] @ w [14336, 4096], 2 shards), ``ragged`` (K6's bf16 kernel
at the serving engine's SplitFuse shapes), ``gathered`` (K12 at x [4096,
14336] bf16 against 2 int4 shards of [7168, 4096]), and ``bs_fwd`` (K16,
K17), ``bs_dq`` (K18) and ``bs_dkv`` (K19) at B 1, H 32, S 8192, hd 128,
block 64, Fixed and BigBird. The last four also time the design their
redesign replaced, built from the copy of its source in
``probe_parents/`` (``PARENTS``), in the same turns.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple, Union

import torch

from ..ops.op_builder import builder as bld

# K1's walk, from the tree's first consumer statement to its epilogue, and
# two other orders of a warpgroup's turns (turn jt issues S = Q.K^T of tile
# jt with O += P.V of tile jt - 1): SHIFTED as FlashAttention-3 does (two
# wgmma groups, tile jt's softmax between the waits for S and for P.V),
# MERGED as one group, the softmax after both
_FWD_WALK = ("  mbar_wait(&bars[0], 0);\n  if (cg == 1) turns.pass();\n\n"
             "  // The walk:", "  // epilogue: the 4 lanes")
_FWD_SHIFTED = """\
  // Turn jt of a warpgroup (1 <= jt < nv): it issues S = Q.K^T of tile jt
  // and O += P.V of tile jt - 1 as two wgmma groups and lets the other
  // warpgroup go; tile jt's softmax runs while its P.V and the other's turn
  // hold the tensor cores; once P.V is done, O is rescaled and tile jt -
  // 1's stage freed. Issue and waits sit in one block with no branch
  // between them (ptxas serializes the wgmma otherwise).
  auto turn = [&](int jt, auto edge) {
    float s[W / 2], alpha[2];
    mbar_wait(&full[jt % wg::kStages], (jt / wg::kStages) & 1);
    __syncwarp();  // wgmma needs the warp converged
    turns.wait();
    wgmma_fence();
    wg::score_product<HD, W>(s, q_own, k_tile(jt));
    wgmma_commit();
    wg::walk_product<HD, W>(acc, pa, k_tile(jt - 1) + L::kWalkBytes);
    wgmma_commit();
    turns.pass();
    wgmma_wait<1>();
    wgmma_fence_operand(s);
    probs(s, jt, alpha, edge);
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
    release(jt - 1);
    finish(s, alpha);
  };
  mbar_wait(&bars[0], 0);
  if (cg == 1) turns.pass();

  // A warpgroup takes n_tiles + 1 turns: turn 0 issues S of tile 0, turns
  // 1 .. nv - 1 as above, turn nv the last P.V, the rest nothing (a
  // warpgroup past S or past the causal diagonal); turn jt frees tile jt -
  // 1's stage.
  if (nv > 0) {
    float s[W / 2], alpha[2];
    mbar_wait(&full[0], 0);
    __syncwarp();
    turns.wait();
    wgmma_fence();
    wg::score_product<HD, W>(s, q_own, k_tile(0));
    wgmma_commit();
    turns.pass();
    wgmma_wait<0>();
    wgmma_fence_operand(s);
    if (nv == 1) {
      probs(s, 0, alpha, std::true_type{});
    } else {
      probs(s, 0, alpha, std::false_type{});
    }
    finish(s, alpha);
  } else {
    turns.wait();
    turns.pass();
  }
  for (int jt = 1; jt < nv - 1; ++jt) turn(jt, std::false_type{});
  if (nv > 1) turn(nv - 1, std::true_type{});
  int jt = 1;
  if (nv > 0) {                                   // turn nv: P.V of nv - 1
    turns.wait();
    wgmma_fence();
    wg::walk_product<HD, W>(acc, pa, k_tile(nv - 1) + L::kWalkBytes);
    wgmma_commit();
    if (!(cg == 1 && nv == n_tiles)) turns.pass();
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
    release(nv - 1);
    jt = nv + 1;
  }
  for (; jt <= n_tiles; ++jt) {                   // nothing visible
    turns.wait();
    if (!(cg == 1 && jt == n_tiles)) turns.pass();
    release(jt - 1);
  }


"""
_FWD_MERGED = _FWD_SHIFTED.replace("""\
    wg::score_product<HD, W>(s, q_own, k_tile(jt));
    wgmma_commit();
    wg::walk_product<HD, W>(acc, pa, k_tile(jt - 1) + L::kWalkBytes);
    wgmma_commit();
    turns.pass();
    wgmma_wait<1>();
    wgmma_fence_operand(s);
    probs(s, jt, alpha, edge);
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
    release(jt - 1);
    finish(s, alpha);
""", """\
    wg::walk_product<HD, W>(acc, pa, k_tile(jt - 1) + L::kWalkBytes);
    wg::score_product<HD, W>(s, q_own, k_tile(jt));
    wgmma_commit();
    turns.pass();
    wgmma_wait<0>();
    wgmma_fence_operand(acc);
    wgmma_fence_operand(s);
    release(jt - 1);
    probs(s, jt, alpha, edge);
    finish(s, alpha);
""")
_FWD_WALK64 = [("constexpr int kWalk = 128;", "constexpr int kWalk = 64;"),
               ("constexpr int kStages = 3;", "constexpr int kStages = 4;")]
# the row max over raw scores and P = 2^fma(s, scale*log2 e, -m2): one
# multiply a score fewer (valid for scale > 0 only, masked scores -inf)
_FWD_FUSED_SCALE = [
    ("#pragma unroll\n    for (int i = 0; i < W / 2; ++i) s[i] *= "
     "scale_log2;\n", ""),
    ("? wg::kMasked2 : s[i];", "? -INFINITY : s[i];"),
    ("    float mx[2] = {m2[0], m2[1]};",
     "    float mx[2] = {-INFINITY, -INFINITY};"),
    ("      alpha[r] = wg::exp2_approx(m2[r] - mx[r]);",
     "      mx[r] = fmaxf(m2[r], mx[r] * scale_log2);\n"
     "      alpha[r] = wg::exp2_approx(m2[r] - mx[r]);"),
    ("      s[i] = wg::exp2_approx(s[i] - m2[(i >> 1) & 1]);",
     "      s[i] = wg::exp2_approx(fmaf(s[i], scale_log2, "
     "-m2[(i >> 1) & 1]));")]
# O rescaled only when a row's max moved (a vote per warp)
_FWD_LAZY_RESCALE = [(
    "#pragma unroll\n    for (int i = 0; i < HD / 2; ++i) acc[i] *= "
    "alpha[(i >> 1) & 1];\n",
    "    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) "
    "{\n#pragma unroll\n      for (int i = 0; i < HD / 2; ++i) acc[i] *= "
    "alpha[(i >> 1) & 1];\n    }\n")]

Edit = Tuple[Union[str, Tuple[str, str]], str]
#: source → {variant: [(text, replacement), ...]}, where text may be a pair
#: (start, end): the span from start up to end; the first is the tree's
VARIANTS: Dict[str, Dict[str, List[Edit]]] = {
    "flash_attention_fwd": {
        "turns apart, walk 128, 3 stages": [],
        "turns apart, walk 128, 2 stages": [
            ("constexpr int kStages = 3;", "constexpr int kStages = 2;")],
        "turns apart, walk 64, 4 stages": _FWD_WALK64,
        "shifted, walk 128, 3 stages": [(_FWD_WALK, _FWD_SHIFTED)],
        "shifted, walk 64, 4 stages": [(_FWD_WALK, _FWD_SHIFTED),
                                       *_FWD_WALK64],
        "merged, walk 128, 3 stages": [(_FWD_WALK, _FWD_MERGED)],
        "merged, walk 64, 4 stages": [(_FWD_WALK, _FWD_MERGED),
                                      *_FWD_WALK64],
        "turns apart, fused scale": _FWD_FUSED_SCALE,
        "turns apart, lazy rescale": _FWD_LAZY_RESCALE,
        "turns apart, fused scale, lazy rescale": [*_FWD_FUSED_SCALE,
                                                   *_FWD_LAZY_RESCALE],
        "shifted, walk 64, fused scale, lazy rescale": [
            (_FWD_WALK, _FWD_SHIFTED), *_FWD_WALK64, *_FWD_FUSED_SCALE,
            *_FWD_LAZY_RESCALE],
    },
    "ragged_paged_attention": {
        "2 groups, 2 stages, 64-position chunks": [],
        "1 group, 2 stages": [
            ("constexpr int kGroups = 2;", "constexpr int kGroups = 1;")],
        "1 group, 3 stages": [
            ("constexpr int kGroups = 2;", "constexpr int kGroups = 1;"),
            ("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
        "2 groups, 32-position chunks": [
            ("HDP == 256 ? 32 : 64;  // positions a chunk",
             "32;  // positions a chunk")],
    },
    "collective_matmul": {
        "one wgmma group a stage": [],
        "one group in flight": [
            ("    wgmma_wait<0>();\n    wgmma_fence_operand(acc);\n"
             "    if (lane == 0) mbar_arrive(&empty[st]);",
             "    wgmma_wait<1>();\n    wgmma_fence_operand(acc);\n"
             "    if (kt > 0 && lane == 0)\n"
             "      mbar_arrive(&empty[(kt + wg::kStages - 1) % "
             "wg::kStages]);"),
            ("  // epilogue: round once to bfloat16; only",
             "  wgmma_wait<0>();\n  wgmma_fence_operand(acc);\n"
             "  // epilogue: round once to bfloat16; only")],
    },
}


#: the designs a redesign replaced, kept as copies of their sources in
#: ``probe_parents/`` (built with the tree's headers) so that a call can
#: time them beside the tree's: source → what the copy holds
PARENTS = {
    "collective_matmul":
        "K12 before its redesign: 128 x 128 tiles on mma.sync-layout float "
        "products, scalar staging, float32 x, two accumulator sets",
    "block_sparse_attention_fwd":
        "K16/K17 before their redesign: 64 query rows a CTA of 4 warps, "
        "mma.sync fragments from scalar shared loads, synchronous staging, "
        "P through shared memory, expf",
    "block_sparse_attention_bwd":
        "K19 before its redesign, and K18 before its own (the same exact "
        "kernel): 64 rows a CTA of 4 warps, mma.sync fragments from scalar "
        "shared loads, synchronous staging, expf",
}
PARENT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "probe_parents")


def _compile(sources: Dict[str, str]) -> Dict[str, ctypes.CDLL]:
    """Compile {name: path of a .cu} at once with the tree's flags and
    headers, print ptxas's lines on registers, spills and warnings;
    → {name: library}."""
    nvcc = bld.find_nvcc()
    jobs = {}
    for name, path in sources.items():
        so = path[:-3] + ".so"
        cmd = [nvcc, *bld.NVCC_FLAGS, f"-I{bld.CSRC_DIR}", "-o", so, path]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      so)
    libs, failed = {}, []
    for name, (proc, so) in jobs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                       "arning", "Compiling entry")):
                print(f"  ptxas[{name}]: {line.strip()[:200]}")
        if proc.returncode:
            failed.append(f"{name}:\n{log[-3000:]}")
        else:
            libs[name] = ctypes.CDLL(so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return libs


def build_parents(sources) -> Dict[str, ctypes.CDLL]:
    """The parent copies of ``sources`` (keys of PARENTS), compiled at once
    into ``build/probe/``; → {source: library}."""
    out_dir = os.path.join(bld.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for source in sources:
        path = os.path.join(out_dir, f"{source}_parent.cu")
        with open(os.path.join(PARENT_DIR, source + ".cu")) as f:
            text = f.read()
        with open(path, "w") as f:
            f.write(text)
        paths[f"{source} parent"] = path
    return {name[:-len(" parent")]: lib
            for name, lib in _compile(paths).items()}


def parent_gathered(lib):
    """K12's parent design as its wrapper called it (x copied to float32,
    one launch): ``(x, w_wire, s_wire, bits, k_shard, N, out_dtype)`` →
    ``[M, N]``."""
    fn = lib.gathered_dequant_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, w_wire, s_wire, bits, k_shard, N, out_dtype):
        n, groups, W = w_wire.shape
        x32 = x.to(torch.float32).contiguous()
        out = torch.empty(x.shape[0], N, dtype=torch.float32,
                          device=x.device)
        err = fn(x32.data_ptr(), w_wire.data_ptr(), s_wire.data_ptr(),
                 out.data_ptr(), x.shape[0], N, k_shard, n, groups,
                 W if bits == 8 else 2 * W, bits,
                 torch.cuda.current_stream().cuda_stream)
        bld.check_launch("parent gathered_dequant_matmul", err)
        return out.to(out_dtype)

    return call


def build_variants(source: str, variants=None) -> Dict[str, ctypes.CDLL]:
    """Compile every variant of ``csrc/<source>.cu`` (``variants``, by
    default ``VARIANTS[source]``) at once; → {variant: library}."""
    out_dir = os.path.join(bld.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(bld.CSRC_DIR, source + ".cu")) as f:
        text = f.read()
    paths = {}
    for name, subs in (variants or VARIANTS[source]).items():
        body = text
        for old, new in subs:
            if isinstance(old, tuple):
                lo = body.find(old[0])
                hi = body.find(old[1], lo)
                if lo < 0 or hi < 0:
                    raise ValueError(f"{source} ({name}): {old!r} not found")
                body = body[:lo] + new + body[hi:]
            elif old in body:
                body = body.replace(old, new)
            else:
                raise ValueError(f"{source} ({name}): {old!r} not found")
        # named by content: a library loaded once stays loaded under its
        # path, so another body must not reuse the name
        digest = hashlib.sha256(body.encode()).hexdigest()[:12]
        path = os.path.join(out_dir, f"{source}_{digest}.cu")
        with open(path, "w") as f:
            f.write(body)
        paths[name] = path
    return _compile(paths)


def swapped(source, lib, fn):
    """``fn`` with ``lib`` standing in for the tree's library of
    ``source`` while it runs (the wrappers look their launcher up on
    every call)."""
    def call():
        libs = bld.load_kernels()
        tree = libs[source]
        libs[source] = lib
        try:
            return fn()
        finally:
            libs[source] = tree
    return call


def time_in_turns(cs, fns, iters):
    """{name: fn} → {name: [ms, ms, ms]}: each ``fn``'s median ms
    (``chip_smoke.cuda_ms``), in order, in reverse, in order again."""
    names = list(fns)
    times = {n: [] for n in names}
    for name in names + names[::-1] + names:
        times[name].append(cs.cuda_ms(torch, fns[name], iters))
    return times


def _turns(cs, source, libs, fn, iters):
    """``fn``'s median ms with each variant swapped in, in turns."""
    return time_in_turns(cs, {n: swapped(source, lib, fn)
                              for n, lib in libs.items()}, iters)


def probe_flash_fwd(cs):
    from ..ops.transformer import flash_attention as fa

    libs = build_variants("flash_attention_fwd")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 90)
    tree = bld.load_kernels()["flash_attention_fwd"]
    m = cs.FA_MAIN
    main = cs.flash_inputs(torch, gen, m["B"], m["S"], m["H"], m["KV"],
                           m["hd"], torch.bfloat16)
    try:
        for name, lib in libs.items():
            bld.load_kernels()["flash_attention_fwd"] = lib
            for S in (1, 63, 64, 65, 127, 128, 129, 257):
                for causal in (True, False):
                    for hd in (64, 128):
                        q, k, v, do = cs.flash_inputs(torch, gen, 2, S, 8, 2,
                                                      hd, torch.bfloat16)
                        cs.check_flash(torch, fa, f"{name} bf16 S={S} "
                                       f"causal={causal} hd={hd}", q, k, v,
                                       do, causal, cs.FLASH_BF16_TERMS,
                                       cs.BF16_RTOL, cs.BF16_ATOL)
            cs.check_flash(torch, fa, f"{name} bf16 main shapes", *main,
                           True, cs.FLASH_BF16_TERMS, cs.BF16_RTOL,
                           cs.BF16_ATOL)
            a = fa.flash_attention_fwd(*main[:3], True)
            b = fa.flash_attention_fwd(*main[:3], True)
            cs.check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
                     f"{name}: two calls differ")
            del a, b
    finally:
        bld.load_kernels()["flash_attention_fwd"] = tree
    q, k, v, do = main
    scale = 1.0 / math.sqrt(m["hd"])
    for tag, causal, args in (("hd 128 causal", True, (q, k, v)),
                              ("hd 128 full", False, (q, k, v))):
        times = _turns(cs, "flash_attention_fwd", libs,
                       lambda: fa.flash_attention_fwd(*args, causal, scale),
                       20)
        for name, ts in times.items():
            print(f"time K1 {tag} [{name}]: "
                  + ", ".join(f"{t:.4f}" for t in ts) + " ms")
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = cs.cuda_ms(torch, lambda: torch.nn.functional
                      .scaled_dot_product_attention(qt, kt, vt,
                                                    is_causal=True), 20)
    print(f"time SDPA forward hd 128 causal: {sdpa:.4f} ms")
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    for name, fn in (("K2", fa.flash_attention_bwd_dq),
                     ("K3", fa.flash_attention_bwd_dkv)):
        t = cs.cuda_ms(torch, lambda: fn(q, k, v, do, lse, delta, True,
                                         scale), 10)
        print(f"time {name} (the tree's): {t:.4f} ms")


def probe_shard_major(cs):
    from ..kernels import fused_collective_matmul as fcm

    libs = build_variants("collective_matmul")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 91)
    bf16 = torch.bfloat16
    M, K, N = cs.WORLD_SPEC["gemm"]
    x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
    w = (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5).to(bf16)
    ref = fcm.matmul_reference(x, w)
    tree = bld.load_kernels()["collective_matmul"]
    first = None
    try:
        for name, lib in libs.items():
            bld.load_kernels()["collective_matmul"] = lib
            got = fcm.shard_major_matmul(x, w, 2)
            cs._compare_limit(torch, f"{name} K11 main shapes", got, ref,
                              cs.matmul_limit(torch, x, w, got, ref),
                              cs.MATMUL_LIMIT)
            for n in (1, 4, 2):
                cs.check(torch.equal(got, fcm.shard_major_matmul(x, w, n)),
                         f"{name}: {n} shards differ from 2")
            if first is not None:
                cs.check(torch.equal(got, first), f"{name}: other bits")
            first = got
            for (mm, kk, nn, sh) in ((300, 72, 200, 3), (64, 4096, 40, 2),
                                     (130, 136, 520, 2)):
                for dt in (bf16, torch.float32):
                    xe = torch.randn(mm, kk, generator=gen,
                                     device="cuda").to(dt)
                    we = torch.randn(kk, nn, generator=gen,
                                     device="cuda").to(dt)
                    g2 = fcm.shard_major_matmul(xe, we, sh)
                    r2 = fcm.matmul_reference(xe, we)
                    cs._compare_limit(
                        torch, f"{name} K11 {str(dt)[6:]} [{mm}, {kk}] @ "
                        f"[{kk}, {nn}] {sh} shards", g2, r2,
                        cs.matmul_limit(torch, xe, we, g2, r2),
                        cs.MATMUL_LIMIT)
    finally:
        bld.load_kernels()["collective_matmul"] = tree
    times = _turns(cs, "collective_matmul", libs,
                   lambda: fcm.shard_major_matmul(x, w, 2), 10)
    for name, ts in times.items():
        print(f"time K11 [{name}]: " + ", ".join(f"{t:.4f}" for t in ts)
              + " ms")
    lib = cs.cuda_ms(torch, lambda: torch.matmul(x, w), 10)
    print(f"time torch.matmul: {lib:.4f} ms")


def probe_ragged(cs):
    """K6's bf16 kernel: each variant against the plain version on the
    paged edge batches and the batches below (two calls bit for bit), then
    timed in turns on SplitFuse batches of the serving engine's shapes
    (llama3-8B's heads, 16 sequence slots): the main shapes; 8 decode rows
    at 1,000-2,000 positions of context beside one 200-token chunk; one
    256-token prompt chunk at 1,792-2,048 positions; and two launches too
    small to fill the card: one 16-token chunk at 2,048 positions with a
    single sequence slot, and Falcon-7B's heads (MQA, 71 query heads on 1
    KV head, hd 64) with 4 decode rows at 2,000 positions."""
    from ..inference.v2.kernels import ragged_ops as ops

    libs = build_variants("ragged_paged_attention")
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 92)
    tree = bld.load_kernels()["ragged_paged_attention"]
    m = cs.main_shapes()
    llama = (m["KV"], m["G"], m["hd"])
    batches = {
        "main shapes": (llama, m["k6_q_lens"], m["k6_kv_lens"],
                        m["k6_pad"]),
        "8 decode rows + a 200-token chunk": (
            llama, [1] * 8 + [200] + [0] * 7,
            [1000 + 125 * i for i in range(8)] + [712] + [0] * 7, 48),
        "a 256-token chunk at 2048": (llama, [256] + [0] * 15,
                                      [2048] + [0] * 15, 0),
        "a 16-token chunk at 2048, one slot": (llama, [16], [2048], 0),
        "falcon-7b heads, 4 decode rows at 2000": (
            (1, 71, 64), [1] * 4 + [0] * 12, [2000] * 4 + [0] * 12, 12),
    }
    inputs = {name: (geo[0], cs.paged_inputs(
        torch, gen, KV=geo[0], G=geo[1], hd=geo[2], ps=m["ps"], NB=m["NB"],
        n_pages=16 * m["NB"] + 1, q_lens=ql, kv_lens=kl,
        dtype=torch.bfloat16, pad_tokens=pad))
        for name, (geo, ql, kl, pad) in batches.items()}
    try:
        for name, lib in libs.items():
            bld.load_kernels()["ragged_paged_attention"] = lib
            for bname, (KV, args) in inputs.items():
                cs.check_ragged(torch, ops, f"[{name}] {bname}", *args, KV)
            for KV, G, hd, ps in cs.PAGED_EDGES:
                NB = 640 // ps
                args = cs.paged_inputs(
                    torch, gen, KV=KV, G=G, hd=hd, ps=ps, NB=NB,
                    n_pages=9 * NB + 1, q_lens=[7, 0, 1, 16, 1, 33, 0, 0],
                    kv_lens=[7, 0, 64, 16, 300, 400, 0, 0],
                    dtype=torch.bfloat16, pad_tokens=5)
                cs.check_ragged(torch, ops, f"[{name}] KV={KV} G={G} "
                                f"hd={hd} ps={ps}", *args, KV,
                                alibi=ops.alibi_slopes(KV * G).tolist())
    finally:
        bld.load_kernels()["ragged_paged_attention"] = tree
    for bname, (KV, args) in inputs.items():
        times = _turns(cs, "ragged_paged_attention", libs,
                       lambda: ops.ragged_paged_attention(
                           *args, num_kv_heads=KV), 20)
        for name, ts in times.items():
            print(f"time K6 {bname} [{name}]: "
                  + ", ".join(f"{t:.4f}" for t in ts) + " ms")
        dev = cs.device_ms(torch, lambda: ops.ragged_paged_attention(
            *args, num_kv_heads=KV))
        print(f"time K6 {bname} (the tree's, device): {dev:.4f} ms")


_K12_ONE = ("constexpr int kMinBlocks = 2;", "constexpr int kMinBlocks = 1;")


def _k12_unroll(n):
    return ("#pragma unroll 2\n    for (int kq = 0; kq < gd::kBK; ++kq) {",
            f"#pragma unroll {n}\n    for (int kq = 0; kq < gd::kBK; ++kq) {{")


# K12's variants (csrc/collective_matmul.cu): CTAs an SM, the k loop's unroll
GATHERED_VARIANTS: Dict[str, List[Edit]] = {
    "2 CTAs an SM, k unrolled 2": [],
    "2 CTAs an SM, k unrolled 4": [_k12_unroll(4)],
    "2 CTAs an SM, k not unrolled": [_k12_unroll(1)],
    "1 CTA an SM, k unrolled 2": [_K12_ONE],
    "1 CTA an SM, k unrolled 16": [_K12_ONE, _k12_unroll(16)],
}
# K19's variants (csrc/block_sparse_attention_bwd.cu): the tree's alone
# (PERF.md: the orders, raster groups and turns measured before)
BS_DKV_VARIANTS: Dict[str, List[Edit]] = {
    "two warpgroups side by side, raster groups of 16": [],
}
# K16/K17's variants (csrc/block_sparse_attention_fwd.cu) and K18's
# (csrc/block_sparse_attention_bwd.cu): the tree's alone (PERF.md: reversed
# order, rings of 3 and raster groups of 4 and 8 measured slower)
BS_FWD_VARIANTS: Dict[str, List[Edit]] = {
    "two warpgroups on alternate tiles, rings of 2, layout order": [],
}
BS_DQ_VARIANTS: Dict[str, List[Edit]] = {
    "two warpgroups on alternate tiles, rings of 2, layout order": [],
}


def probe_gathered(cs):
    """K12: each variant against the plain version on the main shapes
    (int4 and int8 wires) and on ``chip_smoke.K12_EDGES``, two calls bit
    for bit; then the variants and the parent design timed in turns at x
    [4096, 14336] bf16 against 2 int4 shards of [7168, 4096], the int8
    wire and the yardstick (float32 ``torch.matmul`` by the weight already
    dequantized, TF32 off) beside them."""
    from ..kernels import fused_collective_matmul as fcm
    from ..ops.quantizer import quantizer as qz

    source = "collective_matmul"
    libs = build_variants(source, GATHERED_VARIANTS)
    parent = parent_gathered(build_parents([source])[source])
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 93)
    bf16 = torch.bfloat16
    M, K, N = cs.WORLD_SPEC["gemm"]
    n = cs.WORLD_SIZE
    kk = K // n
    x = torch.randn(M, K, generator=gen, device="cuda").to(bf16)
    w = (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5).to(bf16)
    wires = {bits: cs.k12_wires(torch, qz, w, n, bits, cs.QUANT_GROUP)
             for bits in (4, 8)}
    for name, lib in libs.items():
        def checks():
            for bits, (wst, sst) in wires.items():
                cs.check_gathered(torch, fcm, f"[{name}] K12 int{bits} main "
                                  f"shapes", x, wst, sst, bits, kk, N, bf16)
            for edge in cs.K12_EDGES:
                cs.check_gathered_edge(torch, fcm, qz, gen, *edge)
        swapped(source, lib, checks)()
    fns = {name: swapped(source, lib, lambda: fcm._gathered_dequant_matmul(
        x, *wires[4], 4, kk, N, bf16)) for name, lib in libs.items()}
    fns["parent design"] = lambda: parent(x, *wires[4], 4, kk, N, bf16)
    for name, ts in time_in_turns(cs, fns, 5).items():
        print(f"time K12 int4 [{name}]: "
              + ", ".join(f"{t:.4f}" for t in ts) + " ms")
    int8 = cs.cuda_ms(torch, lambda: fcm._gathered_dequant_matmul(
        x, *wires[8], 8, kk, N, bf16), 10)
    print(f"time K12 int8 (the tree's): {int8:.4f} ms")
    deq = cs.k12_dequantized(torch, fcm, *wires[4], 4, kk, N)
    x32 = x.float()

    def yardstick():
        with fcm._full_float32():
            return torch.matmul(x32, deq)

    print(f"time yardstick, float32 torch.matmul by the dequantized weight "
          f"(no dequantize): {cs.cuda_ms(torch, yardstick, 10):.4f} ms")


def _probe_sparse(cs, source, variants, timed, seed):
    """Block-sparse kernels of ``source``: each variant against the plain
    versions on ``chip_smoke.phase_sparse_kernel_checks``' batches and at
    the main shape (B 1, H 32, S 8192, hd 128, bf16, block 64; Fixed and
    BigBird), two calls bit for bit; then the variants and the parent
    design (built from its copy in ``probe_parents/``; its C entry points
    are the tree's, so it is swapped in like a variant) timed in turns on
    both layouts for the kernels named in ``timed``, the tree's other
    block-sparse kernels beside them."""
    from ..ops.sparse_attention import block_sparse_kernel as bs

    libs = build_variants(source, variants)
    libs["parent design"] = build_parents([source])[source]
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + seed)
    m = cs.SPARSE_MAIN
    B, H, S, hd = m["B"], m["H"], m["S"], m["hd"]
    q, k, v, do = cs.sparse_inputs(torch, gen, B, H, S, hd, torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    layouts = {name: bs.prepare_layout(cfg.make_layout(S), m["block"], H,
                                       "cuda")
               for name, cfg in cs.sparse_configs(H).items()}
    for name, lib in libs.items():
        if name == "parent design":
            continue

        def checks():
            cs.phase_sparse_kernel_checks(torch)
            for lname, tables in layouts.items():
                cs.check_sparse(torch, bs, f"[{name}] bf16 main shapes "
                                f"{lname}", q, k, v, do, tables,
                                cs.FLASH_BF16_TERMS, cs.BF16_RTOL,
                                cs.BF16_ATOL)
        swapped(source, lib, checks)()
    for lname, tables in layouts.items():
        o, lse = bs.block_sparse_fwd(q, k, v, tables, scale)
        delta = (do.float() * o.float()).sum(-1)
        calls = {
            "K16": lambda: bs.block_sparse_fwd(q, k, v, tables, scale),
            "K17": lambda: bs.block_sparse_fwd_nolse(q, k, v, tables, scale),
            "K18": lambda: bs.block_sparse_bwd_dq(q, k, v, do, lse, delta,
                                                  tables, scale),
            "K19": lambda: bs.block_sparse_bwd_dkv(q, k, v, do, lse, delta,
                                                   tables, scale)}
        for kname, fn in calls.items():
            if kname not in timed:
                print(f"time {kname} {lname} (the tree's): "
                      f"{cs.cuda_ms(torch, fn, 10):.4f} ms")
                continue
            fns = {name: swapped(source, lib, fn)
                   for name, lib in libs.items()}
            for name, ts in time_in_turns(cs, fns, 10).items():
                print(f"time {kname} {lname} [{name}]: "
                      + ", ".join(f"{t:.4f}" for t in ts) + " ms")


def probe_bs_dkv(cs):
    """K19 (``_probe_sparse``)."""
    _probe_sparse(cs, "block_sparse_attention_bwd", BS_DKV_VARIANTS,
                  ("K19",), 94)


def probe_bs_dq(cs):
    """K18 (``_probe_sparse``)."""
    _probe_sparse(cs, "block_sparse_attention_bwd", BS_DQ_VARIANTS,
                  ("K18",), 95)


def probe_bs_fwd(cs):
    """K16 and K17 (``_probe_sparse``)."""
    _probe_sparse(cs, "block_sparse_attention_fwd", BS_FWD_VARIANTS,
                  ("K16", "K17"), 96)


PROBES = {"flash_fwd": probe_flash_fwd, "shard_major": probe_shard_major,
          "ragged": probe_ragged, "gathered": probe_gathered,
          "bs_dkv": probe_bs_dkv, "bs_dq": probe_bs_dq, "bs_fwd": probe_bs_fwd}


def main(argv: List[str]) -> int:
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("kernel_probe: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    t0 = time.perf_counter()
    bld.load_kernels()
    print(f"tree's kernels built in {time.perf_counter() - t0:.1f} s")
    for name in argv or list(PROBES):
        t0 = time.perf_counter()
        PROBES[name](cs)
        torch.cuda.synchronize()
        print(f"probe {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The port's host page tier and cold-KV swap against the JAX package's, on
the CPU.

``HostPageTier`` takes the same operations as the JAX tier and must give
the same contents and stats (LRU eviction, oversize reject, the one-slot
pending transfer then sync, discard, pop; the cases mirror
``tests/unit/test_kv_swap.py``'s). Then both engines swap: a sequence is
spilled, flushed and restored, and a prefix chain is evicted to the host
and grafted back. Restored rows must equal the rows before the spill bit
for bit, greedy tokens must equal the uninterrupted run's and the JAX
engine's, and an injected ``kv_swap_in`` failure must fall back to a
recompute with the same tokens. A bfloat16 pool's rows make the bf16 →
float32 → bf16 round trip exactly.
"""
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.v2 import kv_ship as jax_ship
from deepspeed_tpu.runtime.fault import injection as jax_injection
from deepspeed_tpu.runtime.swap_tensor import host_tier as jax_tier
from deepspeed_tpu_torch.inference.v2 import kv_ship
from deepspeed_tpu_torch.runtime.fault import injection
from deepspeed_tpu_torch.runtime.swap_tensor import host_tier

from .torch_serving import (BS, admit, decode, host, jax_engine_for,
                            page_rows, port_engine_for, prefill, retire,
                            serve, tiny_weights)

pytestmark = pytest.mark.torch_port

#: canonical-row bytes of one tiny-model page: L(2) * bs(8) * 2(K+V)
#: * kv_heads(2) * head_dim(16) * 4 (float32)
PAGE_ROW_BYTES = 2 * BS * 2 * 2 * 16 * 4
TIERS = {"jax": jax_tier.HostPageTier, "port": host_tier.HostPageTier}


@pytest.fixture(autouse=True)
def _clean_injectors():
    injection.clear()
    jax_injection.clear()
    yield
    injection.clear()
    jax_injection.clear()


def both(scenario):
    traces = {name: scenario(cls) for name, cls in TIERS.items()}
    assert traces["port"] == traces["jax"]
    return traces["port"]


def _rows(x):
    return None if x is None else np.asarray(x).tolist()


# --------------------------------------------------------------------- #
# HostPageTier mechanics (no engine)
# --------------------------------------------------------------------- #
def test_put_get_roundtrip_and_lru_eviction():
    def run(cls):
        tier = cls(capacity_bytes=3 * 64)
        pages = {k: np.full((16,), k, np.float32) for k in range(4)}
        ok = [tier.put(("kv", k), pages[k]) for k in range(3)]
        trace = [ok, len(tier), tier.used_bytes]
        tier.get(("kv", 0))                # key 1 becomes the LRU victim
        trace += [tier.put(("kv", 3), pages[3]), ("kv", 1) in tier,
                  tier.evictions, [_rows(tier.get(("kv", k)))
                                   for k in (0, 2, 3)], tier.stats()]
        return trace

    ok, n, used, put3, has1, ev, rows, stats = both(run)
    assert ok == [True] * 3 and n == 3 and used == 3 * 64
    assert put3 and not has1 and ev == 1
    assert rows == [[float(k)] * 16 for k in (0, 2, 3)]
    assert stats["used_bytes"] == 3 * 64


def test_oversized_payload_rejected():
    def run(cls):
        tier = cls(capacity_bytes=64)
        return [tier.put("big", np.zeros(64, np.float32)), tier.rejects,
                len(tier)]

    assert both(run) == [False, 1, 0]


def test_double_buffer_pending_then_sync():
    def run(cls):
        tier = cls(capacity_bytes=1024)
        tier.put("a", np.ones(4, np.float32))
        # the transfer is parked in the one-slot pending buffer; its bytes
        # land only once the NEXT put (or an explicit sync) drains it
        trace = [tier._pending is not None, tier.used_bytes]
        tier.put("b", np.ones(4, np.float32))
        trace.append(tier.used_bytes)
        tier.sync()
        return trace + [tier.used_bytes, len(tier)]

    assert both(run) == [True, 0, 16, 32, 2]


def test_discard_cancels_pending_transfer():
    def run(cls):
        tier = cls(capacity_bytes=1024)
        tier.put("a", np.ones(4, np.float32))
        tier.discard("a")
        return ["a" in tier, tier.used_bytes, tier.stats()]

    assert both(run)[:2] == [False, 0]


def test_pop_releases_bytes_and_stats():
    def run(cls):
        tier = cls(capacity_bytes=1024)
        tier.put("a", np.ones(4, np.float32))
        first = tier.pop("a")
        return [int(first.nbytes), tier.pop("a"), tier.used_bytes,
                tier.stats()]

    nbytes, second, used, stats = both(run)
    assert (nbytes, second, used) == (16, None, 0)
    assert set(stats) == {"capacity_bytes", "used_bytes", "entries", "puts",
                          "evictions", "rejects", "swap_out_bytes"}
    assert stats["swap_out_bytes"] == 16


def test_host_alloc_and_swap_out_faults():
    injection.configure("site=host_alloc,kind=exhausted,times=1")
    tier = host_tier.HostPageTier(capacity_bytes=1024)
    assert not tier.put("a", np.ones(4, np.float32))
    assert tier.rejects == 1
    assert tier.put("a", np.ones(4, np.float32))       # a one-shot fault
    injection.configure("site=kv_swap_out,kind=kv_swap,times=1")
    with pytest.raises(injection.InjectedSwapFailure):
        tier.put("b", np.ones(4, np.float32))


def test_bf16_rows_round_trip_exactly():
    """A bf16 pool's page goes to the tier as float32 and comes back into
    another block bit for bit (finite values, ±inf, subnormals, -0)."""
    eng = port_engine_for(tiny_weights(), dtype=torch.bfloat16,
                          host_tier_mb=1.0)
    gen = torch.Generator().manual_seed(0)
    bits = torch.randint(-2 ** 15, 2 ** 15, eng.kv.pages.shape,
                         generator=gen, dtype=torch.int32).to(torch.int16)
    words = bits.view(torch.bfloat16)
    # NaN words would narrow to the canonical NaN; KV rows are finite
    words[torch.isnan(words)] = 0.0
    flat = words.view(-1)
    flat[:6] = torch.tensor([float("inf"), -float("inf"), -0.0, 1e-40,
                             -1e-40, 3.0e38], dtype=torch.bfloat16)
    eng.kv.pages.copy_(words)
    src, dst = 0, 5
    rows = eng.kv.pages[eng.kv.phys_pages([src])]
    assert eng.host_tier.put(("prefix", (1,)), rows)
    back = eng.host_tier.get(("prefix", (1,)))
    assert back.dtype == torch.float32
    eng._write_page_rows(dst, back)
    got = eng.kv.pages[eng.kv.phys_pages([dst])]
    assert torch.equal(got.view(torch.int16), rows.view(torch.int16))


# --------------------------------------------------------------------- #
# Engine level: sequence swap, prefix spill and graft-back
# --------------------------------------------------------------------- #
SWAP = dict(num_blocks=24, max_seqs=4, prefix_cache=True, host_tier_mb=8.0)
PROMPT = [(13 + i) % 250 + 1 for i in range(30)]             # 4 pages
SYS17 = [(3 * i) % 250 + 1 for i in range(17)]               # 2 full pages
SYS_PROMPTS = [SYS17 + [21, 22], SYS17 + [33, 34, 35]]


def _export_rows(eng, ship_mod, uid, tokens):
    return host(ship_mod.export_kv(eng, uid, tokens).rows)


def _sequence_swap(eng, ship_mod, uid):
    """Prefill + one window, spill, flush, restore (or fail to and
    recompute), then 8 more tokens."""
    start = admit(eng, uid, PROMPT, 16)
    out = decode(eng, uid, int(prefill(eng, uid, PROMPT, start).argmax()), 5)
    cached = PROMPT + out[:-1]                 # the rows in the cache
    before = _export_rows(eng, ship_mod, uid, cached)
    parked = eng.kv_swap.spill(uid, cached)
    eng.flush([uid])
    resume = PROMPT + out
    restored = eng.kv_swap.restore(uid, resume)
    if restored:
        after = _export_rows(eng, ship_mod, uid, cached)
        same = bool(np.array_equal(before[:, :restored],
                                   after[:, :restored]))
        need = min(len(resume) + 12, eng.config.max_ctx)
        seq = eng.state_manager.get_sequence(uid)
        assert eng.state_manager.maybe_allocate_kv(seq, need - restored)
        start = restored
    else:
        # recompute: admission grafts what the trie still holds
        same = None
        start = admit(eng, uid, resume, 12)
    logits = prefill(eng, uid, resume, start)
    out2 = decode(eng, uid, int(logits.argmax()), 8)
    retire(eng, uid, resume)
    st = eng.kv_swap.stats()
    return {"parked": parked, "restored": restored, "rows_equal": same,
            "tokens": out + out2, "logits": logits,
            "swapped_in": st["swapped_in"], "misses": st["misses"]}


def _prefix_swap(eng):
    first = serve(eng, 10, SYS_PROMPTS[0], 9)
    saved = {b: page_rows(eng, b) for b in eng.prefix_cache.cached_blocks()}
    eng.prefix_cache.evict(100)                   # park the chain host-side
    spilled = eng.kv_swap.prefix_spilled
    left = eng.prefix_cache.cached_blocks()
    uid, prompt = 11, SYS_PROMPTS[1]
    matched = admit(eng, uid, prompt, 9)
    grafted = eng.state_manager.get_sequence(uid).blocks[:matched // BS]
    rows = [page_rows(eng, b) for b in grafted]
    logits = prefill(eng, uid, prompt, matched)
    tokens = decode(eng, uid, int(logits.argmax()), 9)
    retire(eng, uid, prompt)
    return {"first": first["tokens"], "spilled": spilled, "left": left,
            "matched": matched, "restored": eng.kv_swap.prefix_restored,
            "tokens": tokens, "rows": rows, "saved": saved}


def _swaps(eng, ship_mod, inj):
    """On one engine: a sequence swap, the same with an injected
    ``kv_swap_in`` failure, then a prefix chain spilled and grafted back."""
    out = {"seq": _sequence_swap(eng, ship_mod, 0)}
    inj.configure("site=kv_swap_in,kind=kv_swap,times=1")
    try:
        out["fail"] = _sequence_swap(eng, ship_mod, 1)
        out["fires"] = dict(inj.get_injector().fires)
    finally:
        inj.clear()
    out["prefix"] = _prefix_swap(eng)
    return out


@pytest.fixture(scope="module")
def jax_swaps():
    return _swaps(jax_engine_for(tiny_weights(), **SWAP), jax_ship,
                  jax_injection)


@pytest.fixture(scope="module")
def port_swaps():
    return _swaps(port_engine_for(tiny_weights(), **SWAP), kv_ship, injection)


def test_sequence_spill_restore_bit_exact(jax_swaps, port_swaps):
    got, ref = port_swaps["seq"], jax_swaps["seq"]
    assert got["parked"] == ref["parked"] == len(PROMPT) + 4
    assert got["restored"] == ref["restored"] == got["parked"]
    assert got["rows_equal"] and ref["rows_equal"]
    assert got["swapped_in"] == 1
    assert got["tokens"] == ref["tokens"]
    # the swapped stream equals an uninterrupted one
    plain = port_engine_for(tiny_weights())
    admit(plain, 0, PROMPT, 16)
    assert got["tokens"] == decode(
        plain, 0, int(prefill(plain, 0, PROMPT, 0).argmax()), 13)


def test_injected_swap_in_falls_back_to_recompute(jax_swaps, port_swaps):
    got, ref = port_swaps["fail"], jax_swaps["fail"]
    assert got["restored"] == ref["restored"] == 0
    assert got["misses"] == ref["misses"] == 1
    assert got["tokens"] == ref["tokens"] == port_swaps["seq"]["tokens"]
    assert port_swaps["fires"] == jax_swaps["fires"] == \
        {"kv_swap_in:kv_swap": 1}


def test_prefix_spill_and_graft_back_bit_exact(jax_swaps, port_swaps):
    got, ref = port_swaps["prefix"], jax_swaps["prefix"]
    assert got["spilled"] == ref["spilled"] >= 2
    assert got["left"] == ref["left"] == []
    assert got["matched"] == ref["matched"] >= 2 * BS
    assert got["restored"] == ref["restored"] >= 1
    # the pages written back hold the evicted pages' bits
    assert len(got["rows"]) == 2
    for rows in got["rows"]:
        assert any(np.array_equal(rows, saved)
                   for saved in got["saved"].values())
    assert got["tokens"] == ref["tokens"]
    assert got["tokens"] == serve(port_engine_for(tiny_weights()), 0,
                                  SYS_PROMPTS[1], 9)["tokens"]


def test_coldest_first_spills_a_contiguous_prefix():
    def held(cold_first):
        eng = port_engine_for(tiny_weights(), num_blocks=16,
                              host_tier_mb=2 * PAGE_ROW_BYTES / 1e6)
        admit(eng, 0, PROMPT, 8)
        prefill(eng, 0, PROMPT, 0)
        pages = np.asarray(eng.state_manager.get_sequence(0).blocks[:4])
        cold, hot = (pages[:2], pages[2:]) if cold_first else \
            (pages[2:], pages[:2])
        eng.heat._last[cold] = eng.heat.window - 100
        eng.heat._last[hot] = eng.heat.window
        return eng, eng.kv_swap.spill(0, PROMPT)

    eng, n = held(cold_first=True)
    assert n == 2 * BS and eng.kv_swap.swapped_out == 1
    assert eng.host_tier.stats()["puts"] == 1
    # cold pages that are not a prefix are useless to a restore
    eng, n = held(cold_first=False)
    assert n == 0 and eng.host_tier.stats()["puts"] == 0


SYS24 = [(5 * i) % 250 + 1 for i in range(3 * BS)]            # 3 full pages


def test_graft_back_into_a_full_pool_spares_the_matched_chain():
    """A graft back from the host tier when the pool is full. The
    system prompt's chain keeps two pages on the card, its tail spilled to
    the host; another request holds every other block. Making room for the
    page written back may evict only a page the graft does not read: the
    chain's tail on the card is a childless trie-only leaf, and evicting it
    would hand its block back for the page written back, two pages on one
    block. (The JAX engine evicts it; this case holds the port against a
    cold engine.) With no other victim the graft stops at the two pages,
    and the request's tokens equal the cold engine's."""
    eng = port_engine_for(tiny_weights(), num_blocks=6, prefix_cache=True,
                          host_tier_mb=8.0)
    serve(eng, 0, SYS24, 4)
    cache, al = eng.prefix_cache, eng.state_manager.allocator
    assert len(cache.cached_blocks()) == 3
    # another request reserves 4 blocks: the trie gives up its LRU leaf,
    # the chain's tail, which spills to the host
    assert admit(eng, 1, [200 + i for i in range(20)], 12) == 0
    assert eng.kv_swap.prefix_spilled == 1 and al.free_blocks == 0
    prompt = SYS24 + [7, 9]
    matched = eng.graft_prefix(2, prompt)
    assert matched == 2 * BS
    seq = eng.state_manager.get_sequence(2)
    cached = cache.cached_blocks()
    assert len(set(cached)) == len(cached) == 2
    assert set(seq.blocks) == set(cached)
    assert [al.refcount(b) for b in seq.blocks] == [2, 2]
    eng.flush([1])
    assert eng.state_manager.maybe_allocate_kv(
        seq, len(prompt) + 4 - matched)
    logits = prefill(eng, 2, prompt, matched)
    tokens = decode(eng, 2, int(logits.argmax()), 4)
    retire(eng, 2, prompt)
    assert tokens == serve(port_engine_for(tiny_weights()), 0, prompt,
                           4)["tokens"]

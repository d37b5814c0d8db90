"""The port's radix prefix cache against the JAX package's, on the CPU.

The allocator's refcounts and the token trie (match, first-committer-wins
commit, LRU eviction of trie-only leaves, reclaimable counts) take the
same operations in both packages and must give the same answers; the
cases mirror ``tests/unit/test_prefix_cache.py``'s. Then both engines
serve the same requests in the lifecycle scheduler's call order
(``tests/torch_serving.py``): greedy tokens identical, the same tokens
grafted and pages skipped, first-token logits within 1e-4 (abs and rel,
float32 over two layers, as ``test_torch_engine.py`` holds them), a
copy-on-write graft leaving the shared page's bits unchanged, and
eviction under a 6-block pool keeping admission alive.
"""
import numpy as np
import pytest

from deepspeed_tpu.inference.v2.ragged import blocked_allocator as jax_alloc
from deepspeed_tpu.inference.v2.ragged import prefix_cache as jax_prefix
from deepspeed_tpu_torch import RaggedInferenceEngineConfig
from deepspeed_tpu_torch.inference.v2.ragged import blocked_allocator
from deepspeed_tpu_torch.inference.v2.ragged import prefix_cache

from .torch_serving import (BS, LOGITS_TOL, admit, decode, jax_engine_for,
                            page_rows, port_engine_for, prefill, retire,
                            serve, tiny_weights)

pytestmark = pytest.mark.torch_port

PACKAGES = {"jax": (jax_alloc, jax_prefix),
            "port": (blocked_allocator, prefix_cache)}
SYS_PROMPT = [7, 3, 9, 4, 11, 6, 2, 8, 13, 5, 1]       # 1 full page + 3
PROMPTS = [SYS_PROMPT + [21, 22], SYS_PROMPT + [33, 34, 35]]
NEW = 9                  # 8 decode tokens: two windows of 4


def both(scenario):
    """Run ``scenario(allocator_module, cache_module)`` in each package;
    the two traces must be equal. → the trace."""
    traces = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert traces["port"] == traces["jax"]
    return traces["port"]


# --------------------------------------------------------------------- #
# Allocator refcounts
# --------------------------------------------------------------------- #
def test_allocate_ref_free_lifecycle():
    def run(al_mod, _):
        al = al_mod.BlockedAllocator(4)
        blocks = [int(b) for b in al.allocate(2)]
        trace = [al.free_blocks, [al.refcount(b) for b in blocks]]
        al.ref(blocks)                          # second holder
        al.free(blocks)                         # first holder releases
        trace += [al.free_blocks, [al.refcount(b) for b in blocks]]
        al.free(blocks)                         # last holder releases
        trace += [al.free_blocks, al.refcounts().tolist()]
        return trace

    assert both(run) == [2, [1, 1], 2, [1, 1], 4, [0, 0, 0, 0]]


@pytest.mark.parametrize("case", ["ref_free", "double_free"])
def test_misuse_raises_alike(case):
    def run(al_mod, _):
        al = al_mod.BlockedAllocator(2)
        try:
            if case == "ref_free":
                al.ref([0])
            else:
                b = al.allocate(1)
                al.free(b)
                al.free(b)
        except ValueError as e:
            return str(e)
        return None

    msg = both(run)
    assert msg == ("ref of free block 0" if case == "ref_free"
                   else "free of already-free block 0")


def test_shared_block_not_reallocated_until_released():
    def run(al_mod, _):
        al = al_mod.BlockedAllocator(2)
        blocks = [int(b) for b in al.allocate(2)]
        al.ref([blocks[0]])
        al.free(blocks)
        return blocks, [int(b) for b in al.allocate(1)]

    blocks, got = both(run)
    assert got == [blocks[1]]       # block 0 is still held by the ref


# --------------------------------------------------------------------- #
# Trie mechanics (no engine)
# --------------------------------------------------------------------- #
def _mk(al_mod, pc_mod, num_blocks=16):
    al = al_mod.BlockedAllocator(num_blocks)
    return al, pc_mod.RadixPrefixCache(al, block_size=4)


def _commit_seq(al, cache, tokens, allow_partial=True):
    n_pages = -(-len(tokens) // 4)
    blocks = [int(b) for b in al.allocate(n_pages)]
    cache.commit(tokens, blocks, allow_partial=allow_partial)
    al.free(blocks)                             # the sequence retires
    return blocks


def test_match_full_and_partial_pages():
    def run(al_mod, pc_mod):
        al, cache = _mk(al_mod, pc_mod)
        _commit_seq(al, cache, [1, 2, 3, 4, 5, 6])     # page + 2-leaf
        return [cache.match(t) for t in ([1, 2, 3, 4, 5, 6, 7],
                                         [1, 2, 3, 4, 9, 9], [9, 1, 2, 3])]

    full_partial, full, miss = both(run)
    assert (full_partial[0], len(full_partial[1]), full_partial[2]) == \
        (6, 2, 2)
    assert (full[0], len(full[1]), full[2]) == (4, 1, 0)
    assert miss == (0, [], 0)


def test_match_leaves_one_token_to_prefill():
    def run(al_mod, pc_mod):
        al, cache = _mk(al_mod, pc_mod)
        _commit_seq(al, cache, [1, 2, 3, 4])
        return [cache.match([1, 2, 3, 4])[0], cache.match([1, 2, 3, 4, 5])[0]]

    assert both(run) == [0, 4]


def test_commit_dedup_first_committer_wins():
    def run(al_mod, pc_mod):
        al, cache = _mk(al_mod, pc_mod)
        b1 = _commit_seq(al, cache, [1, 2, 3, 4])
        free_before, nodes = al.free_blocks, cache.nodes
        b2 = [int(b) for b in al.allocate(1)]
        inserted = cache.commit([1, 2, 3, 4], b2)     # already attested
        al.free(b2)
        return [inserted, cache.nodes == nodes, al.free_blocks == free_before,
                cache.match([1, 2, 3, 4, 5])[1] == [b1[0]]]

    assert both(run) == [0, True, True, True]


def test_evict_lru_leaf_only_at_refcount_one():
    def run(al_mod, pc_mod):
        al, cache = _mk(al_mod, pc_mod, num_blocks=8)
        _commit_seq(al, cache, [1, 2, 3, 4, 5, 6, 7, 8])   # chain of 2
        _commit_seq(al, cache, [9, 10, 11, 12])
        trace = [cache.nodes]
        _, blocks, _ = cache.match([9, 10, 11, 12, 13])
        al.ref(blocks)                   # a live holder pins its page
        trace += [cache.evict(8), cache.nodes, sorted(cache.cached_blocks())]
        al.free(blocks)
        trace += [cache.evict(8), al.free_blocks, cache.evicted]
        return trace

    trace = both(run)
    assert trace[:3] + trace[4:] == [3, 2, 1, 1, 8, 3]


def test_reclaimable_counts_cold_chains():
    def run(al_mod, pc_mod):
        al, cache = _mk(al_mod, pc_mod)
        _commit_seq(al, cache, [1, 2, 3, 4, 5, 6, 7, 8])
        trace = [cache.reclaimable_blocks()]
        _, blocks, _ = cache.match([1, 2, 3, 4, 9])
        al.ref(blocks)                   # pin the interior page
        trace.append(cache.reclaimable_blocks())
        al.free(blocks)
        return trace

    assert both(run) == [2, 1]


# --------------------------------------------------------------------- #
# Engine level: graft, commit, copy-on-write, eviction
# --------------------------------------------------------------------- #
SYS_B = [17, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61]   # 1 full page + 3
SYS_C = [90 + i for i in range(10)]                      # 1 full page + 2
STAGGERED = [SYS_C + [21, 22], SYS_C + [33, 34, 35]]
COW = SYS_B + [21, 40, 41]


def _shared(eng):
    """Three scenarios on one engine, each on its own system prompt:
    sequential requests sharing a prompt (then the refcount baseline: only
    the trie holds cached pages), a copy-on-write graft of a partial page,
    and a request grafting a prefix its co-tenant committed at prefill end
    while that one still decodes (live sharing)."""
    out = {"sequential": [serve(eng, u, p, NEW)
                          for u, p in enumerate(PROMPTS)]}
    al = eng.state_manager.allocator
    cached = sorted(eng.prefix_cache.cached_blocks())
    out["cached"] = cached
    out["refs"] = [al.refcount(b) for b in cached]
    out["free"] = eng.state_manager.free_blocks

    out["cow_first"] = serve(eng, 2, SYS_B + [21], NEW)
    m, blocks, partial = eng.prefix_cache.match(COW)
    before = page_rows(eng, blocks[-1])
    out["cow_match"] = (m, partial)
    out["cow"] = serve(eng, 3, COW, NEW)
    out["cow_unchanged"] = bool(np.array_equal(before,
                                               page_rows(eng, blocks[-1])))

    p0, p1 = STAGGERED
    m0 = admit(eng, 4, p0, NEW)
    s0 = int(prefill(eng, 4, p0, m0).argmax())
    m1 = admit(eng, 5, p1, NEW)
    out["stag_matched"] = m1
    out["stag_refs"] = [
        al.refcount(b)
        for b in eng.state_manager.get_sequence(5).blocks[:m1 // BS]]
    l1 = prefill(eng, 5, p1, m1)
    out["stag_logits"] = l1
    out["stag_tokens"] = [decode(eng, 4, s0, NEW),
                          decode(eng, 5, int(l1.argmax()), NEW)]
    retire(eng, 4, p0)
    retire(eng, 5, p1)
    return out


EVICT_PROMPTS = [[10 + i] * 9 for i in range(4)]     # 2 pages each


def _eviction(eng):
    runs, used = [], []
    for u, p in enumerate(EVICT_PROMPTS):
        runs.append(serve(eng, u, p, NEW))
        used.append(eng.kv_used_fraction())    # the trie's pages count
    return {"tokens": [r["tokens"] for r in runs], "used": used,
            "evicted": eng.prefix_cache.evicted,
            "free": eng.state_manager.free_blocks}


@pytest.fixture(scope="module")
def weights():
    return tiny_weights()


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The engine-level scenarios on the JAX engine, once."""
    return {"shared": _shared(jax_engine_for(weights, prefix_cache=True)),
            "eviction": _eviction(jax_engine_for(weights, prefix_cache=True,
                                                 num_blocks=6))}


@pytest.fixture(scope="module")
def port_runs(weights):
    eng = port_engine_for(weights, prefix_cache=True)
    return {"shared": _shared(eng), "transfers": eng.heat.transfers,
            "eviction": _eviction(port_engine_for(weights, prefix_cache=True,
                                                  num_blocks=6))}


def _cold(weights, prompt):
    return serve(port_engine_for(weights), 9, prompt, NEW)["tokens"]


def test_config_takes_the_pool_size(weights):
    eng = port_engine_for(weights, num_blocks=6)
    assert RaggedInferenceEngineConfig(num_blocks=6).num_blocks == 6
    assert eng.kv.config.num_blocks == 6
    assert eng.state_manager.free_blocks == 6
    assert tuple(eng.kv.pages.shape)[0] == 6 * eng.cfg.num_layers + 1


def test_graft_and_commit_match_jax(weights, jax_runs, port_runs):
    got, ref = port_runs["shared"], jax_runs["shared"]
    for g, r, p in zip(got["sequential"], ref["sequential"], PROMPTS):
        assert g["tokens"] == r["tokens"]
        assert g["matched"] == r["matched"]
        np.testing.assert_allclose(g["logits"], r["logits"], atol=LOGITS_TOL,
                                   rtol=LOGITS_TOL)
        # grafting changes no token against a cold engine
        assert g["tokens"] == _cold(weights, p)
    # request 1 skipped the system prompt's full page
    assert got["sequential"][0]["matched"] == 0
    assert got["sequential"][1]["matched"] // BS >= 1
    assert got["cached"] == ref["cached"] and got["free"] == ref["free"]
    assert got["refs"] == [1] * len(got["cached"])


def test_staggered_requests_share_live_pages(jax_runs, port_runs):
    got, ref = port_runs["shared"], jax_runs["shared"]
    assert got["stag_matched"] == ref["stag_matched"] >= BS
    # the decoding co-tenant, the trie and the grafting request
    assert got["stag_refs"] == ref["stag_refs"] == [3]
    assert got["stag_tokens"] == ref["stag_tokens"]
    np.testing.assert_allclose(got["stag_logits"], ref["stag_logits"],
                               atol=LOGITS_TOL, rtol=LOGITS_TOL)


def test_partial_page_graft_is_copy_on_write(weights, jax_runs, port_runs):
    got, ref = port_runs["shared"], jax_runs["shared"]
    m, partial = got["cow_match"]
    assert got["cow_match"] == ref["cow_match"] and partial > 0
    assert m == len(SYS_B) + 1
    assert got["cow"]["matched"] == ref["cow"]["matched"] == m
    assert got["cow_unchanged"] and ref["cow_unchanged"], \
        "a grafting request wrote the shared partial page"
    assert got["cow"]["tokens"] == ref["cow"]["tokens"] == \
        _cold(weights, COW)
    assert port_runs["transfers"] == 1    # the copy inherited the page heat


def test_eviction_keeps_admission_alive(weights, jax_runs, port_runs):
    got, ref = port_runs["eviction"], jax_runs["eviction"]
    assert got == ref
    assert got["evicted"] >= 1
    assert got["tokens"] == [_cold(weights, p) for p in EVICT_PROMPTS]

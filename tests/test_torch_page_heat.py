"""The port's KV page-heat tracker against the JAX package's, on the CPU.

The tracker core takes the same allocator operations, ticks and touches
in both packages and must give equal snapshots, ages and histograms (the
cases mirror ``tests/unit/test_mem_obs.py``'s tracker and prefix-accounting
tests). Both engines then run the same put / decode / graft / copy-on-write
/ flush sequence: the heat snapshots at every settle point, the page ages
and the heat transfer on copy-on-write are equal, and the tracker's live
set is the allocator's.
"""
import ast
import os

import numpy as np
import pytest

from deepspeed_tpu.inference.v2.ragged import blocked_allocator as jax_alloc
from deepspeed_tpu.inference.v2.ragged import page_heat as jax_heat
from deepspeed_tpu_torch.inference.v2.ragged import blocked_allocator
from deepspeed_tpu_torch.inference.v2.ragged import page_heat

from .torch_serving import jax_engine_for, port_engine_for, tiny_weights

pytestmark = pytest.mark.torch_port

PACKAGES = {"jax": (jax_alloc, jax_heat), "port": (blocked_allocator,
                                                   page_heat)}
SYS = [7, 3, 9, 4, 11, 6, 2, 8, 13, 5, 1, 12, 15, 10, 14, 16]  # 2 pages


def both(scenario):
    traces = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert traces["port"] == traces["jax"]
    return traces["port"]


def _mk(al_mod, heat_mod, n=8, page_bytes=100):
    al = al_mod.BlockedAllocator(n)
    heat = heat_mod.PageHeatTracker(al, block_size=4, page_bytes=page_bytes)
    al.heat = heat
    return al, heat


def _alloc_live(al):
    return {i for i, r in enumerate(al.refcounts()) if r > 0}


# --------------------------------------------------------------------- #
# Tracker core (allocator only)
# --------------------------------------------------------------------- #
def test_live_set_tracks_allocator():
    def run(*mods):
        al, heat = _mk(*mods)
        blocks = [int(b) for b in al.allocate(3)]
        trace = [heat.live_pages() == _alloc_live(al) == set(blocks)]
        al.free(blocks[:1])
        trace.append(heat.live_pages() == _alloc_live(al))
        al.free(blocks[1:])
        trace.append(heat.live_pages() == set() == _alloc_live(al))
        return trace

    assert both(run) == [True, True, True]


def test_aging_cold_sets_and_retouch_histogram():
    def run(*mods):
        al, heat = _mk(*mods)
        blocks = [int(b) for b in al.allocate(3)]
        for _ in range(5):
            heat.tick()
        trace = [heat.cold_pages(4)]
        heat.touch(blocks[:1])                         # a would-be host hit
        trace += [dict(heat.retouch_ages), heat.cold_pages(4),
                  heat.snapshot()]
        return trace

    cold0, retouch, cold1, snap = both(run)
    assert (cold0, retouch, cold1) == (3, {5: 1}, 2)
    assert snap["cold_pages"]["4"] == 2 and snap["retouch_ages"] == {"5": 1}
    assert snap["used_bytes"] == 3 * 100


def test_touch_of_free_page_raises():
    def run(*mods):
        al, heat = _mk(*mods)
        b = [int(x) for x in al.allocate(1)]
        al.free(b)
        with pytest.raises(ValueError, match="non-live") as e:
            heat.touch(b)
        return str(e.value)

    both(run)


def test_transfer_inherits_heat():
    def run(*mods):
        al, heat = _mk(*mods)
        src, dst = (int(b) for b in al.allocate(2))
        heat.tick()
        heat.tick()
        heat.touch([src])                   # src hot, dst 2 windows old
        heat.transfer(src, dst)
        ages = heat.snapshot()["page_ages"]
        return [ages[src], ages[dst], heat.transfers]

    assert both(run) == [0, 0, 1]


def test_shared_page_counted_once_and_fractionally():
    def run(*mods):
        al, heat = _mk(*mods)
        a, b = (int(x) for x in al.allocate(2))
        al.ref([a])                          # a second holder of page a
        return heat.snapshot(holders={1: [a, b], 2: [a]},
                             tenants={1: "alice", 2: "bob"})

    snap = both(run)
    assert snap["live_pages"] == 2 and snap["used_bytes"] == 200
    assert snap["shared_pages"] == 1
    assert snap["prefix_shared_bytes_saved"] == 100
    assert snap["tenants"] == {"alice": {"pages": 1.5, "bytes": 150},
                               "bob": {"pages": 0.5, "bytes": 50}}


def test_page_ages_for_reports_minus_one_for_free_pages():
    def run(*mods):
        al, heat = _mk(*mods, n=4)
        blocks = [int(b) for b in al.allocate(2)]
        heat.tick()
        heat.tick()
        heat.touch([blocks[0]])
        return heat.page_ages_for(blocks + [3]).tolist()

    assert both(run) == [0, 2, -1]


def test_tracker_adds_no_device_work():
    """The tracker is numpy on the host: its module imports no torch, so
    it can neither launch work on the card nor wait for it."""
    path = page_heat.__file__
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {(n.module or "").split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert "torch" not in mods and "numpy" in mods, (os.path.basename(path),
                                                     mods)


# --------------------------------------------------------------------- #
# Engine level
# --------------------------------------------------------------------- #
ENGINE = dict(max_seqs=8, num_blocks=24, prefix_cache=True)


def _heat_sequence(eng):
    """put / decode / graft / copy-on-write / flush, with a heat snapshot
    and the page ages at each settle point."""
    al = eng.state_manager.allocator
    out = []

    def settle(tag, blocks=()):
        assert set(eng.heat.live_pages()) == _alloc_live(al), tag
        out.append((tag, eng.memory_snapshot(),
                    eng.heat.page_ages_for(list(blocks)).tolist()))

    # seed the trie: SYS prefilled once and retired
    toks = SYS
    eng.put([90], [toks])
    eng.commit_prefix(90, toks, allow_partial=True)
    eng.flush([90])
    settle("seeded")
    # two tenants graft the same 2-page system prompt
    for uid, tenant in ((1, "alice"), (2, "bob")):
        prompt = SYS + [30 + uid]
        matched = eng.graft_prefix(uid, prompt)
        out.append(("matched", matched))
        eng.set_tenant(uid, tenant)
        eng.put([uid], [prompt[matched:]])
    seqs = {u: list(eng.state_manager.get_sequence(u).blocks) for u in (1, 2)}
    settle("grafted", seqs[1] + seqs[2])
    eng.decode_batch([1, 2], [9, 11], 4)
    settle("decoded", seqs[1] + seqs[2])
    # a partial tail page committed, then grafted: copy-on-write
    base = SYS[:11] + [44]
    eng.put([91], [base])
    eng.commit_prefix(91, base, allow_partial=True)
    eng.flush([91])
    before = eng.heat.transfers
    matched = eng.graft_prefix(5, base + [45, 46])
    out.append(("cow", matched, eng.heat.transfers - before))
    settle("cow", eng.state_manager.get_sequence(5).blocks)
    eng.flush([1, 2, 5])
    settle("flushed")
    return out


@pytest.fixture(scope="module")
def jax_sequence():
    return _heat_sequence(jax_engine_for(tiny_weights(), **ENGINE))


def test_heat_snapshots_match_jax(jax_sequence):
    got = _heat_sequence(port_engine_for(tiny_weights(), **ENGINE))
    assert len(got) == len(jax_sequence)
    for g, r in zip(got, jax_sequence):
        assert g == r, g[0]
    snaps = {g[0]: g[1] for g in got if len(g) == 3}
    # the 2 system-prompt pages are held by the trie and both tenants,
    # counted once physically
    assert snaps["grafted"]["shared_pages"] >= 2
    assert set(snaps["grafted"]["tenants"]) == {"alice", "bob"}
    assert dict(g[:2] for g in got if g[0] == "matched")["matched"] >= 16
    cow = next(g for g in got if g[0] == "cow")
    assert cow[1] > 0 and cow[2] == 1    # one heat transfer for the copy


def test_memory_ledger_hook_waits_for_the_telemetry_plane():
    eng = port_engine_for(tiny_weights())
    with pytest.raises(NotImplementedError, match="M11"):
        eng.register_memory_sources(object())


def test_tracking_off_is_inert():
    eng = port_engine_for(tiny_weights(), track_page_heat=False)
    eng.put([1], [[3, 5, 7]])
    assert eng.heat is None and eng.memory_snapshot() is None
    assert eng.state_manager.allocator.heat is None
    eng.flush([1])

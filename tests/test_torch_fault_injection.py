"""The port's fault-injection harness against the JAX package's, on the CPU.

One spec string drives both packages: every kind parses, re-emits and
fires alike (the same exception type and message, the same file effects,
the same gating by ``p``, ``steps`` and ``times``), and
``DSTPU_FAULT_INJECT`` installs the plan in both. Then the serving sites:
``decode_window``/``nan`` flags the same uid on both engines, fresh and
on a window that would have resumed, while its batchmate decodes as in a
clean window; ``kv_alloc``/``exhausted`` backpressures both batchers the
same way, with the same tokens in the end.

Every test clears both packages' injectors before and after it, and the
variable is set only through ``monkeypatch``, so later tests find no
injector.
"""
import os

import numpy as np
import pytest

from deepspeed_tpu.inference.v2 import engine_v2 as jax_engine
from deepspeed_tpu.runtime.fault import injection as jax_injection
from deepspeed_tpu_torch.inference.v2 import engine_v2
from deepspeed_tpu_torch.runtime.fault import injection

from .torch_serving import host, jax_engine_for, port_engine_for, tiny_weights

pytestmark = pytest.mark.torch_port

PACKAGES = {"jax": jax_injection, "port": injection}
RAISING = ("io_error", "nan", "exhausted", "replica_down", "net_partition",
           "controller_crash", "kv_swap", "offload")


@pytest.fixture(autouse=True)
def _clean_injectors(request):
    for mod in PACKAGES.values():
        mod.clear()

    def _clear():
        for mod in PACKAGES.values():
            mod.clear()

    request.addfinalizer(_clear)


def both(scenario):
    traces = {name: scenario(mod) for name, mod in PACKAGES.items()}
    assert traces["port"] == traces["jax"]
    return traces["port"]


def test_kinds_and_variable_are_the_reference_ones():
    assert injection.KINDS == jax_injection.KINDS
    assert injection.ENV_VAR == jax_injection.ENV_VAR == "DSTPU_FAULT_INJECT"


@pytest.mark.parametrize("kind", jax_injection.KINDS)
def test_every_kind_round_trips(kind):
    text = (f"site=decode_window,kind={kind},p=0.5,times=3,steps=2|4|7,"
            f"delay=0.0,truncate_to=5,exit_code=3,seed=11")
    specs = {name: mod.FaultSpec.parse(text)
             for name, mod in PACKAGES.items()}
    assert specs["port"].manifest() == specs["jax"].manifest()
    # either package parses the other's manifest back to the same spec
    assert injection.FaultSpec.parse(specs["jax"].manifest()) == \
        specs["port"]
    assert dataclass_fields(specs["port"]) == dataclass_fields(specs["jax"])
    plan = f"{text};site=kv_alloc,kind=exhausted,times=1"
    assert injection.FaultInjector(plan).manifest() == \
        jax_injection.FaultInjector(plan).manifest()


def dataclass_fields(spec):
    return {f: getattr(spec, f) for f in ("site", "kind", "p", "times",
                                          "steps", "delay", "truncate_to",
                                          "exit_code", "seed")}


def test_bad_specs_refused_alike():
    def run(mod):
        out = []
        for text in ("kind=nan", "site=x,kind=meteor"):
            with pytest.raises(ValueError) as e:
                mod.FaultSpec.parse(text)
            out.append(str(e.value))
        return out

    both(run)


@pytest.mark.parametrize("kind", RAISING)
def test_raising_kinds_fire_alike(kind):
    def run(mod):
        mod.configure(f"site=kv_alloc,kind={kind},times=1")
        try:
            mod.inject("kv_alloc", step=4)
        except Exception as e:  # noqa: BLE001 — the kind's own exception
            caught = (type(e).__name__,
                      [c.__name__ for c in type(e).__mro__[1:3]], str(e))
        else:
            caught = None
        mod.inject("kv_alloc", step=4)        # times=1: spent
        fires = dict(mod.get_injector().fires)
        mod.clear()
        return caught, fires

    caught, fires = both(run)
    assert caught is not None and fires == {f"kv_alloc:{kind}": 1}


@pytest.mark.parametrize("kind", ["truncate", "shard_missing"])
def test_file_kinds_act_alike(kind, tmp_path):
    def run(mod):
        root = tmp_path / mod.__name__.split(".")[0]
        (root / "d").mkdir(parents=True)
        for name in ("b.bin", "a.bin"):
            (root / "d" / name).write_bytes(b"0123456789")
        target = root / "d" / "b.bin" if kind == "truncate" else root / "d"
        mod.configure(f"site=ckpt_save,kind={kind},truncate_to=4")
        mod.inject("ckpt_save", path=str(target))
        mod.clear()
        return {p.name: p.read_bytes() for p in sorted((root / "d").iterdir())}

    files = both(run)
    assert files == ({"a.bin": b"0123456789", "b.bin": b"0123"}
                     if kind == "truncate" else {"b.bin": b"0123456789"})


def test_gating_by_p_steps_and_times_alike():
    def run(mod):
        mod.configure("site=decode_window,kind=exhausted,p=0.5,seed=3,"
                      "times=4,steps=1-15")
        fired = []
        for step in range(20):
            try:
                mod.inject("decode_window", step=step)
                fired.append(False)
            except mod.InjectedExhausted:
                fired.append(True)
        return fired

    fired = both(run)
    assert sum(fired) == 4 and not fired[0]


def test_variable_installs_the_plan_in_both(monkeypatch):
    monkeypatch.setenv("DSTPU_FAULT_INJECT",
                       "site=kv_alloc,kind=exhausted,times=1")

    def run(mod):
        with pytest.raises(mod.InjectedExhausted):
            mod.inject("kv_alloc")
        mod.inject("kv_alloc")
        return mod.get_injector().manifest()

    assert both(run) == "site=kv_alloc,kind=exhausted,times=1"


# --------------------------------------------------------------------- #
# Serving sites
# --------------------------------------------------------------------- #
#: 10 and 3 tokens: two windows of 2 grow no page, so the second window
#: would resume the first's device state
PROMPTS = [[3, 5, 7, 11, 13, 17, 19, 23, 29, 31], [2, 4, 6]]
BATCH_PROMPTS = [[3, 5, 7, 11, 13], [17, 19], [23, 29, 31], [2] * 14]


def _poison_scenario(eng, mod):
    """Two sequences, a clean window, then a window under
    ``decode_window``/``nan`` that would have resumed."""
    logits = host(eng.put([0, 1], PROMPTS))
    seeds = [int(t) for t in logits.argmax(-1)]
    w1 = eng.decode_batch_async([0, 1], seeds, 2)
    first = np.asarray(w1.tokens())
    mod.configure("site=decode_window,kind=nan,times=1,steps=2")
    try:
        w2 = eng.decode_batch_async([0, 1], [int(t) for t in first[-1]], 2)
        flagged = w2.nonfinite_uids()
        toks = np.asarray(w2.tokens())
    finally:
        mod.clear()
    state_after = eng._decode_state
    eng.flush([0, 1])
    return {"first": first.tolist(), "flagged": flagged,
            "batchmate": toks[:, 1].tolist(),
            "windows": eng.decode_windows_dispatched,
            "resume_hits": eng.decode_resume_hits,
            "resumable": state_after is not None}


def _clean_batchmate(eng):
    logits = host(eng.put([0, 1], PROMPTS))
    seeds = [int(t) for t in logits.argmax(-1)]
    return np.asarray(eng.decode_batch([0, 1], seeds, 4))[2:, 1].tolist()


def _exhaustion_scenario(eng, batcher_cls, mod):
    b = batcher_cls(eng, max_new_tokens=4)
    for u, p in enumerate(BATCH_PROMPTS):
        b.add_request(u, p)
    mod.configure("site=kv_alloc,kind=exhausted,times=2")
    try:
        first = b.step()                     # the head waits, queue intact
        waiting = len(b._waiting)
        done = b.run()
        fires = dict(mod.get_injector().fires)
    finally:
        mod.clear()
    return {"first": first, "waiting": waiting, "fires": fires,
            "done": {u: list(t) for u, t in done.items()},
            "free": eng.state_manager.free_blocks}


#: one engine serves both sites' scenarios, one after the other
ENGINE = dict(max_tokens=16, num_blocks=8)


def _sites(eng, batcher_cls, mod):
    return {"poison": _poison_scenario(eng, mod),
            "exhausted": _exhaustion_scenario(eng, batcher_cls, mod)}


@pytest.fixture(scope="module")
def jax_sites():
    return _sites(jax_engine_for(tiny_weights(), **ENGINE),
                  jax_engine.ContinuousBatcher, jax_injection)


@pytest.fixture(scope="module")
def port_sites():
    return _sites(port_engine_for(tiny_weights(), **ENGINE),
                  engine_v2.ContinuousBatcher, injection)


def test_decode_window_nan_flags_the_same_uid(jax_sites, port_sites):
    got, ref = port_sites["poison"], jax_sites["poison"]
    assert got["flagged"] == ref["flagged"] == [0]
    assert got["first"] == ref["first"]
    assert got["batchmate"] == ref["batchmate"] == \
        _clean_batchmate(port_engine_for(tiny_weights(), **ENGINE))
    assert got["windows"] == ref["windows"] == 2
    assert got["resume_hits"] == ref["resume_hits"] == 1
    assert not got["resumable"] and not ref["resumable"]


def test_kv_alloc_exhaustion_backpressures_alike(jax_sites, port_sites):
    got, ref = port_sites["exhausted"], jax_sites["exhausted"]
    assert got == ref
    assert got["first"] == [] and got["waiting"] == len(BATCH_PROMPTS)
    assert got["fires"] == {"kv_alloc:exhausted": 2}
    assert got["free"] == 8
    clean = engine_v2.ContinuousBatcher(
        port_engine_for(tiny_weights(), **ENGINE), max_new_tokens=4)
    for u, p in enumerate(BATCH_PROMPTS):
        clean.add_request(u, p)
    assert got["done"] == clean.run()
    assert not os.environ.get("DSTPU_FAULT_INJECT")

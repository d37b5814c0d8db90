"""Deterministic fault-injection harness (the port's copy of
``deepspeed_tpu/runtime/fault/injection.py``, with the same grammar, kinds
and ``DSTPU_FAULT_INJECT`` variable, so one spec string drives both
packages).

Production code exposes named injection *sites* (``inject("kv_alloc")``,
``inject("decode_window", step=n)``) that are no-ops unless a
:class:`FaultInjector` is installed — programmatically or via the
``DSTPU_FAULT_INJECT`` env var, which lets a worker *subprocess* take a
fault plan without code changes.

Spec string grammar (``;`` separates specs, ``,`` separates fields)::

    DSTPU_FAULT_INJECT="site=ckpt_save,kind=io_error,times=2;site=step,kind=kill,steps=3"

Fields: ``site`` (required), ``kind`` — one of

  * ``io_error``  raise ``OSError(EIO)`` (transient storage failure),
  * ``slow``      sleep ``delay`` seconds (hung collective / straggler /
                  stuck decode window),
  * ``truncate``  truncate the file passed by the call site to
                  ``truncate_to`` bytes (torn write),
  * ``kill``      ``os._exit(exit_code)`` (worker death / preemption),
  * ``shard_missing``  delete one file (first in sorted order) under the
                  directory passed by the call site — a tensorstore shard
                  lost between commit and a (resharded) load,
  * ``nan``       raise :class:`InjectedNaN`; the call site poisons its
                  numerics (the serving engine NaNs the first scheduled
                  sequence's KV pages so the decode watchdog sees a
                  poisoned window),
  * ``exhausted`` raise :class:`InjectedExhausted`; the call site treats
                  the resource as transiently gone (the KV block allocator
                  reports allocation failure so schedulers exercise their
                  backpressure / preemption paths),
  * ``replica_down``  raise :class:`InjectedReplicaDown` (a
                  ``ConnectionError``): the transport layer must treat the
                  peer as a dead process — connection refused, reroute /
                  lost accounting,
  * ``net_partition``  raise :class:`InjectedNetPartition` (a
                  ``ConnectionError``): a transient partition the caller's
                  jittered-backoff retry should absorb before any reroute,
  * ``controller_crash``  raise :class:`InjectedControllerCrash`; the
                  ``dstpu-fleet`` control loop must die mid-tick and prove
                  it rebuilds its fleet model from live ``/healthz``
                  scrapes alone (no state file),
  * ``kv_swap``   raise :class:`InjectedSwapFailure`; the host-tier KV
                  swap path (spill or restore) must fall back to the
                  pre-tier behavior — evict + prefill recompute — with the
                  stream still bit-exact,
  * ``offload``   raise :class:`InjectedOffloadFailure`; the optimizer
                  host-offload prefetcher must skip the staged transfer
                  and let the update consume the host partition directly —

plus ``p`` (fire probability, default 1), ``times`` (max fires per process),
``steps`` (only fire at these step numbers: ``3`` | ``3-5`` | ``3|7|9``),
``delay``, ``truncate_to``, ``exit_code``, ``seed``.  Probability draws use a
per-spec ``random.Random(seed)`` so runs are reproducible.

Serving sites (wired through ``inference/v2``; ``step`` is the engine's
monotonically increasing decode-window index):

  * ``decode_window`` (kinds ``slow``/``nan``/``kill``) — fires when a
    fused decode window is dispatched: a hung window, a NaN-poisoned
    window, or worker death mid-decode;
  * ``kv_alloc`` (kind ``exhausted``) — fires when the block allocator is
    asked for NEW blocks (no-op allocations never fire), simulating a
    transiently exhausted KV pool.

Host-tier sites (wired through ``runtime/swap_tensor`` +
``inference/v2/ragged/kv_swap``):

  * ``host_alloc`` (kind ``exhausted``) — fires when the host page tier
    allocates a staging buffer for an incoming spill: the put is rejected
    and the caller takes the evict path;
  * ``kv_swap_out`` (kinds ``kv_swap``/``io_error``/``slow``) — fires at
    D2H issue, when a victim's pages are exported toward the host tier;
  * ``kv_swap_in`` (kinds ``kv_swap``/``io_error``/``slow``) — fires at
    H2D resume, before spilled rows are grafted back into fresh pages;
  * ``offload_prefetch`` (kinds ``offload``/``slow``) — fires when the
    optimizer host-offload prefetcher stages the pinned-host partition
    toward the device ahead of the sharded update.

Fleet sites (wired through ``serving/fleet``):

  * ``fleet_scrape`` (kinds ``slow``/``net_partition``/``replica_down``) —
    fires inside every router→replica ``/healthz`` probe, under the
    probe's timeout + jittered-backoff retry;
  * ``fleet_forward`` (same kinds) — fires on every router→replica
    forward (``/v1/generate`` proxy legs and the disaggregated-prefill
    KV-ship socket);
  * ``controller_scrape`` — the ``dstpu-fleet`` controller's
    controller→router ``/healthz`` / ``/traces`` calls;
  * ``controller_tick`` (kind ``controller_crash``) — the top of every
    controller decision tick.

The port wires the serving and host-tier sites (``inference/v2``,
``runtime/swap_tensor``); the fleet and checkpoint sites, and the JAX
package's fault-event counters (``runtime/fault/retry.py``), are ROADMAP
M11: here a fire is counted in :attr:`FaultInjector.fires` only.

Stdlib-only and loadable standalone (fault-injection worker scripts).
"""
from __future__ import annotations

import collections
import dataclasses
import errno
import os
import random
import time
from typing import FrozenSet, List, Optional, Sequence, Union

try:
    from ...utils.logging import logger
except ImportError:  # loaded standalone, outside the package
    import logging

    logger = logging.getLogger("deepspeed_tpu_torch.fault")

ENV_VAR = "DSTPU_FAULT_INJECT"
KINDS = ("io_error", "slow", "truncate", "kill", "shard_missing", "nan",
         "exhausted", "replica_down", "net_partition", "controller_crash",
         "kv_swap", "offload")


class InjectedNaN(ArithmeticError):
    """Raised by the ``nan`` kind: the call site must poison its own
    numerics (the injector cannot reach device buffers)."""


class InjectedExhausted(RuntimeError):
    """Raised by the ``exhausted`` kind: the call site must report its
    resource (KV blocks, queue slots) as transiently unavailable."""


class InjectedReplicaDown(ConnectionError):
    """Raised by the ``replica_down`` kind: the peer process is gone.  A
    ``ConnectionError`` subclass so the fleet transport paths (scrape /
    forward) take their real connection-refused handling: failure
    accounting toward LOST, reroute off the corpse."""


class InjectedNetPartition(ConnectionError):
    """Raised by the ``net_partition`` kind: a transient partition.  Also
    a ``ConnectionError`` so `runtime.fault.retry` policies treat it as
    retryable — a one-shot partition must degrade to a jittered-backoff
    retry, not a lost replica."""


class InjectedControllerCrash(RuntimeError):
    """Raised by the ``controller_crash`` kind: the ``dstpu-fleet``
    control loop must abandon the tick, drop ALL derived state
    (hysteresis windows, cooldown clocks), and rebuild its fleet model
    from the next live ``/healthz`` scrape."""


class InjectedSwapFailure(RuntimeError):
    """Raised by the ``kv_swap`` kind at the ``kv_swap_out``/``kv_swap_in``
    sites: the host-tier transfer failed mid-flight.  The swap machinery
    must fall back to the pre-tier semantics — spill becomes a plain evict,
    restore becomes a prefill recompute — and the resumed greedy stream
    must stay bit-exact either way."""


class InjectedOffloadFailure(RuntimeError):
    """Raised by the ``offload`` kind at the ``offload_prefetch`` site:
    the staged H2D transfer of the host optimizer partition failed.  The
    prefetcher must skip the stage and let the compiled update read the
    pinned-host partition directly (correct, just unoverlapped)."""


def truncate_file(path: str, nbytes: int = 0) -> None:
    """Simulate a torn write: keep only the first ``nbytes`` of ``path``."""
    with open(path, "rb+") as f:
        f.truncate(nbytes)


def first_file_under(root: str) -> Optional[str]:
    """Lexicographically first regular file under ``root`` (deterministic
    victim for ``shard_missing``); None when there is nothing to delete."""
    out = []
    for cur, _dirs, files in os.walk(root):
        out.extend(os.path.join(cur, fn) for fn in files)
    return min(out) if out else None


def _parse_steps(text: str) -> FrozenSet[int]:
    if "-" in text:
        lo, hi = text.split("-", 1)
        return frozenset(range(int(lo), int(hi) + 1))
    return frozenset(int(t) for t in text.split("|"))


@dataclasses.dataclass
class FaultSpec:
    site: str
    kind: str = "io_error"
    p: float = 1.0
    times: Optional[int] = None        # max fires per process; None = unlimited
    steps: Optional[FrozenSet[int]] = None
    delay: float = 0.1
    truncate_to: int = 0
    exit_code: int = 1
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; known: {KINDS}")
        self._rng = random.Random(self.seed)
        self._fired = 0

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        kw = {}
        for field in text.split(","):
            if not field.strip():
                continue
            k, _, v = field.partition("=")
            k = k.strip()
            v = v.strip()
            if k == "steps":
                kw[k] = _parse_steps(v)
            elif k in ("p", "delay"):
                kw[k] = float(v)
            elif k in ("times", "truncate_to", "exit_code", "seed"):
                kw[k] = int(v)
            else:
                kw[k] = v
        if "site" not in kw:
            raise ValueError(f"fault spec needs site=: {text!r}")
        return cls(**kw)

    def manifest(self) -> str:
        """Re-emit this spec in the ``DSTPU_FAULT_INJECT`` grammar, the
        round-trip invariant being ``FaultSpec.parse(s.manifest()) == s``
        — how a programmatic fault plan is handed to a worker subprocess
        through its environment.  Default-valued fields are elided."""
        parts = [f"site={self.site}", f"kind={self.kind}"]
        if self.p != 1.0:
            parts.append(f"p={self.p}")
        if self.times is not None:
            parts.append(f"times={self.times}")
        if self.steps is not None:
            parts.append("steps=" + "|".join(str(s)
                                             for s in sorted(self.steps)))
        for field, default in (("delay", 0.1), ("truncate_to", 0),
                               ("exit_code", 1), ("seed", 0)):
            value = getattr(self, field)
            if value != default:
                parts.append(f"{field}={value}")
        return ",".join(parts)


class FaultInjector:
    def __init__(self, specs: Union[str, Sequence[FaultSpec]] = ()):
        if isinstance(specs, str):
            specs = [FaultSpec.parse(s) for s in specs.split(";") if s.strip()]
        self.specs: List[FaultSpec] = list(specs)
        self.fires: "collections.Counter[str]" = collections.Counter()

    def manifest(self) -> str:
        """The whole plan as one env-var value (``;``-joined specs)."""
        return ";".join(s.manifest() for s in self.specs)

    def inject(self, site: str, step: Optional[int] = None,
               path: Optional[str] = None) -> None:
        """Fire every matching spec for ``site`` (called at injection points)."""
        for spec in self.specs:
            if spec.site != site:
                continue
            if spec.times is not None and spec._fired >= spec.times:
                continue
            if spec.steps is not None and (step is None or step not in spec.steps):
                continue
            if spec.p < 1.0 and spec._rng.random() >= spec.p:
                continue
            spec._fired += 1
            self.fires[f"{site}:{spec.kind}"] += 1
            self._fire(spec, site, step, path)

    def _fire(self, spec: FaultSpec, site: str, step, path) -> None:
        where = f"site={site}" + (f" step={step}" if step is not None else "")
        if spec.kind == "io_error":
            logger.warning(f"fault injection: EIO at {where}")
            raise OSError(errno.EIO, f"injected I/O error at {where}")
        if spec.kind == "slow":
            logger.warning(f"fault injection: sleeping {spec.delay}s at {where}")
            time.sleep(spec.delay)
            return
        if spec.kind == "truncate":
            if path is None:
                raise ValueError(f"truncate fault at {where} but call site "
                                 f"passed no path")
            logger.warning(f"fault injection: truncating {path} to "
                           f"{spec.truncate_to}B at {where}")
            truncate_file(path, spec.truncate_to)
            return
        if spec.kind == "shard_missing":
            if path is None:
                raise ValueError(f"shard_missing fault at {where} but call "
                                 f"site passed no path")
            victim = first_file_under(path)
            if victim is None:
                logger.warning(f"fault injection: shard_missing at {where} "
                               f"found no files under {path}")
                return
            logger.warning(f"fault injection: deleting shard {victim} "
                           f"at {where}")
            os.remove(victim)
            return
        if spec.kind == "nan":
            logger.warning(f"fault injection: NaN poison at {where}")
            raise InjectedNaN(f"injected NaN at {where}")
        if spec.kind == "exhausted":
            logger.warning(f"fault injection: resource exhausted at {where}")
            raise InjectedExhausted(f"injected exhaustion at {where}")
        if spec.kind == "replica_down":
            logger.warning(f"fault injection: replica down at {where}")
            raise InjectedReplicaDown(f"injected replica death at {where}")
        if spec.kind == "net_partition":
            logger.warning(f"fault injection: net partition at {where}")
            raise InjectedNetPartition(f"injected partition at {where}")
        if spec.kind == "controller_crash":
            logger.warning(f"fault injection: controller crash at {where}")
            raise InjectedControllerCrash(f"injected controller crash at "
                                          f"{where}")
        if spec.kind == "kv_swap":
            logger.warning(f"fault injection: KV swap failure at {where}")
            raise InjectedSwapFailure(f"injected KV swap failure at {where}")
        if spec.kind == "offload":
            logger.warning(f"fault injection: offload prefetch failure at "
                           f"{where}")
            raise InjectedOffloadFailure(f"injected offload failure at "
                                         f"{where}")
        if spec.kind == "kill":
            logger.warning(f"fault injection: killing process at {where}")
            os._exit(spec.exit_code)


_injector: Optional[FaultInjector] = None
_env_checked = False


def configure(specs: Union[str, Sequence[FaultSpec]]) -> FaultInjector:
    """Install a process-global injector (tests / DSTPU_FAULT_INJECT)."""
    global _injector, _env_checked
    _injector = FaultInjector(specs)
    _env_checked = True
    return _injector


def clear() -> None:
    global _injector, _env_checked
    _injector = None
    _env_checked = False


def get_injector() -> Optional[FaultInjector]:
    global _injector, _env_checked
    if _injector is None and not _env_checked:
        _env_checked = True
        env = os.environ.get(ENV_VAR)
        if env:
            _injector = FaultInjector(env)
    return _injector


def inject(site: str, step: Optional[int] = None,
           path: Optional[str] = None) -> None:
    """Production-code injection point; no-op unless an injector is active."""
    inj = get_injector()
    if inj is not None:
        inj.inject(site, step=step, path=path)

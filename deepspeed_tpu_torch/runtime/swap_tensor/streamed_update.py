"""The optimizer update over state that lives in host memory (the port's
form of ``offload_optimizer.device: cpu``, ``deepspeed_tpu/runtime/
engine.py:186-216``, and of Twin-Flow, ``runtime/zero/twin_flow.py``).

The JAX engine places the optimizer state in pinned host memory and lets
XLA stream it through the jitted update. Here :class:`StreamedUpdate`
does that streaming by hand. Every state leaf with a host part keeps that
part in host tensors (page-locked when the device is CUDA,
``pinned.pinned_empty``: exactly their bytes); nothing of it is resident
between steps. The host part is cut into pieces, ranges of rows
of its dim 0 of at most ``chunk_elems`` elements, and each step moves the
pieces through a ring of ``buffer_count`` device buffers:

  * the host-to-device copy of piece j+B (B the ring size) runs on its
    own stream while the update runs on piece j on the compute stream;
  * piece j's device-to-host copy runs on a third stream after its update,
    and frees its ring slot for piece j+B;
  * events order the three streams; the step's last copies are waited
    for by the next step's first ones.

Two ways a leaf's update meets its pieces, chosen per leaf:

  * **elementwise** — the optimizer's update of the leaf is elementwise
    (``_Optimizer.elementwise``): each piece is updated in its slot
    against the matching region of the parameter and gradient, then
    written back; the device part of a Twin-Flow leaf is updated where it
    lies. A region that is a contiguous, ``ALIGN``-aligned view (rows of
    dim 0) is updated in place; one that is not (a Twin-Flow split on
    another axis) is gathered into a contiguous copy, updated and
    scattered back;
  * **joined** — otherwise (Lamb's and K13's trust ratio and Muon's
    Newton–Schulz read the whole leaf): the pieces are copied into a
    device buffer of the whole leaf's state beside the device part, the
    optimizer runs on the whole leaf, and the result splits back, the
    host part going home from that buffer, as the JAX Twin-Flow wrapper
    joins and splits.

Either way the update's arithmetic and order are the resident engine's,
on the same values, so the results are bit for bit the same; only where
the operands live differs. Piece boundaries fall on multiples of
``ALIGN`` elements (64), so a slice is as aligned as the leaf (the fused
kernels need 16 bytes) and the CPU's vectorised loops split it as they
split the whole leaf.

On the CPU "host" and "device" are the same memory: the same loop runs
with plain synchronous copies and no streams or events, which is what the
CPU tests drive. On CUDA nothing falls back quietly: a failed copy or
allocation raises.

``pipeline_read`` (``host_tier.HostOffloadPrefetcher``) calls
:meth:`StreamedUpdate.stage` before the forward, which issues the first
ring's worth of host-to-device copies so that they land under the
forward and backward; the update then finds those pieces staged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..optimizer import check_state_shape
from ..zero.twin_flow import plan_leaf
from .pinned import pinned_empty

ALIGN = 64                        # elements; a piece starts on a multiple
DEFAULT_CHUNK_ELEMS = 1 << 26     # 64 Mi elements, 256 MiB of float32


@dataclasses.dataclass
class _Leaf:
    name: str
    shape: Tuple[int, ...]
    axis: int                     # split axis (0 for a whole host leaf)
    n_dev: int                    # rows of ``axis`` in device memory
    n_host: int                   # rows of ``axis`` on the host
    elementwise: bool
    dev: Tuple[torch.Tensor, ...]     # the device part (empty if none)
    host: Tuple[torch.Tensor, ...]    # the host part (empty if none)

    @property
    def resident(self) -> bool:
        return self.n_host == 0


@dataclasses.dataclass
class _Piece:
    leaf: _Leaf
    r0: int                       # rows [r0, r1) of the host part's dim 0
    r1: int
    first: bool                   # the leaf's first / last piece
    last: bool

    @property
    def shape(self) -> Tuple[int, ...]:
        host_shape = self.leaf.host[0].shape
        return (self.r1 - self.r0,) + tuple(host_shape[1:])

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


class _NoEvent:
    """The CPU's stand-in for a CUDA event: everything is synchronous."""

    def synchronize(self):
        pass


class StreamedUpdate:
    """The optimizer's state with its host part, and the update that
    streams it (see the module docstring).

    ``ratio`` 1 puts every state leaf on the host (scalars stay on the
    device); ``0 < ratio < 1`` splits each leaf by
    :func:`~..zero.twin_flow.plan_leaf`. ``optimizer`` is an
    ``_Optimizer`` whose state this object owns instead of it. A piece
    holds at most ``DEFAULT_CHUNK_ELEMS`` elements (read when the object
    is made)."""

    def __init__(self, optimizer, params: Dict[str, torch.Tensor],
                 device: torch.device, ratio: float = 1.0,
                 buffer_count: int = 4):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"offload ratio must be in (0, 1], got {ratio}")
        if buffer_count < 1:
            raise ValueError(f"buffer_count must be >= 1, got {buffer_count}")
        self.optimizer = optimizer
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.ratio = float(ratio)
        self.buffer_count = int(buffer_count)
        self.chunk_elems = max(ALIGN, DEFAULT_CHUNK_ELEMS // ALIGN * ALIGN)
        optimizer.plan(params)
        self.leaves: Dict[str, _Leaf] = {
            name: self._place(name, p) for name, p in params.items()}
        self.pieces: List[_Piece] = [
            piece for leaf in self.leaves.values() if not leaf.resident
            for piece in self._cut(leaf)]
        width = max((len(optimizer.leaf_state_names(n)) for n in params),
                    default=0)
        capacity = max((p.numel for p in self.pieces), default=0)
        self.ring: List[Tuple[torch.Tensor, ...]] = [
            tuple(torch.empty(capacity, dtype=torch.float32,
                              device=self.device) for _ in range(width))
            for _ in range(self.buffer_count if self.pieces else 0)]
        if self.cuda:
            self.h2d_stream = torch.cuda.Stream(self.device)
            self.d2h_stream = torch.cuda.Stream(self.device)
        self._loaded: Dict[int, Any] = {}      # piece index → its H2D event
        self._released: Dict[int, Any] = {}    # slot → the event freeing it
        self._done: List[Any] = []             # the last step's last events
        self._copies: List[Tuple[str, int, Any, Any]] = []

    # ------------------------------------------------------------------ #
    # Placement
    # ------------------------------------------------------------------ #
    def _empty_host(self, shape) -> torch.Tensor:
        if self.cuda:
            return pinned_empty(shape)
        return torch.empty(shape, dtype=torch.float32)

    def _place(self, name: str, p: torch.Tensor) -> _Leaf:
        opt = self.optimizer
        n_state = len(opt.leaf_state_names(name))
        shape = tuple(p.shape)
        value = opt.initial_state_value
        if n_state == 0 or not shape:
            lp = plan_leaf(shape, 0.0)
            dev = tuple(torch.full(shape, value, dtype=torch.float32,
                                   device=self.device)
                        for _ in range(n_state))
            return _Leaf(name, shape, lp.axis, shape[0] if shape else 0, 0,
                         False, dev, ())
        if self.ratio == 1.0:
            axis, n_dev, n_host = 0, 0, shape[0]
        else:
            lp = plan_leaf(shape, self.ratio)
            axis, n_dev, n_host = lp.axis, lp.n_dev, lp.n_host
        dev_shape = shape[:axis] + (n_dev,) + shape[axis + 1:]
        host_shape = shape[:axis] + (n_host,) + shape[axis + 1:]
        dev = tuple(torch.full(dev_shape, value, dtype=torch.float32,
                               device=self.device)
                    for _ in range(n_state)) if n_dev else ()
        host = tuple(self._empty_host(host_shape).fill_(value)
                     for _ in range(n_state)) if n_host else ()
        return _Leaf(name, shape, axis, n_dev, n_host, opt.elementwise(name),
                     dev, host)

    def _cut(self, leaf: _Leaf) -> List[_Piece]:
        """Row ranges of the host part's dim 0, each at most
        ``chunk_elems`` elements (one row at least), each starting on a
        multiple of ``ALIGN`` elements."""
        host_shape = leaf.host[0].shape
        rows, row = host_shape[0], math.prod(host_shape[1:])
        step = ALIGN // math.gcd(ALIGN, row) if row else 1
        per = max(step, self.chunk_elems // max(row, 1) // step * step)
        bounds = list(range(0, rows, per)) + [rows]
        return [_Piece(leaf, a, b, i == 0, i == len(bounds) - 2)
                for i, (a, b) in enumerate(zip(bounds, bounds[1:]))]

    # ------------------------------------------------------------------ #
    # Streams (no-ops on the CPU)
    # ------------------------------------------------------------------ #
    def _event(self, stream=None):
        if not self.cuda:
            return _NoEvent()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream or torch.cuda.current_stream(self.device))
        return ev

    def _wait(self, stream, event) -> None:
        if self.cuda and event is not None:
            stream.wait_event(event)

    def _on(self, stream):
        import contextlib

        return torch.cuda.stream(stream) if self.cuda \
            else contextlib.nullcontext()

    def _compute(self):
        return torch.cuda.current_stream(self.device) if self.cuda else None

    def _copy(self, kind: str, stream, dst: torch.Tensor,
              src: torch.Tensor) -> Any:
        """``dst.copy_(src)`` on ``stream`` (asynchronous between pinned
        host and device memory), timed by two events. → the end event."""
        start = self._event(stream)
        with self._on(stream):
            dst.copy_(src, non_blocking=self.cuda)
        end = self._event(stream)
        self._copies.append((kind, src.numel() * src.element_size(),
                             start, end))
        return end

    # ------------------------------------------------------------------ #
    # The step
    # ------------------------------------------------------------------ #
    def _slot_views(self, j: int, piece: _Piece) -> List[torch.Tensor]:
        n_state = len(piece.leaf.host)
        return [buf[:piece.numel].view(piece.shape)
                for buf in self.ring[j % self.buffer_count][:n_state]]

    def _load(self, j: int) -> None:
        """Issue piece j's host-to-device copies into its ring slot, once
        the slot's last user has released it."""
        if j >= len(self.pieces) or j in self._loaded:
            return
        if not self._loaded and not self._released:
            # a new cycle: the last step's write-backs and joins are done
            self._copies = []
            for ev in self._done:
                self._wait(self.h2d_stream if self.cuda else None, ev)
        piece = self.pieces[j]
        slot = j % self.buffer_count
        self._wait(self.h2d_stream if self.cuda else None,
                   self._released.pop(slot, None))
        end = None
        for dst, host in zip(self._slot_views(j, piece), piece.leaf.host):
            end = self._copy("h2d", self.h2d_stream if self.cuda else None,
                             dst, host[piece.r0:piece.r1])
        self._loaded[j] = end

    def stage(self) -> int:
        """Issue the host-to-device copies of the first ring's worth of
        pieces ahead of the update. → the bytes staged by this call."""
        before = len(self._copies) if self._loaded else 0
        for j in range(min(self.buffer_count, len(self.pieces))):
            self._load(j)
        return sum(c[1] for c in self._copies[before:])

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer update of every leaf, its host parts streamed
        through the ring."""
        opt = self.optimizer
        hyper = opt.step_hyper()
        compute = self._compute()
        for name, leaf in self.leaves.items():
            if leaf.resident:
                opt.update_leaf(params[name], grads[name], leaf.dev, hyper)
        self.stage()
        joined: Dict[str, List[torch.Tensor]] = {}
        d2h = self.d2h_stream if self.cuda else None
        for j, piece in enumerate(self.pieces):
            leaf, slot = piece.leaf, j % self.buffer_count
            p, g = params[leaf.name], grads[leaf.name]
            self._wait(compute, self._loaded.pop(j))
            bufs = self._slot_views(j, piece)
            if leaf.elementwise:
                if piece.first and leaf.n_dev:
                    self._update_region(p, g, leaf, 0, leaf.n_dev, None,
                                        leaf.dev, hyper)
                self._update_region(p, g, leaf, leaf.n_dev, leaf.n_host,
                                    piece, bufs, hyper)
                self._wait(d2h, self._event(compute))
                for buf, host in zip(bufs, leaf.host):
                    self._released[slot] = self._write_back(
                        d2h, host[piece.r0:piece.r1], buf)
            else:
                if piece.first:
                    joined[leaf.name] = self._join_buffers(leaf)
                for full, buf in zip(joined[leaf.name], bufs):
                    full.narrow(leaf.axis, leaf.n_dev, leaf.n_host)[
                        piece.r0:piece.r1].copy_(buf)
                self._released[slot] = self._event(compute)
                if piece.last:
                    self._update_joined(leaf, p, g, joined.pop(leaf.name),
                                        hyper, d2h)
            self._load(j + self.buffer_count)
        self._done = [self._event(compute), self._event(d2h)] \
            if self.pieces else []
        self._released.clear()
        opt.count += 1

    def _update_region(self, p, g, leaf: _Leaf, start: int, length: int,
                       piece: Optional[_Piece], state, hyper) -> None:
        """The elementwise update of rows ``[start, start + length)`` of
        the leaf's split axis (of a piece's rows of them) with ``state``:
        in place on an aligned contiguous view, else on a gathered copy
        scattered back."""
        pv = p.narrow(leaf.axis, start, length)
        gv = g.narrow(leaf.axis, start, length)
        if piece is not None:
            pv, gv = pv[piece.r0:piece.r1], gv[piece.r0:piece.r1]
        if pv.is_contiguous() and gv.is_contiguous() \
                and pv.storage_offset() % ALIGN == 0 \
                and gv.storage_offset() % ALIGN == 0:
            self.optimizer.update_leaf(pv, gv, state, hyper)
            return
        pc = pv.contiguous()
        self.optimizer.update_leaf(pc, gv.contiguous(), state, hyper)
        pv.copy_(pc)

    def _join_buffers(self, leaf: _Leaf) -> List[torch.Tensor]:
        full = [torch.empty(leaf.shape, dtype=torch.float32,
                            device=self.device) for _ in leaf.host]
        for buf, dev in zip(full, leaf.dev):
            buf.narrow(leaf.axis, 0, leaf.n_dev).copy_(dev)
        return full

    def _update_joined(self, leaf: _Leaf, p, g, full, hyper, d2h) -> None:
        """The optimizer on the joined leaf; the device part is copied
        back in place and the host part goes home from ``full``."""
        self.optimizer.update_leaf(p, g, tuple(full), hyper)
        for buf, dev in zip(full, leaf.dev):
            dev.copy_(buf.narrow(leaf.axis, 0, leaf.n_dev))
        self._wait(d2h, self._event(self._compute()))
        for buf, host in zip(full, leaf.host):
            if self.cuda:
                buf.record_stream(d2h)
            self._write_back(d2h, host,
                             buf.narrow(leaf.axis, leaf.n_dev, leaf.n_host))

    def _write_back(self, stream, host: torch.Tensor,
                    dev: torch.Tensor) -> Any:
        """One device-to-host copy of updated state. → its end event."""
        return self._copy("d2h", stream, host, dev)

    # ------------------------------------------------------------------ #
    # State access (checkpoints, offload_states)
    # ------------------------------------------------------------------ #
    def synchronize(self) -> None:
        """Wait until the last step's copies have landed in host memory."""
        for ev in self._done:
            ev.synchronize()

    def invalidate_staged(self) -> None:
        """Forget staged pieces (the host state changed under them)."""
        self.synchronize()
        for ev in self._loaded.values():
            ev.synchronize()
        self._loaded.clear()
        self._released.clear()

    def step_stats(self) -> Dict[str, float]:
        """The last cycle's copies (staging and step): bytes each way
        and, on CUDA, the summed milliseconds of each stream's copies."""
        self.synchronize()
        out = {"h2d_bytes": 0, "d2h_bytes": 0, "h2d_ms": None,
               "d2h_ms": None}
        for kind, nbytes, start, end in self._copies:
            out[f"{kind}_bytes"] += nbytes
            if self.cuda:
                out[f"{kind}_ms"] = (out[f"{kind}_ms"] or 0.0) + \
                    start.elapsed_time(end)
        return out

    def _joined(self, leaf: _Leaf, k: int) -> torch.Tensor:
        if leaf.resident:
            return leaf.dev[k]
        if not leaf.n_dev:
            return leaf.host[k]
        return torch.cat([leaf.dev[k].cpu(), leaf.host[k]], dim=leaf.axis)

    def named_state(self, name: str) -> Dict[str, torch.Tensor]:
        """Parameter ``name``'s whole state by layout name: the host
        tensors themselves for a leaf wholly on the host, a joined host
        copy for a Twin-Flow leaf."""
        self.synchronize()
        leaf = self.leaves[name]
        names = self.optimizer.leaf_state_names(name)
        return {s: self._joined(leaf, k) for k, s in enumerate(names)}

    def load_named_state(self, name: str, rec: Dict[str, Any]) -> set:
        """Split a checkpoint record's state into this placement. → the
        state names the record lacks."""
        self.invalidate_staged()
        leaf = self.leaves[name]
        absent = set()
        for k, sname in enumerate(self.optimizer.leaf_state_names(name)):
            if sname not in rec:
                absent.add(sname)
                continue
            value = rec[sname]
            check_state_shape(name, sname, value, leaf.shape)
            if leaf.resident:
                leaf.dev[k].copy_(value)
                continue
            if leaf.n_dev:
                leaf.dev[k].copy_(value.narrow(leaf.axis, 0, leaf.n_dev))
            leaf.host[k].copy_(value.narrow(leaf.axis, leaf.n_dev,
                                            leaf.n_host))
        return absent

    def device_state(self) -> Dict[str, torch.Tensor]:
        """The state tensors held in device memory, by a stable key."""
        return {f"{name}/dev{k}": t for name, leaf in self.leaves.items()
                for k, t in enumerate(leaf.dev)}

    def ring_buffers(self) -> List[torch.Tensor]:
        """The ring's device buffers (scratch between steps)."""
        return [buf for slot in self.ring for buf in slot]

    def pinned_bytes(self) -> int:
        """The host part's bytes (page-locked on CUDA)."""
        return sum(t.numel() * t.element_size()
                   for leaf in self.leaves.values() for t in leaf.host)

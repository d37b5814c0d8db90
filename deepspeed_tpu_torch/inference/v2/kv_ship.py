"""Live KV-page shipping between serving replicas (disaggregated prefill;
counterpart of ``deepspeed_tpu/inference/v2/kv_ship.py``).

A sequence's cache rows are exported in canonical row space
``[num_layers, n_tokens, 2*kv_heads, head_dim]`` (block tables dissolved),
shipped, and re-chunked into the RECEIVING engine's page geometry, so a
prefill replica (default page 64) can hand a prompt's KV to a decode
replica with another pool layout (say page 128) and the stream continues.

The rows of a :class:`KVShipment` are a float32 tensor on the exporting
engine's device (the JAX package keeps host numpy rows): the int8 wire
then quantizes on the device (K9a), and only the wire bytes and scales
cross to the host, a quarter of the float32 rows.

Wire formats
  * ``fp32`` — raw little-endian float32 rows; bit-exact by construction.
  * ``int8`` — the fused-wire kernels (``ops/quantizer``
    ``quant_pack_wire``/``unpack_dequant_wire``: K9a and K10a), group-wise
    max-abs scaling, one byte per value plus one f32 scale per group of
    ``INT8_GROUP``. The error is at most half a quantization step per
    element (``|x - dq| <= scale/2``), which :func:`int8_error_bound`
    exposes.

Framing: ``DSKV1`` magic + 4-byte big-endian header length + JSON header
(sorted keys) + payload. A frame equals the JAX package's for the same
rows, byte for byte, and either package decodes the other's.

The export is a READ: the exporting sequence keeps its blocks. The import
is a fresh allocation on the target, written into its page pool in place.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import struct
from typing import Dict, List, Optional

import numpy as np
import torch

from ...accelerator import get_accelerator
from ...ops.quantizer.quantizer import quant_pack_wire, unpack_dequant_wire

MAGIC = b"DSKV1"
WIRE_FORMATS = ("fp32", "int8")
INT8_GROUP = 256


@dataclasses.dataclass
class KVShipment:
    """Canonical-row-space snapshot of one sequence's cached prefix."""

    tokens: List[int]             # attested tokens; rows == len(tokens)
    num_layers: int
    num_kv_heads: int
    head_dim: int
    src_block_size: int           # informational: exporter's page geometry
    wire: str                     # "fp32" | "int8"
    rows: torch.Tensor            # [L, n, 2*KV, HD] float32, on a device

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)


@torch.inference_mode()
def export_kv(engine, uid: int, tokens: List[int],
              n_tokens: Optional[int] = None) -> KVShipment:
    """Snapshot the first ``n_tokens`` cached rows of ``uid`` (default:
    everything seen) into canonical row space, float32, on the engine's
    device. ``tokens`` are the ids whose KV those rows hold: the importer
    keeps them as the sequence's attested tokens."""
    seq = engine.state_manager.get_sequence(uid)
    if seq is None:
        raise ValueError(f"export of unknown uid {uid}")
    n = seq.seen_tokens if n_tokens is None else min(int(n_tokens),
                                                     seq.seen_tokens)
    if len(tokens) < n:
        raise ValueError(f"attested tokens ({len(tokens)}) shorter than "
                         f"rows ({n})")
    bs = engine.config.block_size
    n_pages = -(-n // bs)
    c = engine.kv.config
    # advanced indexing COPIES the pages: the shipment must not be a view
    # into the pool, whose blocks the lifecycle scheduler frees (and a
    # later forward may overwrite) right after a prefill-only export
    pages = engine.kv.pages[engine.kv.phys_pages(seq.blocks[:n_pages])]
    rows = pages.reshape(engine.cfg.num_layers, n_pages * bs,
                         2 * c.num_kv_heads, c.head_dim)[:, :n]
    return KVShipment(tokens=[int(t) for t in tokens[:n]],
                      num_layers=engine.cfg.num_layers,
                      num_kv_heads=c.num_kv_heads, head_dim=c.head_dim,
                      src_block_size=bs, wire="fp32",
                      rows=rows.to(torch.float32).contiguous())


@torch.inference_mode()
def import_kv(engine, shipment: KVShipment, uid: int) -> bool:
    """Graft a shipment into ``engine`` as a fresh sequence ``uid``,
    re-chunking canonical rows into the target's page geometry. Returns
    False on block exhaustion (the descriptor is rolled back; the caller
    retries); raises ``ValueError`` on a geometry mismatch (wrong model),
    which no retry can fix."""
    c = engine.kv.config
    if (shipment.num_layers != engine.cfg.num_layers
            or shipment.num_kv_heads != c.num_kv_heads
            or shipment.head_dim != c.head_dim):
        raise ValueError(
            f"KV shipment geometry mismatch: shipment "
            f"L{shipment.num_layers}/kv{shipment.num_kv_heads}"
            f"/hd{shipment.head_dim} vs engine L{engine.cfg.num_layers}"
            f"/kv{c.num_kv_heads}/hd{c.head_dim}")
    n = shipment.n_tokens
    sm = engine.state_manager
    seq = sm.get_or_create_sequence(uid)
    if seq.blocks or seq.seen_tokens:
        raise ValueError(f"KV import into a non-fresh sequence uid={uid}")
    if not sm.maybe_allocate_kv(seq, n):
        sm._seqs.pop(uid, None)        # roll back the empty descriptor
        return False
    bs = engine.config.block_size
    n_pages = -(-n // bs)
    pool = engine.kv.pages
    # cross devices in float32, then narrow on the pool's device: a CPU
    # tensor (a host-tier payload) is not cast on the host first
    rows = shipment.rows.to(pool.device, non_blocking=True).to(pool.dtype)
    pad = n_pages * bs - n
    if pad:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, 0, 0, pad))
    flat = rows.reshape(shipment.num_layers * n_pages, bs,
                        2 * c.num_kv_heads, c.head_dim)
    pool[engine.kv.phys_pages(seq.blocks[:n_pages])] = flat
    seq.seen_tokens = n
    seq.input_ids = list(shipment.tokens)
    engine._decode_state = None
    return True


# --------------------------------------------------------------------- #
# Wire (de)serialization
# --------------------------------------------------------------------- #
def int8_error_bound(scales, group_size: int, n: int) -> torch.Tensor:
    """Per-element absolute error bound of the int8 wire: half a
    quantization step, expanded from per-group scales to the first ``n``
    flat elements (float32, on the scales' device)."""
    s = torch.as_tensor(scales, dtype=torch.float32).reshape(-1)
    return s.repeat_interleave(group_size)[:n] * 0.5 + 1e-7


def to_wire(shipment: KVShipment, wire: str = "fp32") -> bytes:
    """Serialize for transport. ``int8`` runs the fused quantize+pack
    kernel (K9a) over the rows where they lie and copies only the wire
    bytes and scales to the host; the header carries the group geometry so
    the receiver's dequant is self-contained."""
    if wire not in WIRE_FORMATS:
        raise ValueError(f"wire must be one of {WIRE_FORMATS}, got {wire!r}")
    rows = shipment.rows
    header: Dict = {
        "tokens": [int(t) for t in shipment.tokens],
        "num_layers": int(shipment.num_layers),
        "num_kv_heads": int(shipment.num_kv_heads),
        "head_dim": int(shipment.head_dim),
        "src_block_size": int(shipment.src_block_size),
        "wire": wire,
        "shape": [int(d) for d in rows.shape],
    }
    if wire == "fp32":
        payload = rows.detach().to("cpu", torch.float32).contiguous() \
            .numpy().astype("<f4", copy=False).tobytes()
    else:
        w, scales = quant_pack_wire(rows.detach(), bits=8,
                                    group_size=INT8_GROUP)
        header["group_size"] = INT8_GROUP
        header["groups"] = int(w.shape[0])
        payload = w.cpu().numpy().tobytes() + \
            scales.cpu().numpy().astype("<f4", copy=False).tobytes()
    hdr = json.dumps(header, sort_keys=True).encode()
    return MAGIC + struct.pack(">I", len(hdr)) + hdr + payload


def read_header(data: bytes):
    """The JSON header of a DSKV1 frame and its payload bytes, read on the
    host (no device work). Raises ``ValueError`` on anything that is not a
    frame."""
    if data[:len(MAGIC)] != MAGIC or len(data) < len(MAGIC) + 4:
        raise ValueError("not a DSKV1 frame")
    (hlen,) = struct.unpack(">I", data[len(MAGIC):len(MAGIC) + 4])
    off = len(MAGIC) + 4
    try:
        header = json.loads(data[off:off + hlen])
        header["tokens"], header["shape"], header["wire"]
    except (ValueError, TypeError, KeyError) as e:
        raise ValueError(f"bad DSKV1 header: {e!r}")
    return header, data[off + hlen:]


def from_wire(data: bytes, device=None) -> KVShipment:
    """Decode a DSKV1 frame; the rows are rebuilt on ``device`` (``None``
    means CUDA; the int8 wire is dequantized there by K10a)."""
    header, payload = read_header(data)
    dev = get_accelerator().resolve_device(device)
    shape = tuple(int(d) for d in header["shape"])
    n_elems = int(np.prod(shape))
    if header["wire"] == "fp32":
        rows = torch.from_numpy(np.frombuffer(
            payload, "<f4", count=n_elems).astype(np.float32)).to(dev)
        rows = rows.reshape(shape)
    elif header["wire"] == "int8":
        groups, gs = int(header["groups"]), int(header["group_size"])
        w = np.frombuffer(payload, np.int8, count=groups * gs)
        scales = np.frombuffer(payload[groups * gs:], "<f4", count=groups)
        rows = unpack_dequant_wire(
            torch.from_numpy(w.reshape(groups, gs).copy()).to(dev),
            torch.from_numpy(scales.astype(np.float32)).reshape(
                groups, 1).to(dev),
            bits=8, shape=shape, dtype=torch.float32)
    else:
        raise ValueError(f"unknown wire {header['wire']!r} in DSKV1 frame")
    return KVShipment(tokens=[int(t) for t in header["tokens"]],
                      num_layers=int(header["num_layers"]),
                      num_kv_heads=int(header["num_kv_heads"]),
                      head_dim=int(header["head_dim"]),
                      src_block_size=int(header["src_block_size"]),
                      wire=str(header["wire"]), rows=rows)


def to_b64(shipment: KVShipment, wire: str = "fp32") -> str:
    """Frame + base64, for embedding in JSON HTTP bodies."""
    return base64.b64encode(to_wire(shipment, wire=wire)).decode()


def from_b64(data: str, device=None) -> KVShipment:
    return from_wire(base64.b64decode(data), device=device)


__all__ = ["KVShipment", "export_kv", "import_kv", "int8_error_bound",
           "to_wire", "read_header", "from_wire", "to_b64", "from_b64", "MAGIC",
           "WIRE_FORMATS", "INT8_GROUP"]

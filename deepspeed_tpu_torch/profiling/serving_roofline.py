"""Decode HBM-bandwidth rooflines for the serving engine (counterpart of
``deepspeed_tpu/profiling/serving_roofline.py``).

Decode is memory-bound, not compute-bound: each generated token streams the
whole parameter set plus the sequence's cached KV through HBM for a handful
of flops per byte.  MFU is therefore the wrong lens — the honest
utilization number for a decode window is **achieved HBM bytes/s vs the
device's peak**, broken down per kernel so a slow decode can be attributed
to the attention page walk, the weight stream, or the cache append.

The byte model is analytic: per decode step,

  * ``param_stream``     — every weight is read once per forward
    (batch-independent at decode batch sizes: the stream dominates until
    ``n_seqs`` approaches the arithmetic-intensity ridge);
  * ``decode_attention`` — each sequence reads K and V for its whole cached
    context from the page pool (K7's traffic; the dense-gather oracle
    reads the padded budget instead, which is exactly why it loses);
  * ``kv_append``        — each sequence writes one new K/V row per layer.

:func:`decode_roofline_report` turns (bytes, seconds) into per-kernel GB/s
and %-of-peak via the device table in ``profiling/roofline.py``.  The JAX
package's ``publish_decode_gauges`` needs the telemetry metrics registry,
which is not ported yet (ROADMAP M11).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from .roofline import DeviceSpec, device_spec


def decode_window_bytes(num_layers: int, num_kv_heads: int, head_dim: int,
                        kv_dtype_bytes: int, param_bytes: int,
                        n_seqs: int, steps: int,
                        mean_ctx: float) -> Dict[str, float]:
    """Analytic HBM bytes moved by one fused decode window, per kernel.

    ``mean_ctx`` is the average context length across sequences over the
    window (context grows by one per step, so callers typically pass
    ``ctx_at_window_start + steps / 2``).
    """
    kv_row = 2 * num_kv_heads * head_dim * kv_dtype_bytes
    return {
        "decode_attention": float(num_layers) * n_seqs * mean_ctx * kv_row
        * steps,
        "kv_append": float(num_layers) * n_seqs * kv_row * steps,
        "param_stream": float(param_bytes) * steps,
    }


def decode_roofline_report(bytes_by_kernel: Dict[str, float],
                           seconds: float, n_seqs: int, steps: int,
                           spec: Optional[DeviceSpec] = None
                           ) -> Dict[str, Any]:
    """Per-kernel and total decode HBM roofline for one window.

    The per-kernel %-of-peak uses the WINDOW's wall time for every kernel
    (kernels are not individually timed on-device), so each row reads as
    "this kernel alone moved X% of what the device could have streamed in
    the window" — the rows sum to the total, and the total is the classic
    achieved-vs-peak bandwidth number.
    """
    spec = spec or device_spec()
    dt = max(float(seconds), 1e-12)
    total = float(sum(bytes_by_kernel.values()))
    kernels = {}
    for name, b in bytes_by_kernel.items():
        gbps = b / dt / 1e9
        kernels[name] = {
            "bytes": float(b),
            "hbm_gbps": gbps,
            "hbm_pct_peak": 100.0 * gbps * 1e9 / spec.hbm_bandwidth,
            "pct_of_window_bytes": 100.0 * b / total if total else 0.0,
        }
    tok_s = n_seqs * steps / dt
    return {
        "device_kind": spec.kind,
        "peak_hbm_gbps": spec.hbm_bandwidth / 1e9,
        "window_s": float(seconds),
        "n_seqs": int(n_seqs),
        "steps": int(steps),
        "decode_tok_per_s": tok_s,
        "hbm_gbps": total / dt / 1e9,
        "hbm_pct_peak": 100.0 * (total / dt) / spec.hbm_bandwidth,
        "bytes_total": total,
        "kernels": kernels,
    }


def format_decode_roofline(report: Dict[str, Any]) -> str:
    """One human line for logs."""
    return (f"decode roofline [{report['device_kind']}]: "
            f"{report['decode_tok_per_s']:.1f} tok/s, "
            f"HBM {report['hbm_gbps']:.1f}/{report['peak_hbm_gbps']:.0f} "
            f"GB/s ({report['hbm_pct_peak']:.1f}% of peak) over "
            f"{report['n_seqs']} seqs × {report['steps']} steps")

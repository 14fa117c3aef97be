"""The least time of a kernel's work from its launch shapes: the larger of
its bytes over the HBM bandwidth and its operations over the peak.  Copied
from ``chip_smoke.py`` (``_attention_bound_ms``, ``_int8_bound_ms``,
``_flash_bounds``, ``_bottleneck_bound_ms``) so that a change to the program
cannot move the yardstick.  Each input byte is read once and each output
byte written once; ``dtype`` is ``"bfloat16"`` or ``"float32"``."""

from __future__ import annotations

from portbench.counts.peaks import HBM_BYTES_PER_S, PEAK_FLOPS, PEAK_INT8_OPS, PEAK_TF32_FLOPS


def attention_bound_ms(b, s, d, h, causal, dtype, itemsize, passes=1):
    """Kernels 1-3: 4 flops per (query, key, head dim), QK^T and PV, against
    q, k, v and the output each moved once.  ``passes=2`` counts a two-pass
    kernel's work instead (QK^T twice: 6 flops)."""
    pairs = h * (s * (s + 1) // 2 if causal else s * s)
    flops = (2 + 2 * passes) * b * pairs * (d // h)
    bytes_ms = 4 * b * s * d * itemsize / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    return max(bytes_ms, flops_ms), ("bytes" if bytes_ms >= flops_ms else "operations")


def int8_bound_ms(m, k, n, out_itemsize, with_bias):
    """Kernel 7: int8 operands, f32 scales and bias read once, the output
    written once; 2*M*N*K integer operations at the dense int8 peak."""
    nbytes = m * k + k * n + 4 * (m + n + (n if with_bias else 0)) + m * n * out_itemsize
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m * n * k / PEAK_INT8_OPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def flash_bounds(b, sq, skv, h, hd, causal, dtype, itemsize):
    """Kernels 4-6: the (query, key) pairs the mask keeps; 4, 6 and 8 flops
    per pair and head dim; each tensor moved once (lse and delta f32).  f32
    runs each product as three TF32 products at the TF32 peak."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    pairs *= b * h
    q_el, kv_el, stats = b * sq * h * hd, b * skv * h * hd, 4 * b * h * sq
    work = {"flash_attention": (4, 2 * q_el + 2 * kv_el, 1),
            "flash_attention_dq": (6, 3 * q_el + 2 * kv_el, 2),
            "flash_attention_dkv": (8, 2 * q_el + 4 * kv_el, 2)}
    out = {}
    for name, (flops_per, elements, n_stats) in work.items():
        bytes_ms = (elements * itemsize + n_stats * stats) / HBM_BYTES_PER_S * 1e3
        flops = flops_per * pairs * hd
        flops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        if dtype == "float32":
            flops_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
        out[name] = (max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations")
    return out


def bottleneck_bound_ms(b, h, cin, m, cout, ds, itemsize):
    """Kernels 8-9: x, the weights and f32 biases read once, the output
    written once; 2 flops per multiply-add of the block's products at the
    bf16 peak, or in f32 as three TF32 products each."""
    macs_per_px = cin * m + 9 * m * m + m * cout + (cin * cout if ds else 0)
    weight_bytes = macs_per_px * itemsize + 4 * (2 * m + cout + (cout if ds else 0))
    nbytes = b * h * h * (cin + cout) * itemsize + weight_bytes
    flops = 2 * b * h * h * macs_per_px
    if itemsize == 4:
        flops_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
    else:
        flops_ms = flops / PEAK_FLOPS["bfloat16"] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"

"""Kernel 1 (``csrc/short_attention.cu``, ``short_attn_tc_kernel`` in bf16)
in the image tower: the least time of one launch's work (the larger of its
bytes over 3.35 TB/s and its FLOPs over 989 TFLOP/s,
``counts/bounds.attention_bound_ms``) over the mean device time of its
launches in the profiled stretch, in percent.  Nothing to read where the
image tower launches no kernel 1 (the ResNet's attention pool takes the
plain formulation)."""

from portbench.counts.bounds import attention_bound_ms

KERNEL = "short_attn_tc_kernel"


def read(record):
    shape = record.notes.get("attention")
    prof = record.profile
    if not shape or prof is None:
        return None
    launches = prof.kernels(KERNEL)
    if not launches:
        return None
    itemsize = 2 if record.notes["dtype"] == "bfloat16" else 4
    bound_ms, _ = attention_bound_ms(shape["b"], shape["s"], shape["d"], shape["h"],
                                     shape["causal"], record.notes["dtype"], itemsize)
    mean_ms = sum(op.dur_ns for op in launches) / len(launches) / 1e6
    return 100.0 * bound_ms / mean_ms

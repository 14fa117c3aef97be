from debiasing_multi_modal_tpu_torch.ops.attention import (  # noqa: F401
    dot_product_attention,
    multi_head_attention,
)


def kernel_wrappers():
    """Each kernel wrapper by name; a wrapper's ``launches`` adds one where
    it launches its kernel, nowhere else."""
    from debiasing_multi_modal_tpu_torch.ops import conv_gemm, flash_attention, fused_bottleneck
    from debiasing_multi_modal_tpu_torch.ops import layer_norm, quant_gemm, short_attention

    wrappers = (short_attention.short_attention, short_attention.short_attention_qtiled,
                short_attention.short_attention_packed, quant_gemm.int8_matmul,
                flash_attention.flash_attention, flash_attention.flash_attention_dq,
                flash_attention.flash_attention_dkv, conv_gemm.fused_bottleneck_gemm,
                fused_bottleneck.fused_bottleneck, layer_norm.layer_norm)
    return {fn.__name__: fn for fn in wrappers}


def launch_counts():
    """Each kernel wrapper's launch count in this process, by name, and
    ``short_attention.long_row_launches``: the kernel-1 and kernel-3 calls
    that took the long-row route."""
    from debiasing_multi_modal_tpu_torch.ops import short_attention

    counts = {name: fn.launches for name, fn in kernel_wrappers().items()}
    counts["short_attention.long_row_launches"] = (
        short_attention.short_attention.long_row_launches)
    return counts

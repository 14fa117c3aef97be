from debiasing_multi_modal_tpu_torch.ops.attention import (  # noqa: F401
    dot_product_attention,
    multi_head_attention,
)

from debiasing_multi_modal_tpu_torch.extract.runner import (  # noqa: F401
    ExtractionRunner,
    encode_text_prompts,
)

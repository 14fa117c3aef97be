from debiasing_multi_modal_tpu_torch.tokenizer.bpe import (  # noqa: F401
    CONTEXT_LENGTH,
    ClipTokenizer,
    default_tokenizer,
    tokenize,
)

from debiasing_multi_modal_tpu_torch.data.groups import GroupTable  # noqa: F401
from debiasing_multi_modal_tpu_torch.data.embeddings_store import (  # noqa: F401
    EmbeddingTable,
    load_embeddings,
    save_embeddings,
)

from debiasing_multi_modal_tpu_torch.models.clip import (  # noqa: F401
    CLIP,
    create_clip,
    init_weights,
    l2_normalize,
    reference_scratch_init,
)
from debiasing_multi_modal_tpu_torch.models.config import (  # noqa: F401
    CONFIGS,
    CLIPConfig,
    get_config,
)
from debiasing_multi_modal_tpu_torch.models.resnet import ModifiedResNet  # noqa: F401
from debiasing_multi_modal_tpu_torch.models.text import TextTransformer  # noqa: F401
from debiasing_multi_modal_tpu_torch.models.vit import VisionTransformer  # noqa: F401

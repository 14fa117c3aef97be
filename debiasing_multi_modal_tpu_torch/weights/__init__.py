from debiasing_multi_modal_tpu_torch.weights.convert import (  # noqa: F401
    clip_from_state_dict,
    config_from_state_dict,
    load_openai_checkpoint,
    state_dict_from_jax_variables,
)

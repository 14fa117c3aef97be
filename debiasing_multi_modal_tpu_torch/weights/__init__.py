from debiasing_multi_modal_tpu_torch.weights.convert import (  # noqa: F401
    classifier_state_dict_from_jax_variables,
    clip_from_state_dict,
    config_from_state_dict,
    jax_variables_from_classifier_state_dict,
    load_openai_checkpoint,
    state_dict_from_jax_variables,
)

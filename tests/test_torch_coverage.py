"""With this slice the port does everything the JAX package does: every
module of the JAX package, by file name, has its counterpart at the same
path in the port, or is on the named list of modules that need none, and
``__graft_entry__.py::entry`` has ``debiasing_multi_modal_tpu_torch/entry.py``.
The list cannot go stale: a listed module that gains a counterpart fails
the test too."""

import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# JAX modules with no counterpart, and why (ROADMAP.md, item 7)
NO_COUNTERPART = {
    # XLA's persistent compilation cache; the port's kernels are built once
    # into ops/cuda_build.py's hashed build directory, and eager PyTorch
    # compiles nothing else
    "utils/compilation_cache.py",
}


def _modules(package):
    root = os.path.join(REPO, package)
    return {os.path.relpath(os.path.join(d, f), root)
            for d, _, files in os.walk(root) for f in files if f.endswith(".py")}


def test_every_jax_module_has_a_counterpart_or_is_named():
    jax_modules = _modules("debiasing_multi_modal_tpu")
    port = _modules("debiasing_multi_modal_tpu_torch")
    missing = sorted(m for m in jax_modules - port if m not in NO_COUNTERPART)
    assert missing == []
    assert sorted(NO_COUNTERPART & port) == []
    assert NO_COUNTERPART <= jax_modules
    assert os.path.isfile(os.path.join(REPO, "debiasing_multi_modal_tpu_torch", "entry.py"))


def test_named_public_functions_have_counterparts():
    """The functions of modules the port shares only in part."""
    import importlib

    for module, names in {
        "weights.convert": ("save_jit_state_dict_archive", "load_openai_checkpoint",
                            "config_from_state_dict"),
        "parallel.pp": ("stack_block_params", "validate_pp", "pipeline_transformer",
                        "pipelined_vit_encode", "pipelined_text_encode"),
        "ops.augment": ("random_resized_crop", "random_horizontal_flip", "train_augment",
                        "two_crop"),
        "train.linear_eval": ("linear_probe", "evaluate_linear"),
        "weights.zoo": ("available_models", "expected_sha256", "verify", "download", "load"),
        "utils.timing": ("chain_time", "measure_upload_ms", "measure_download_ms"),
        "viz.analysis": ("adapted_embeddings", "group_stats", "project", "project_2d",
                         "joint_projection"),
        "viz.plots": ("plot_splits", "plot_splits_joint", "split_stats_table"),
    }.items():
        port = importlib.import_module(f"debiasing_multi_modal_tpu_torch.{module}")
        for name in names:
            assert callable(getattr(port, name, None)), f"{module}.{name}"

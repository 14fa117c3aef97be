"""The pipeline schedule (``parallel/pp.py``) on gloo ranks, held against the
JAX package's ``pipeline_transformer`` on its 8-device CPU mesh and against
the port's sequential ``Transformer``, the weights carried across by
``weights/convert.py::transformer_state_dict_from_jax``.

One 4-rank launch (stage 4 at 1/2/4/8 microbatches and causal; dp 2 x pp 2;
pp 2 x tp 2; pp 2 x sp 2, ring and Ulysses; a single stage; each rank's own
layers; every ``ValueError``) and one 8-rank launch (pp 2 x tp 2 x sp 2
forward, gradients and ``remat``; dp 2 x pp 2 x tp 2 gradients; the tower
encodes in f32 and under the bf16 policy).  Limits: outputs within 2e-5,
gradients within 2e-4, ``remat`` within 1e-6 of the gradients without it;
the bf16 encodes within the JAX suite's limits (5e-2 absolute, cosine
0.9999).  The launches run in a thread while the JAX side compiles."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from debiasing_multi_modal_tpu.models import create_clip as jax_create_clip
from debiasing_multi_modal_tpu.models import init_clip
from debiasing_multi_modal_tpu.models.config import CLIPConfig as JaxConfig
from debiasing_multi_modal_tpu.models.layers import Transformer as JaxTransformer
from debiasing_multi_modal_tpu.parallel import pp as jpp
from debiasing_multi_modal_tpu.parallel.mesh import make_mesh as jax_mesh
from debiasing_multi_modal_tpu_torch.models.layers import Transformer
from debiasing_multi_modal_tpu_torch.parallel import multihost
from debiasing_multi_modal_tpu_torch.parallel import pp
from debiasing_multi_modal_tpu_torch.weights.convert import (
    state_dict_from_jax_variables,
    transformer_state_dict_from_jax,
)

import torch_parallel_worker as worker

L, D, H, S, B = 4, 64, 2, 10, 8
OUT_TOL, GRAD_TOL, REMAT_TOL = 2e-5, 2e-4, 1e-6

# label -> (mesh shape, axis names, kwargs, mode); num_heads=H everywhere
CASES4 = {
    **{f"stage4_m{m}": ((4,), ("stage",), dict(microbatches=m), "fwd") for m in (1, 2, 4, 8)},
    "stage4_causal": ((4,), ("stage",), dict(microbatches=4, causal=True), "fwd"),
    "stage4_grad": ((4,), ("stage",), dict(microbatches=2), "grad"),
    "dp2_pp2": ((2, 2), ("data", "stage"), dict(microbatches=2, batch_axis="data"), "grad"),
    "pp2_tp2": ((2, 2), ("stage", "model"), dict(microbatches=2, model_axis="model"), "fwd"),
    "pp2_tp2_causal": ((2, 2), ("stage", "model"),
                       dict(microbatches=2, model_axis="model", causal=True), "grad"),
    "pp2_sp2_ring": ((2, 2), ("stage", "seq"), dict(microbatches=2, seq_axis="seq"), "fwd"),
    "pp2_sp2_ring_causal": ((2, 2), ("stage", "seq"),
                            dict(microbatches=2, seq_axis="seq", causal=True), "grad"),
    "pp2_sp2_ulysses": ((2, 2), ("stage", "seq"),
                        dict(microbatches=2, seq_axis="seq", seq_impl="ulysses"), "grad"),
    "pp2_sp2_ulysses_causal": ((2, 2), ("stage", "seq"),
                               dict(microbatches=2, seq_axis="seq", seq_impl="ulysses",
                                    causal=True), "fwd"),
    "single_stage_dp4": ((4, 1), ("data", "stage"), dict(microbatches=2, batch_axis="data"),
                         "grad"),
    "stage4_own_layers": ((4,), ("stage",), dict(microbatches=2), "shard"),
}
FOUR_D = dict(microbatches=2, model_axis="model", seq_axis="seq")
CASES8 = {
    "pp2_tp2_sp2": ((2, 2, 2), ("stage", "model", "seq"), FOUR_D, "fwd"),
    "pp2_tp2_sp2_causal": ((2, 2, 2), ("stage", "model", "seq"), dict(FOUR_D, causal=True),
                           "grad"),
    "pp2_tp2_sp2_causal_remat": ((2, 2, 2), ("stage", "model", "seq"),
                                 dict(FOUR_D, causal=True), "remat"),
    "dp2_pp2_tp2": ((2, 2, 2), ("data", "stage", "model"),
                    dict(microbatches=2, batch_axis="data", model_axis="model"), "grad"),
}
# the JAX pipelines each case is also held against (one per mesh kind), and
# those whose gradients are (the rest are held to the sequential stack's)
JAX_HELD = ("stage4_causal", "stage4_grad", "dp2_pp2", "pp2_tp2_causal",
            "pp2_sp2_ring_causal", "pp2_sp2_ulysses", "pp2_tp2_sp2_causal", "dp2_pp2_tp2")
JAX_GRADS = ("stage4_grad", "pp2_tp2_sp2_causal")
# (mesh shape, axis names, kwargs) -> the JAX package's message
ERRORS = [
    ((4,), ("stage",), dict(microbatches=2, layers=3)),
    ((4,), ("stage",), dict(microbatches=3)),
    ((2, 2), ("data", "stage"), dict(microbatches=8, batch_axis="data")),
    ((1, 4), ("stage", "model"), dict(microbatches=2, model_axis="model")),
    ((2, 2), ("stage", "seq"), dict(microbatches=2, seq_axis="seq", seq_len=9)),
    ((2, 2), ("stage", "seq"), dict(microbatches=2, seq_axis="seq", seq_impl="striped")),
    ((1, 2, 2), ("stage", "model", "seq"),
     dict(microbatches=2, model_axis="model", seq_axis="seq", seq_impl="ulysses")),
]
TOWER_CFG = dict(name="tiny-pp-towers", embed_dim=32, image_resolution=32, vision_layers=4,
                 vision_width=128, vision_patch_size=16, transformer_width=D,
                 transformer_heads=H, transformer_layers=L, vocab_size=128)
TOWER_MESH = ((2, 2, 2), ("data", "stage", "model"))
TOWER_KW = dict(microbatches=2, batch_axis="data", model_axis="model")


def _inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    tgt = rng.standard_normal((B, S, D)).astype(np.float32)
    rng = np.random.default_rng(7)
    imgs = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    ids = np.zeros((8, 77), np.int32)
    for i in range(8):
        n = int(rng.integers(3, 10))
        ids[i, :n] = rng.integers(1, 126, n)
        ids[i, n] = 127  # EOT = the highest id
    return x, tgt, imgs, ids


@pytest.fixture(scope="module")
def setup():
    x, tgt, imgs, ids = _inputs()
    tr = JaxTransformer(width=D, layers=L, heads=H)
    variables = tr.init(jax.random.PRNGKey(0), jnp.asarray(x))
    sd = transformer_state_dict_from_jax(variables["params"])
    model = jax_create_clip(JaxConfig(**TOWER_CFG))
    tower_vars = init_clip(model, jax.random.PRNGKey(0), batch=1)
    tower_sd = state_dict_from_jax_variables(tower_vars)

    def run():  # both launches, one after the other, in a thread
        def cases(table):
            return [(k, *v[:2], dict(v[2], num_heads=H), v[3]) for k, v in table.items()]

        errors = [(shape, names, dict(kw, num_heads=H)) for shape, names, kw in ERRORS]
        enc = [("f32", *TOWER_MESH, "float32", TOWER_KW),
               ("bf16", *TOWER_MESH, "bfloat16", TOWER_KW)]
        four = multihost.launch(worker.pipeline_suite, 4,
                                args=(sd, x, tgt, cases(CASES4), errors), timeout_s=240)
        eight = multihost.launch(worker.pipeline_suite, 8,
                                 args=(sd, x, tgt, cases(CASES8), (),
                                       (TOWER_CFG, tower_sd, imgs, ids, enc)), timeout_s=240)
        return four, eight

    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(run)
    try:
        jax_refs = _jax_refs(tr, variables, x, tgt, model, tower_vars, imgs, ids)
        four, eight = future.result()
    finally:
        pool.shutdown(wait=True)
    return dict(sd=sd, x=x, tgt=tgt, four=[r["cases"] for r in four],
                errors=[r["errors"] for r in four], eight=[r["cases"] for r in eight],
                towers=[r["towers"] for r in eight], jax=jax_refs)


def _jax_grads_to_port(g):
    """A JAX stacked gradient tree -> the port's stacked names."""
    layers = {f"resblocks_{i}": jax.tree.map(lambda a: a[i], g) for i in range(L)}
    stacked, _ = pp.stack_block_params(
        {k: torch.from_numpy(v) for k, v in transformer_state_dict_from_jax(layers).items()})
    return {k: v.numpy() for k, v in stacked.items()}


def _jax_refs(tr, variables, x, tgt, model, tower_vars, imgs, ids):
    stacked, _ = jpp.stack_block_params(variables["params"])
    xj, tj = jnp.asarray(x), jnp.asarray(tgt)
    refs = {}
    for label in JAX_HELD:
        shape, names, kw, mode = {**CASES4, **CASES8}[label]
        mesh = jax_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])

        def loss(p, xx):
            y = jpp.pipeline_transformer(p, xx, mesh=mesh, num_heads=H, **kw)
            return jnp.mean((y - tj) ** 2), y

        if label not in JAX_GRADS:
            refs[label] = {"out": np.asarray(loss(stacked, xj)[1])}
        else:
            (_, y), (g, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
                stacked, xj)
            refs[label] = {"out": np.asarray(y), "grads": _jax_grads_to_port(g),
                           "x_grad": np.asarray(gx)}
    mesh = jax_mesh(*TOWER_MESH)
    refs["vit"] = np.asarray(jpp.pipelined_vit_encode(model, tower_vars, jnp.asarray(imgs),
                                                      mesh=mesh, **TOWER_KW))
    refs["text"] = np.asarray(jpp.pipelined_text_encode(model, tower_vars, jnp.asarray(ids),
                                                        mesh=mesh, **TOWER_KW))
    errors = []
    for shape, names, kw in ERRORS:
        kw = dict(kw)
        layers = kw.pop("layers", None)
        st = stacked if layers is None else jax.tree.map(lambda a: a[:layers], stacked)
        xs = xj[:, :kw.pop("seq_len")] if "seq_len" in kw else xj
        mesh = jax_mesh(shape, names, devices=jax.devices()[:int(np.prod(shape))])
        with pytest.raises(ValueError) as err:
            jpp.pipeline_transformer(st, xs, mesh=mesh, num_heads=H, **kw)
        errors.append(str(err.value))
    refs["errors"] = errors
    return refs


def _sequential(sd, x, tgt, causal):
    """The port's sequential stack: output, stacked parameter gradients and
    the input gradient of mean((out - tgt)**2)."""
    tr = Transformer(D, L, H, causal=causal)
    tr.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    xt = torch.from_numpy(x).requires_grad_()
    y = tr(xt)
    params = dict(tr.named_parameters())
    got = torch.autograd.grad(((y - torch.from_numpy(tgt)) ** 2).mean(),
                              list(params.values()) + [xt])
    grads, _ = pp.stack_block_params(dict(zip(params, got[:-1])))
    return y.detach().numpy(), {k: v.numpy() for k, v in grads.items()}, got[-1].numpy()


def _rank_slice(full, name, coords, shape, names):
    """The part of a stacked ``[L, ...]`` tensor that a rank at ``coords``
    holds: its stage's layers and its model rank's tensor-parallel slice."""
    n_stages = shape[names.index("stage")]
    per, stage = L // n_stages, coords["stage"]
    part = torch.from_numpy(full[name][stage * per:(stage + 1) * per])
    tp = shape[names.index("model")] if "model" in names else 1
    return pp._tp_slice(name, part, tp, coords.get("model", 0)).numpy()


def _check_case(setup, ranks, label, spec):
    shape, names, kw, mode = spec
    y_ref, g_ref, gx_ref = _sequential(setup["sd"], setup["x"], setup["tgt"],
                                       kw.get("causal", False))
    jax_ref = setup["jax"].get(label)
    for rank in ranks:
        got = rank[label]
        np.testing.assert_allclose(got["out"], y_ref, rtol=OUT_TOL, atol=OUT_TOL)
        if jax_ref is not None:
            np.testing.assert_allclose(got["out"], jax_ref["out"], rtol=OUT_TOL, atol=OUT_TOL)
        if "grads" not in got:
            continue
        np.testing.assert_allclose(got["x_grad"], gx_ref, rtol=GRAD_TOL, atol=GRAD_TOL)
        assert set(got["grads"]) == set(g_ref)
        for name, g in got["grads"].items():
            want = _rank_slice(g_ref, name, got["coords"], shape, names)
            assert g.shape == want.shape, name
            np.testing.assert_allclose(g, want, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)
            if jax_ref is not None and "grads" in jax_ref:
                np.testing.assert_allclose(
                    g, _rank_slice(jax_ref["grads"], name, got["coords"], shape, names),
                    rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=name)
        if jax_ref is not None and "x_grad" in jax_ref:
            np.testing.assert_allclose(got["x_grad"], jax_ref["x_grad"], rtol=GRAD_TOL,
                                       atol=GRAD_TOL)


@pytest.mark.parametrize("label", list(CASES4))
def test_four_ranks_match_sequential_and_jax(setup, label):
    _check_case(setup, setup["four"], label, CASES4[label])


@pytest.mark.parametrize("label", list(CASES8))
def test_eight_ranks_match_sequential_and_jax(setup, label):
    _check_case(setup, setup["eight"], label, CASES8[label])


def test_remat_gradients_equal_plain(setup):
    for rank in setup["eight"]:
        plain, remat = rank["pp2_tp2_sp2_causal"], rank["pp2_tp2_sp2_causal_remat"]
        for name, g in plain["grads"].items():
            np.testing.assert_allclose(remat["grads"][name], g, rtol=0, atol=REMAT_TOL)
        np.testing.assert_allclose(remat["x_grad"], plain["x_grad"], rtol=0, atol=REMAT_TOL)


def test_each_rank_holds_its_own_layers_and_gathers_none(setup):
    """``shard_stage_params`` leaves a rank its L/4 layers (equal to its part
    of the stack); the run on them moves activations by point-to-point sends
    (one per tick, M + 3 ticks) and gathers nothing."""
    for rank in setup["four"]:
        got = rank["stage4_own_layers"]
        assert set(got["local_layers"].values()) == {L // 4}
        assert got["local_equal"]
        assert got["calls"] == ["batch_isend_irecv"]
        assert got["n_sends"] == 2 + 4 - 1


def test_value_errors_match_jax(setup):
    for rank in setup["errors"]:
        assert rank == setup["jax"]["errors"]


def test_validate_and_stack_errors_match_jax():
    for args in ((4, 3, 8, 2), (4, 2, 8, 3)):
        with pytest.raises(ValueError) as want:
            jpp.validate_pp(*args)
        with pytest.raises(ValueError) as got:
            pp.validate_pp(*args)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match=r"no 'resblocks\.\*' blocks"):
        pp.stack_block_params({"ln.weight": torch.zeros(1)})
    with pytest.raises(ValueError, match="non-contiguous"):
        pp.stack_block_params({"resblocks.0.a": torch.zeros(1), "resblocks.2.a": torch.zeros(1)})


def test_stack_block_params_matches_the_jax_stack(setup):
    """The port's stack of the carried-over weights equals the JAX stack
    carried over, and a module's stack keeps its parameters' history."""
    tr = Transformer(D, L, H)
    tr.load_state_dict({k: torch.from_numpy(v) for k, v in setup["sd"].items()})
    stacked, n = pp.stack_block_params(tr)
    assert n == L
    jax_tr = JaxTransformer(width=D, layers=L, heads=H)
    variables = jax_tr.init(jax.random.PRNGKey(0), jnp.asarray(setup["x"]))
    jax_stacked, _ = jpp.stack_block_params(variables["params"])
    want = _jax_grads_to_port(jax_stacked)
    for name, t in stacked.items():
        np.testing.assert_array_equal(t.detach().numpy(), want[name])
    stacked["ln_1.weight"].sum().backward()
    assert torch.equal(tr.resblocks[2].ln_1.weight.grad, torch.ones(D))


@pytest.mark.parametrize("tower", ["vit", "text"])
def test_tower_encodes_f32_match_modules_and_jax(setup, tower):
    for rank in setup["towers"]:
        got = rank["f32"]
        assert got["dtype"] == "torch.float32"
        np.testing.assert_allclose(got[tower], got[f"ref_{tower}"], rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_allclose(got[tower], setup["jax"][tower], rtol=OUT_TOL, atol=OUT_TOL)
        np.testing.assert_array_equal(got["vit_pre"], got["vit"])


def test_tower_encode_bf16_policy(setup):
    """The JAX suite's bf16 limits: a few bf16 ulps of the unit-scale
    outputs, cosine 0.9999."""
    for rank in setup["towers"]:
        got = rank["bf16"]
        assert got["dtype"] == "torch.bfloat16"
        a, b = got["vit"], got["ref_vit"]
        np.testing.assert_allclose(a, b, atol=5e-2, rtol=0)
        cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos > 0.9999, cos


def test_tower_encodes_refuse_quant_fuse_qkv_and_clashing_kwargs():
    """quant and fuse_qkv towers hold the same parameters, so the guard
    raises before anything runs (no mesh is touched); fixed kwargs clash."""
    from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip

    cfg = CLIPConfig(**TOWER_CFG)
    imgs = torch.zeros(4, 32, 32, 3)
    with pytest.raises(ValueError, match="fuse_qkv"):
        pp.pipelined_vit_encode(create_clip(cfg, device="cpu", fuse_qkv=True), None, imgs,
                                mesh=None)
    with pytest.raises(ValueError, match="quant"):
        pp.pipelined_vit_encode(create_clip(cfg, device="cpu", quant="int8"), None, imgs,
                                mesh=None)
    with pytest.raises(TypeError, match="fixed by the tower encode"):
        pp.pipelined_text_encode(create_clip(cfg, device="cpu"), None,
                                 torch.zeros(4, 77, dtype=torch.long), mesh=None, causal=True)

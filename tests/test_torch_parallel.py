"""Data and tensor parallelism of the port (``parallel/{mesh,multihost,
packing,tp}.py``, ``extract/runner.py`` with a mesh, ``cli/extract_main.py
--tensor_parallel``) held against the JAX package on the CPU.

The port's ranks are gloo CPU processes started by
``parallel/multihost.launch`` (one launch of 4 ranks runs every tensor- and
data-parallel case); the JAX side runs here on the suite's 8-device CPU
mesh.  Tolerances: the towers and the runners within 2e-5 (the JAX suite's
``tests/test_tp.py:148``), predictions equal.  Under ``quant="int8"`` the
port's tensor-parallel towers hold the unsharded port towers to 2e-5 (their
integer products are the unsharded ones), and the JAX tensor-parallel
towers to the JAX suite's own int8 bound (0.02 absolute, cosine 0.999):
XLA's sharded sums flip a few roundings at quantization boundaries.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from debiasing_multi_modal_tpu.extract import runner as jrunner
from debiasing_multi_modal_tpu.models import create_clip as jax_create_clip
from debiasing_multi_modal_tpu.models import init_clip
from debiasing_multi_modal_tpu.models.config import CLIPConfig as JaxConfig
from debiasing_multi_modal_tpu.parallel import packing as jpacking
from debiasing_multi_modal_tpu.parallel import tp as jtp
from debiasing_multi_modal_tpu.parallel.mesh import batch_sharding, make_mesh as jax_mesh
from debiasing_multi_modal_tpu_torch.models import CLIPConfig, create_clip
from debiasing_multi_modal_tpu_torch.parallel import multihost, packing, tp
from debiasing_multi_modal_tpu_torch.weights.convert import state_dict_from_jax_variables

import torch_parallel_worker as worker
from test_torch_extract import synthetic_bpe  # noqa: F401  (a fixture)

VIT = dict(name="tiny-vit", embed_dim=32, image_resolution=32, vision_layers=2,
           vision_width=128, vision_patch_size=16, transformer_width=64, transformer_heads=4,
           transformer_layers=2, vocab_size=128)
RN = dict(name="tiny-rn", embed_dim=32, image_resolution=64, vision_layers=(1, 1, 1, 1),
          vision_width=8, vision_patch_size=None, transformer_width=64, transformer_heads=4,
          transformer_layers=2, vocab_size=128)
CASES = {"vit": (VIT, "none"), "rn": (RN, "none"), "vit_int8": (VIT, "int8")}
TOL = 2e-5


def _tokens(n, vocab=128):
    rng = np.random.default_rng(0)
    toks = np.zeros((n, 77), np.int64)
    for i in range(n):
        length = int(rng.integers(3, 10))
        toks[i, 0] = vocab - 2
        toks[i, 1:length - 1] = rng.integers(1, vocab - 2, length - 2)
        toks[i, length - 1] = vocab - 1
    return toks


def _close(ours, ref, tol=TOL):
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def world():
    """The JAX side of every case, and the port's ranks (one launch of 4)."""
    rng = np.random.default_rng(1)
    zs = rng.standard_normal((2, 32)).astype(np.float32)
    tokens = _tokens(8)
    jax_side, configs = {}, []
    for label, (kw, quant) in CASES.items():
        jm = jax_create_clip(JaxConfig(**kw), quant=quant)
        variables = jax.device_get(init_clip(jm, jax.random.PRNGKey(0), batch=1))
        res = kw["image_resolution"]
        pixels = np.random.default_rng(2).standard_normal((8, res, res, 3)).astype(np.float32)
        images = (np.random.default_rng(3).random((8, res, res, 3)) * 255).astype(np.uint8)
        mesh = jax_mesh((4, 2), ("data", "model"))
        var_sh = jtp.tp_shardings(variables, mesh)
        data_sh = batch_sharding(mesh)
        sv = jtp.shard_variables(variables, mesh)
        f_img = jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode_image),
                        in_shardings=(var_sh, data_sh))
        f_txt = jax.jit(lambda v, x: jm.apply(v, x, method=jm.encode_text),
                        in_shardings=(var_sh, data_sh))
        jax_side[label] = {
            "image": np.asarray(f_img(sv, jax.device_put(jnp.asarray(pixels), data_sh))),
            "text": np.asarray(f_txt(sv, jax.device_put(jnp.asarray(tokens, jnp.int32),
                                                        data_sh))),
            "dp": jrunner.ExtractionRunner(jm, variables, zs, mesh=jax_mesh()).encode_batch(images),
            "tp": jrunner.ExtractionRunner(jm, variables, zs, mesh=mesh,
                                           tensor_parallel=True).encode_batch(images),
        }
        sd = state_dict_from_jax_variables(variables)
        model = create_clip(CLIPConfig(**kw), device="cpu", quant=quant)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
        with torch.no_grad():
            jax_side[label]["port_image"] = model.encode_image(torch.from_numpy(pixels)).numpy()
            jax_side[label]["port_text"] = model.encode_text(torch.from_numpy(tokens)).numpy()
        configs.append((label, kw, sd, quant, pixels, images))
    ranks = multihost.launch(worker.tp_and_extraction, 4, args=(configs, zs, tokens),
                             timeout_s=240)
    return jax_side, ranks


@pytest.mark.parametrize("label", sorted(CASES))
def test_tp_towers_match_replicated_and_jax(world, label):
    jax_side, ranks = world
    ref = jax_side[label]
    for rank in ranks:  # every rank of a data slice holds the same rows
        got = rank[label]
        for tower in ("image", "text"):
            _close(got[tower], ref[f"port_{tower}"])
            if CASES[label][1] == "none":
                _close(got[tower], ref[tower])
            else:
                a, b = got[tower].astype(np.float64), ref[tower].astype(np.float64)
                np.testing.assert_allclose(a, b, atol=0.02, rtol=0)
                cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))
                assert cos.min() > 0.999


@pytest.mark.parametrize("label", ["vit", "rn"])
@pytest.mark.parametrize("path", ["dp", "tp"])
def test_extraction_matches_the_jax_runner(world, label, path):
    """dp: the batch over 4 ranks (JAX: 8 devices); tp: a 2 x 2 mesh (JAX:
    4 x 2).  Every rank returns the whole batch, pad rows dropped."""
    jax_side, ranks = world
    emb_ref, preds_ref = jax_side[label][path]
    for rank in ranks:
        emb, preds = rank[label][path]
        assert emb.shape == emb_ref.shape
        _close(emb, emb_ref)
        np.testing.assert_array_equal(preds, preds_ref)


def test_tp_specs_cover_the_jax_sharded_leaves():
    """Per transformer block the JAX package shards 10 leaves (q/k/v kernel
    and bias, c_fc kernel and bias, out_proj and c_proj kernels); the port's
    blocks hold q, k and v stacked in ``in_proj_weight``/``in_proj_bias``,
    so the same features are split in 6 tensors.  The ResNet pool shards 7
    in both (q/k/v weight and bias, c_proj weight); everything else,
    convolutions and the ViT's bare ``proj`` included, is replicated."""
    vit = create_clip(CLIPConfig(**VIT), device="cpu")
    specs = tp.tp_specs(vit)
    blocks = VIT["vision_layers"] + VIT["transformer_layers"]
    assert tp.sharded_param_count(vit) == 6 * blocks
    jvars = init_clip(jax_create_clip(JaxConfig(**VIT)), jax.random.PRNGKey(0), batch=1)
    assert jtp.sharded_param_count(jvars) == 10 * blocks
    blk = "visual.transformer.resblocks.0."
    assert specs[blk + "attn.in_proj_weight"] == specs[blk + "attn.in_proj_bias"] == 0
    assert specs[blk + "mlp.c_fc.weight"] == specs[blk + "mlp.c_fc.bias"] == 0
    assert specs[blk + "attn.out_proj.weight"] == specs[blk + "mlp.c_proj.weight"] == 1
    assert specs[blk + "attn.out_proj.bias"] is None and specs[blk + "mlp.c_proj.bias"] is None
    for name in ("visual.proj", "visual.conv1.weight", "token_embedding.weight",
                 "text_projection", blk + "ln_1.weight"):
        assert specs[name] is None
    jspecs = jtp.tp_specs(jvars)["params"]["visual"]["transformer"]["resblocks_0"]
    assert jspecs["attn"]["q_proj"]["kernel"] == P(None, "model")  # output features
    assert jspecs["attn"]["out_proj"]["kernel"] == P("model", None)  # input features
    rn = create_clip(CLIPConfig(**RN), device="cpu")
    rspecs = tp.tp_specs(rn)
    pool = {k: v for k, v in rspecs.items() if k.startswith("visual.attnpool.")}
    assert sum(v is not None for v in pool.values()) == 7
    assert pool["visual.attnpool.c_proj.weight"] == 1 and pool["visual.attnpool.c_proj.bias"] is None
    assert all(v is None for k, v in rspecs.items() if k.startswith("visual.layer"))
    jrn = jtp.tp_specs(init_clip(jax_create_clip(JaxConfig(**RN)), jax.random.PRNGKey(0),
                                 batch=1))["params"]["visual"]["attnpool"]
    assert sum(any(ax is not None for ax in spec)
               for spec in jax.tree.leaves(jrn, is_leaf=lambda x: isinstance(x, P))) == 7


def test_validate_tp_messages_match_jax():
    for tp_degree in (1, 2, 3, 8):
        cfg, jcfg = CLIPConfig(**VIT), JaxConfig(**VIT)
        try:
            jtp.validate_tp(jcfg, tp_degree)
            jax_msg = None
        except ValueError as e:
            jax_msg = str(e)
        if jax_msg is None:
            tp.validate_tp(cfg, tp_degree)
        else:
            with pytest.raises(ValueError) as err:
                tp.validate_tp(cfg, tp_degree)
            assert str(err.value) == jax_msg
    with pytest.raises(ValueError, match="'model' axis"):
        from debiasing_multi_modal_tpu_torch.extract.runner import ExtractionRunner

        ExtractionRunner(create_clip(CLIPConfig(**VIT), device="cpu"),
                         np.ones((2, 32), np.float32), tensor_parallel=True)


def test_int8_pallas_pads_n_for_tp_shards():
    """Kernel 7 takes N in multiples of 128; a tp = 4 shard of ViT-B/32's
    q/k/v has N = 192.  ``int8_dense`` (the caller) pads it: the result is
    the plain integer product's at every N."""
    from debiasing_multi_modal_tpu_torch.ops.quant import int8_dense

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 50, 768)).astype(np.float32))
    for n in (192, 384, 768):
        w = torch.from_numpy(rng.standard_normal((768, n)).astype(np.float32))
        b = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        got = int8_dense(x, w, b, impl="pallas")
        assert got.shape == (6, 50, n)
        ref = int8_dense(x, torch.nn.functional.pad(w, (0, -n % 128)),
                         torch.nn.functional.pad(b, (0, -n % 128)), impl="pallas")[..., :n]
        assert torch.equal(got, ref)
        _close(got.numpy(), int8_dense(x, w, b, impl="xla").numpy(), 1e-5)


def test_packing_round_trip_matches_jax():
    """The same leaves come back from both packages' packed buffers,
    bit-equal after bf16 rounding (exact: bit-equal).  The JAX package lays
    its leaves out in pytree (sorted-key) order, the port in the dict's
    order, so the buffers are compared leaf by leaf."""
    rng = np.random.default_rng(6)
    tree = {"b.weight": rng.standard_normal((3, 5)).astype(np.float32),
            "a.bias": rng.standard_normal(7).astype(np.float32),
            "c.half": rng.standard_normal((2, 2)).astype(np.float16)}
    for exact in (False, True):
        jbuf, jspec = jpacking.pack_tree(tree, exact=exact)
        jout = jax.device_get(jpacking.unpack_tree(jnp.asarray(jbuf), jspec))
        buf, spec = packing.pack_tree(tree, exact=exact)
        assert buf.dtype == (torch.float32 if exact else torch.bfloat16) and buf.numel() == 26
        out = packing.unpack_tree(buf, spec)
        assert [s[0] for s in spec] == list(tree) != sorted(tree)
        for name, leaf in tree.items():
            got = out[name].numpy()
            assert got.dtype == leaf.dtype and got.shape == leaf.shape
            np.testing.assert_array_equal(got, np.asarray(jout[name]))
            if exact:
                np.testing.assert_array_equal(got, leaf)
            else:
                rounded = leaf.astype(np.float32).astype(ml_dtypes.bfloat16).astype(leaf.dtype)
                np.testing.assert_array_equal(got, rounded)
    with pytest.raises(TypeError, match="float leaves only"):
        packing.pack_tree({"n": np.arange(3)})


def test_packed_host_init_is_the_seeded_model_in_bf16():
    sd = packing.packed_host_init(CLIPConfig(**RN), seed=3, device="cpu")
    ref = create_clip(CLIPConfig(**RN), device="cpu",
                      generator=torch.Generator().manual_seed(3)).state_dict()
    assert sd.keys() == ref.keys()
    for k, v in ref.items():
        want = v.to(torch.bfloat16).to(v.dtype) if v.is_floating_point() else v
        assert torch.equal(sd[k], want), k


def test_extract_cli_tensor_parallel_writes_the_single_process_cache(tmp_path, synthetic_bpe):
    """``extract_main --tensor_parallel 2 --device cpu`` on 2 launched ranks
    writes the caches one process writes (image and text embeddings within
    2e-5 of scale, predictions and every other column equal); one process
    refuses tp = 2 with the JAX CLI's message."""
    from debiasing_multi_modal_tpu_torch.cli import extract_main
    from debiasing_multi_modal_tpu_torch.data.embeddings_store import load_embeddings
    from test_torch_extract import _waterbirds_tree

    data = _waterbirds_tree(tmp_path)
    flags = ["--data_dir", str(data), "--dataset", "waterbirds", "--save", "--batch_size", "4",
             "--device", "cpu", "--num_workers", "0", "--backbone", "ViT-B/32",
             "--host_resolution", "64"]
    extract_main.main(extract_main.build_parser().parse_args(
        flags + ["--embedding_dir", "single"]))
    multihost.launch(worker.extract_cli, 2, args=(
        flags + ["--embedding_dir", "tp", "--tensor_parallel", "2"], synthetic_bpe),
        timeout_s=240)
    for fmt in ("npz", "json"):
        one = load_embeddings(str(data / "single" / "waterbirds" / "ViT-B-32" / f"clip.{fmt}"))
        two = load_embeddings(str(data / "tp" / "waterbirds" / "ViT-B-32" / f"clip.{fmt}"))
        for col in ("filenames", "y", "place", "group", "split", "y_pred"):
            np.testing.assert_array_equal(getattr(two, col), getattr(one, col))
        np.testing.assert_allclose(two.embeddings, one.embeddings, rtol=0,
                                   atol=TOL * np.abs(one.embeddings).max())
    from debiasing_multi_modal_tpu_torch.data.embeddings_store import load_text_embeddings

    for kind in ("class", "spurious", "group"):
        # the text towers are unsharded on every rank; the ranks run one
        # intra-op thread each, so the f32 sums differ from this process's
        # in order only
        name = f"clip_{kind}.json"
        one = load_text_embeddings(str(data / "single" / "waterbirds" / name))
        two = load_text_embeddings(str(data / "tp" / "waterbirds" / name))
        np.testing.assert_allclose(two, one, rtol=0, atol=TOL * np.abs(one).max())
    with pytest.raises(SystemExit, match="--tensor_parallel 2 does not divide 1 devices"):
        extract_main.main(extract_main.build_parser().parse_args(
            flags + ["--tensor_parallel", "2"]))
    import torch.distributed as dist

    assert not dist.is_initialized()  # the CLI destroyed the group it started

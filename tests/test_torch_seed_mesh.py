"""The seed-sharded sweep (``train_seeds_vmapped(mesh=...)``,
``run_sweep(mesh=...)``) on 2 and 4 gloo ranks held against the JAX
package's ``run_seeds(mesh=...)`` and ``run_sweep(mesh=...)`` on as many
devices of its CPU mesh: every row's dicts equal, the CSVs byte-identical
(the port's rows start from the JAX sweep's draws), and a row count that
does not divide the data axis raises the JAX error.  On one rank in this
process, a world-size-1 mesh gives the unsharded results."""

import jax
import pytest

from debiasing_multi_modal_tpu.parallel.mesh import make_mesh as jax_mesh
from debiasing_multi_modal_tpu.sweep import runner as jrunner
from debiasing_multi_modal_tpu.sweep import vmap_loop as jvm
from debiasing_multi_modal_tpu.train.config import TrainConfig as JaxConfig
from debiasing_multi_modal_tpu_torch.parallel import multihost

import torch_parallel_worker as worker
from test_torch_sweep import BASE, SPEC, bundles, jax_row_inits  # noqa: F401  (a fixture)

SEEDS = [42, 32, 22, 12]
FLAGS = dict(tl_method="adapter_reg_seq_alter", epochs=3, epochs_feature_learning=1,
             add_adapter=True, balance_val=True, **BASE)
GRID = dict(lr_list=[0.5, 2.0], lr_multiple=2.0, stack_lr_axis=True)


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request, bundles, tmp_path_factory):
    n = request.param
    jb, _ = bundles
    root = tmp_path_factory.mktemp(f"seed_mesh_{n}")
    jcfg = JaxConfig(**FLAGS)
    mesh = jax_mesh((n,), ("data",), devices=jax.devices()[:n])
    ref_rows = jrunner.run_seeds(jcfg, jb, SEEDS, use_vmap=True, mesh=mesh)
    jrunner.run_sweep(jcfg, jb, SEEDS, **GRID, mesh=mesh, result_root=str(root / "jax"))
    with pytest.raises(ValueError) as uneven:
        jvm.train_seeds_vmapped(jcfg, jb, SEEDS[:1] * (n + 1), mesh=mesh)
    inits = {"rows": jax_row_inits(jcfg, SEEDS),
             "grid": jax_row_inits(jcfg, SEEDS * len(GRID["lr_list"]))}
    ranks = multihost.launch(worker.seed_mesh_runs, n,
                             args=(SPEC, FLAGS, SEEDS, inits, GRID, str(root / "port")),
                             timeout_s=300)
    return root, ref_rows, str(uneven.value), ranks


def test_every_row_equals_jax(sharded):
    _, ref_rows, _, ranks = sharded
    for rank in ranks:  # every rank returns every row, in row order
        assert len(rank["rows"]) == len(SEEDS)
        assert rank["rows"] == ref_rows


def test_csvs_are_the_jax_bytes(sharded):
    root = sharded[0]
    names = sorted(p.name for p in (root / "jax").iterdir())
    assert len(names) == len(GRID["lr_list"])
    assert sorted(p.name for p in (root / "port").iterdir()) == names
    for name in names:
        assert (root / "port" / name).read_bytes() == (root / "jax" / name).read_bytes()


def test_uneven_split_raises_the_jax_error(sharded):
    _, _, jax_msg, ranks = sharded
    assert jax_msg.startswith("len(seeds)=")
    for rank in ranks:
        assert rank["uneven"] == jax_msg


def test_world_of_one_equals_unsharded(bundles):
    """A mesh of this one process (an in-memory gloo group, destroyed
    after) gives the unsharded stacked results."""
    import torch.distributed as dist

    from debiasing_multi_modal_tpu_torch.parallel.mesh import make_mesh
    from debiasing_multi_modal_tpu_torch.sweep.runner import run_seeds
    from debiasing_multi_modal_tpu_torch.train.config import TrainConfig

    _, tb = bundles
    cfg = TrainConfig(tl_method="adapter", epochs=1, **BASE)
    plain = run_seeds(cfg, tb, [42, 32], device="cpu")
    with multihost.process_group("cpu"):
        assert run_seeds(cfg, tb, [42, 32], mesh=make_mesh(device="cpu"), device="cpu") == plain
    assert not dist.is_initialized()

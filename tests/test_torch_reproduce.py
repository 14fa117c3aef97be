"""The reproduction chain through the port (``scripts/reproduce_all_torch.sh``
and the stage scripts it calls), on the CPU, against the JAX package's chain.

The fixture is ``scripts/make_synthetic_fixture.py --skip_checkpoint`` (images
and metadata; it imports neither package on that route) plus the narrow
``RN50.pt`` that ``scripts/make_synthetic_checkpoint_torch.py`` writes from a
seeded port CLIP, and a synthetic merges file at ``$CLIP_BPE_PATH``.

- (a) The port's mini chain: both Stage-A extractions, both headline sweeps,
  the tables and the structural check, with the JAX mini chain's settings
  (``tests/test_reproduce_all.py``: 48-pixel host resolution, batch 24, 3
  epochs, one seed, no ablations) except its grid collapse: the grids stay
  the real ones, so both headline cells come out under their real names.
  ``run_final_main_torch.sh`` then trains the best Waterbirds configuration
  on the chain's caches, with every flag of its JAX twin.
- (b) The JAX package's ``extract_main`` on the same fixture, checkpoint and
  merges (Waterbirds): its caches equal the port's, embeddings and text
  within 1e-4 of scale, predictions equal.
- (c) The Waterbirds headline cell on the chain's cache: the port's
  ``sweep_main`` writes the chain's CSV byte for byte, and, started from the
  JAX sweep's initial draws, the JAX package's ``sweep_main``'s CSV byte for
  byte (each package draws its own initial weights: the port from a
  ``torch.Generator``, JAX from ``jax.random``).
- (d) Opt-in (``RUN_REPRO_TEST=1``): the full rehearsal, the eight ablation
  cells included, as ``test_reproduce_all_chain_on_synthetic_fixture`` runs
  the JAX chain; every one of its ``REQUIRED_CELLS``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from debiasing_multi_modal_tpu_torch.tokenizer.bpe import write_synthetic_merges
from test_reproduce_all import REQUIRED_CELLS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MINI_SWEEP = "--epochs 3 --epochs_feature_learning 1 --num_iter 1 --random_seeds 42"
EXTRACT = "--host_resolution 48 --batch_size 24"


def _run(cmd, env=None, timeout=600):
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=timeout)
    tail = proc.stdout[-4000:] + "\n--- stderr ---\n" + proc.stderr[-3000:]
    assert proc.returncode == 0, tail
    return proc


def build_fixture(root, geometry="narrow"):
    """The chain's fixture under ``root``; returns the merges file's path."""
    _run([sys.executable, "scripts/make_synthetic_fixture.py", str(root), "--skip_checkpoint"])
    _run([sys.executable, "scripts/make_synthetic_checkpoint_torch.py", str(root),
          "--geometry", geometry])
    merges = os.path.join(str(root), "bpe_simple_vocab_16e6.txt.gz")
    write_synthetic_merges(merges)
    return merges


def _chain_env(root, results, merges, **knobs):
    env = dict(os.environ, PYTHONPATH=REPO, CLIP_BPE_PATH=merges,
               REPRO_DATA_ROOT=str(root), REPRO_RESULT_ROOT=str(results),
               REPRO_CKPT=str(root / "RN50.pt"), REPRO_DEVICE="cpu",
               REPRO_EXTRACT_ARGS=EXTRACT, REPRO_CHECK_ARGS="--structural")
    env.update(knobs)
    return env


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("assets")
    results = root.parent / "results"
    merges = build_fixture(root)
    env = _chain_env(root, results, merges, REPRO_SWEEP_ARGS=MINI_SWEEP, REPRO_ABLATIONS="0")
    proc = _run(["bash", "scripts/reproduce_all_torch.sh"], env=env, timeout=900)
    return root, results, merges, proc


def _assert_chain(root, results, proc, cells):
    tail = proc.stdout[-4000:]
    for cell in cells:
        path = results / cell
        assert path.is_file(), f"chain did not produce {cell}\n{tail}"
        text = path.read_text()
        assert "test_mean" in text and "worst_acc" in text, cell
    assert "structural check only" in proc.stdout, tail
    for ds in ("waterbirds", "celeba"):
        assert (root / "embeddings_unnormalized" / ds / "RN50" / "clip.npz").is_file()
        assert (root / "embeddings_unnormalized" / ds / "clip_group.json").is_file()


def test_port_mini_chain(chain, tmp_path):
    root, results, merges, proc = chain
    _assert_chain(root, results, proc, REQUIRED_CELLS[:2])
    # every stage ran through the port, on the CPU, and said how long it took
    stages = [line.split()[1] for line in proc.stdout.splitlines() if line.startswith("stage ")]
    assert stages == ["extract:", "sweep_wb:", "sweep_ca:", "report:", "chain:"]
    launches = [json.loads(line.split(":", 1)[1]) for line in proc.stdout.splitlines()
                if line.startswith("kernel launches:")]
    assert [n["text_encodes"] for n in launches] == [3, 3]
    assert all(set(n["launches"].values()) == {0} for n in launches)  # no kernel on the CPU
    # the best Waterbirds configuration, with every flag of its JAX twin
    env = dict(os.environ, PYTHONPATH=REPO, REPRO_DATA_ROOT=str(root), REPRO_DEVICE="cpu")
    final = _run(["bash", "scripts/run_final_main_torch.sh", "--epochs", "2",
                  "--epochs_feature_learning", "1", "--results_dir", str(tmp_path / "final")],
                 env=env)
    assert "best" in final.stdout.lower(), final.stdout[-2000:]
    assert os.listdir(tmp_path / "final")


@pytest.fixture
def jax_cpu(monkeypatch, chain):
    """The JAX CLIs in this process: the chain's merges file, no persistent
    compilation cache."""
    from debiasing_multi_modal_tpu.tokenizer import bpe as jbpe
    from debiasing_multi_modal_tpu.utils import compilation_cache

    monkeypatch.setenv("CLIP_BPE_PATH", chain[2])
    monkeypatch.setattr(compilation_cache, "enable_persistent_cache", lambda: None)
    jbpe.default_tokenizer.cache_clear()
    yield
    jbpe.default_tokenizer.cache_clear()


def _close(ours, ref, rel=1e-4):
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def test_jax_extract_matches_the_port_caches(chain, jax_cpu):
    from debiasing_multi_modal_tpu.cli import extract_main as jextract

    root = chain[0]
    jextract.main(jextract.build_parser().parse_args([
        "--data_dir", str(root), "--dataset", "waterbirds", "--embedding_dir", "emb_jax",
        "--save", "--split", "all", "--backbone", "RN50", "--checkpoint", str(root / "RN50.pt"),
        *EXTRACT.split()]))
    ours_dir = root / "embeddings_unnormalized" / "waterbirds"
    ref_dir = root / "emb_jax" / "waterbirds"
    ours, ref = np.load(ours_dir / "RN50" / "clip.npz"), np.load(ref_dir / "RN50" / "clip.npz")
    assert sorted(ours.files) == sorted(ref.files)
    for key in ref.files:
        assert ours[key].dtype == ref[key].dtype and ours[key].shape == ref[key].shape, key
        if key != "embeddings":
            np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    assert ref["embeddings"].shape == (72, 256)
    _close(ours["embeddings"], ref["embeddings"])
    for kind in ("class", "spurious", "group"):
        with open(ours_dir / f"clip_{kind}.json") as f:
            mine = json.load(f)
        with open(ref_dir / f"clip_{kind}.json") as f:
            theirs = json.load(f)
        assert list(mine) == list(theirs)
        _close(np.array(list(mine.values())), np.array(list(theirs.values())))


def test_jax_sweep_on_the_port_cache_writes_the_chain_csv(chain, jax_cpu, tmp_path,
                                                         monkeypatch):
    from debiasing_multi_modal_tpu.cli import sweep_main as jsweep
    from debiasing_multi_modal_tpu_torch.cli import sweep_main as tsweep
    from test_torch_sweep import _with_jax_inits

    root, results = chain[0], chain[1]
    emb = root / "embeddings_unnormalized" / "waterbirds"
    # run_sweep_wb.sh's flags, its grid collapsed to the headline cell
    flags = ["--epochs", "100", "--epochs_feature_learning", "40", "--dataset", "waterbirds",
             "--text_embedding_dir", str(emb / "clip_class.json"),
             "--text_spurious_embedding_dir", str(emb / "clip_spurious.json"),
             "--text_group_embedding_dir", str(emb / "clip_group.json"),
             "--image_embedding_dir", str(emb / "RN50" / "clip.npz"),
             "--data_dir", str(root / "waterbirds" / "waterbird_complete95_forest2water2"),
             "--tl_method", "adapter_reg_seq_alter", "--train_target", "class", "--warm_reg",
             "--lr_decay_rate", "0.1", "--lr_decay_epochs", "90,95", "--add_adapter",
             "--lr_list", "1", "--bs_list", "1024", "--bsr_list", "256",
             "--lr_multiple", "1.0", *MINI_SWEEP.split()]
    name = REQUIRED_CELLS[0]

    def port(out):
        parse = tsweep.extend_parser(tsweep.build_parser()).parse_args
        assert tsweep.main(parse(flags + ["--result_root", str(out), "--device", "cpu"])) == 0
        return (out / name).read_bytes()

    # the chain's shell scripts write what the port's CLI writes
    assert port(tmp_path / "port") == (results / name).read_bytes()
    # and from the JAX sweep's initial draws, the port's CLI writes the JAX
    # CLI's bytes on the same cache (the port draws its own weights from a
    # torch.Generator, so the two chains' own draws differ)
    jsweep.main(jsweep.extend_parser(jsweep.build_parser()).parse_args(
        flags + ["--result_root", str(tmp_path / "jax")]))
    assert os.listdir(tmp_path / "jax") == [name]
    _with_jax_inits(monkeypatch)
    assert port(tmp_path / "port_jax_draws") == (tmp_path / "jax" / name).read_bytes()


@pytest.mark.skipif(os.environ.get("RUN_REPRO_TEST") != "1",
                    reason="full-chain rehearsal is opt-in (RUN_REPRO_TEST=1); takes minutes")
def test_reproduce_all_torch_chain_on_synthetic_fixture(tmp_path):
    root, results = tmp_path / "assets", tmp_path / "results"
    merges = build_fixture(root)
    env = _chain_env(root, results, merges,
                     REPRO_EXTRACT_ARGS="--host_resolution 64 --batch_size 24",
                     REPRO_SWEEP_ARGS="--epochs 4 --epochs_feature_learning 2")
    proc = _run(["bash", "scripts/reproduce_all_torch.sh"], env=env, timeout=3000)
    _assert_chain(root, results, proc, REQUIRED_CELLS)

"""The port's demo scripts (``scripts/*_torch.py``) on the CPU at small
flags, and a static check that no script or notebook the port added imports
``jax`` or the JAX package.

- ``demo_train_torch.py`` exits 0, writes its figure and checkpoint, and
  prints the per-epoch trajectory that the port's ``train_all_epochs``
  gives when called directly with the demo's configuration (the printed
  4-digit accuracies equal).
- ``demo_visualization_torch.py`` exits 0 and writes its three figures, both
  with an untrained adapter (no ``.pth``) and through the port's adapter
  loader on a seeded MultipleAdapter ``.pth`` in the reference's key layout.
- ``synthetic_ablations_torch.py --small --rows 0`` prints the table with
  the linear-probing row.

Against the JAX package's twins, on the CPU, with both packages started
from the JAX package's initial draws (the loops' and the sweep's batch plans
come from the same numpy seeds):

- ``demo_train_torch.py`` prints the lines ``demo_train.py`` prints at the
  same flags (the ERM result, the per-epoch trajectory, the best result),
  the port's loop taking the weights the JAX loop's ``capture`` records;
- ``synthetic_ablations_torch.py --small --rows 0,7`` prints the table of
  ``synthetic_ablations.py`` at the same flags, all but the wall-time
  column, the port's stacked rows taking the JAX sweep's draws
  (``test_torch_sweep._with_jax_inits``).
"""

import glob
import importlib.util
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS, FEATURE_EPOCHS = 8, 3


def _script(name, *args, timeout=300):
    proc = subprocess.run([sys.executable, os.path.join("scripts", name), *args],
                          cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _load_script(name):
    spec = importlib.util.spec_from_file_location(name[:-3], os.path.join(REPO, "scripts", name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _main_output(monkeypatch, capsys, module, *argv):
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    capsys.readouterr()
    module.main()
    return capsys.readouterr().out


def test_demo_train_prints_the_jax_demos_lines(tmp_path, monkeypatch, capsys):
    from debiasing_multi_modal_tpu.train import loop as jloop
    from debiasing_multi_modal_tpu.utils import compilation_cache
    from debiasing_multi_modal_tpu_torch.train import loop as tloop

    monkeypatch.setattr(compilation_cache, "enable_persistent_cache", lambda: None)
    captures = []
    jax_run, port_run = jloop.train_all_epochs, tloop.train_all_epochs

    def capturing(*a, **kw):
        captures.append({})
        return jax_run(*a, capture=captures[-1], **kw)

    monkeypatch.setattr(jloop, "train_all_epochs", capturing)
    flags = ["--epochs", str(EPOCHS), "--feature_epochs", str(FEATURE_EPOCHS)]
    ref = _main_output(monkeypatch, capsys, _load_script("demo_train.py"), *flags,
                       "--out", str(tmp_path / "jax"))
    inits = iter(captures)
    monkeypatch.setattr(tloop, "train_all_epochs",
                        lambda *a, **kw: port_run(*a, init=next(inits), **kw))
    ours = _main_output(monkeypatch, capsys, _load_script("demo_train_torch.py"), *flags,
                        "--out", str(tmp_path / "port"), "--device", "cpu")
    assert len(captures) == 2 and next(inits, None) is None

    def results(out):
        return [line for line in out.splitlines() if not line.startswith("wrote ")]

    assert len(re.findall(r"\nepoch +\d+  test worst", ours)) == EPOCHS
    assert results(ours) == results(ref)
    assert (tmp_path / "port" / "embeddings_by_group.png").is_file()


def test_demo_train_prints_the_loops_trajectory(tmp_path):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import demo_train_torch as demo
    finally:
        sys.path.pop(0)
    from debiasing_multi_modal_tpu_torch.train.loop import train_all_epochs

    out = _script("demo_train_torch.py", "--epochs", str(EPOCHS), "--feature_epochs",
                  str(FEATURE_EPOCHS), "--out", str(tmp_path), "--device", "cpu")
    assert (tmp_path / "embeddings_by_group.png").is_file()
    assert glob.glob(str(tmp_path / "ckpt" / "ep*" / "host_meta.json"))
    printed = re.findall(r"epoch +(\d+)  test worst ([0-9.]+)  mean ([0-9.]+)", out)
    assert len(printed) == EPOCHS
    _, bundle = demo.demo_bundle("cpu")
    _, _, history = train_all_epochs(demo.debiased_config(EPOCHS, FEATURE_EPOCHS), bundle,
                                     verbose=False, device="cpu")
    want = [(str(i + 1), f"{t['worst_acc']:.4f}", f"{t['mean_acc']:.4f}")
            for i, t in enumerate(history["test"])]
    assert printed == want


@pytest.mark.parametrize("with_pth", [False, True])
def test_demo_visualization_writes_its_figures(tmp_path, with_pth):
    import torch

    from debiasing_multi_modal_tpu_torch.models.adapter import MultipleAdapterClassifier

    args = ["--out", str(tmp_path / "vis"), "--device", "cpu"]
    if with_pth:
        pth = tmp_path / "trained.pth"
        model = MultipleAdapterClassifier(64, 16, generator=torch.Generator().manual_seed(1))
        torch.save(model.state_dict(), pth)
        args += ["--pth", str(pth)]
    out = _script("demo_visualization_torch.py", *args)
    assert ("loaded MultipleAdapter checkpoint (D=64, hidden=16)" in out) == with_pth
    assert out.count("  group ") == 4
    for name in ("raw_vs_adapted.png", "visrepall_2d.png", "visrepall_3d.png"):
        assert (tmp_path / "vis" / name).is_file()


def test_synthetic_ablations_small_row():
    out = _script("synthetic_ablations_torch.py", "--small", "--rows", "0", "--device", "cpu")
    rows = [line for line in out.splitlines() if line.startswith("| linear_probing |")]
    assert len(rows) == 1 and " ± " in rows[0]


def test_synthetic_ablations_print_the_jax_scripts_table(monkeypatch, capsys):
    from debiasing_multi_modal_tpu.utils import compilation_cache
    from test_torch_sweep import _with_jax_inits

    monkeypatch.setattr(compilation_cache, "enable_persistent_cache", lambda: None)
    flags = ["--small", "--rows", "0,7"]
    ref = _main_output(monkeypatch, capsys, _load_script("synthetic_ablations.py"), *flags)
    _with_jax_inits(monkeypatch)
    ours = _main_output(monkeypatch, capsys, _load_script("synthetic_ablations_torch.py"),
                        *flags, "--device", "cpu")

    def table(out):  # every column but the wall time
        return [line.rsplit("|", 2)[0] for line in out.splitlines()
                if line.startswith("| ") and not line.startswith("| Method")]

    assert [row.split(" |")[0] for row in table(ours)] == ["| linear_probing", "| GCP-Seq-MA"]
    assert table(ours) == table(ref)


def _port_files():
    scripts = sorted(glob.glob(os.path.join(REPO, "scripts", "*_torch.*")))
    notebooks = sorted(glob.glob(os.path.join(REPO, "notebooks", "*_torch.ipynb")))
    return scripts, notebooks


def _imports_jax(source):
    bad = []
    for line in source.splitlines():
        s = line.strip()
        words = s.replace(",", " ").split()
        if s.startswith(("import ", "from ")) and len(words) > 1:
            top = words[1].split(".")[0]
            if top in ("jax", "jaxlib", "flax", "debiasing_multi_modal_tpu"):
                bad.append(s)
        if re.search(r"-m debiasing_multi_modal_tpu\.|import jax", s):
            bad.append(s)
    return bad


def test_port_scripts_and_notebooks_import_no_jax():
    scripts, notebooks = _port_files()
    assert len(scripts) == 9 and len(notebooks) == 3
    offenders = {}
    for path in scripts:
        with open(path) as f:
            offenders[path] = _imports_jax(f.read())
    for path in notebooks:
        with open(path) as f:
            cells = json.load(f)["cells"]
        offenders[path] = [bad for cell in cells if cell["cell_type"] == "code"
                           for bad in _imports_jax("".join(cell["source"]))]
        assert any('os.environ.get("NOTEBOOK_DEVICE", "cuda")' in "".join(c["source"])
                   for c in cells[:2])
    assert {p: b for p, b in offenders.items() if b} == {}
    # and the check itself sees an offender
    assert _imports_jax("import jax.numpy as jnp\nfrom debiasing_multi_modal_tpu.x import y")

"""Execute the three port notebooks end to end on the CPU (the twins of
tests/test_notebooks.py's; ``NOTEBOOK_DEVICE=cpu`` is their first cell's
device).

Opt-in via RUN_NB_TESTS=1, as the JAX notebooks' test is: each notebook
trains, aggregates and renders on the synthetic fixtures, a few minutes in
all:

    RUN_NB_TESTS=1 python -m pytest tests/test_torch_notebooks.py -q
"""

import os

import pytest

pytestmark = pytest.mark.skipif(
    not os.environ.get("RUN_NB_TESTS"),
    reason="notebook execution is opt-in (RUN_NB_TESTS=1); several minutes",
)

NOTEBOOKS = [
    "notebooks/demo_train_torch.ipynb",
    "notebooks/demo_final_performance_and_ablations_torch.ipynb",
    "notebooks/demo_visualization_torch.ipynb",
]


@pytest.mark.parametrize("path", NOTEBOOKS)
def test_port_notebook_executes(path, monkeypatch):
    import nbformat
    from nbclient import NotebookClient

    monkeypatch.setenv("NOTEBOOK_DEVICE", "cpu")  # the kernel inherits it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    nb = nbformat.read(os.path.join(root, path), as_version=4)
    client = NotebookClient(
        nb, timeout=600, kernel_name="python3",
        # kernel cwd must be notebooks/ — the cells use '..'-relative paths
        resources={"metadata": {"path": os.path.join(root, "notebooks")}},
    )
    client.execute()  # raises CellExecutionError on any failing cell

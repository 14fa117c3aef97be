"""The port's multi-rank dry run (``parallel/dryrun.py``, the counterpart
of ``__graft_entry__.py::dryrun_multichip``) passes on 4 gloo CPU ranks: a
dp = 2 x tp = 2 adapter epoch equal to the unsharded one, dp and
``fuse_qkv`` extraction, tp ViT and RN-attnpool extraction equal to dp
only, the seed-sharded and grid-stacked sweeps, kernels 1 and 4 on batch
shards, ring and Ulysses attention, and a 4-layer stack pipelined over 4
stages equal to the sequential stack."""

from debiasing_multi_modal_tpu_torch.parallel.dryrun import dryrun_multichip


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    done = dryrun_multichip(4, device="cpu", timeout_s=300)
    assert any(line.startswith("adapter dp=2 x tp=2") for line in done)
    for check in ("dp extraction", "fuse_qkv dp extraction == unfused",
                  "tp ViT and RN attnpool extraction == dp only",
                  "seed-sharded sweep (4 seeds)", "grid-stacked sweep (4 cells)",
                  "kernels 1 and 4 on batch shards", "ring attention", "ulysses attention",
                  "pipeline parallel: 4 layers over 4 stages x dp=1 x tp=1 x sp=1 "
                  "== sequential stack"):
        assert check in done
    assert capsys.readouterr().out.count(" ok\n") == len(done)

"""The port's multi-rank dry run (``parallel/dryrun.py``, the counterpart
of ``__graft_entry__.py::dryrun_multichip``) passes on 4 and on 8 gloo CPU
ranks: a dp x tp = 2 adapter epoch equal to the unsharded one in float64
within 1e-12 of scale and, in f32, within twice the order noise of the
unsharded epoch (its distance to float64 with its sums reordered), dp and
``fuse_qkv`` extraction, tp ViT and RN-attnpool extraction equal to dp
only, the seed-sharded and grid-stacked sweeps, kernels 1 and 4 on batch
shards, ring and Ulysses attention, and a 4-layer stack pipelined over 4
stages (4 ranks) or over dp 1 x pp 2 x tp 2 x sp 2 (8 ranks) equal to the
sequential stack."""

import re

from debiasing_multi_modal_tpu_torch.parallel.dryrun import dryrun_multichip


def _check_adapter_lines(done, dp):
    assert f"adapter dp={dp} x tp=2 epoch == unsharded in float64 (within 1e-12 of scale)" in done
    f32 = [line for line in done if line.startswith(f"adapter dp={dp} x tp=2 epoch in f32")]
    assert len(f32) == 1
    nums = dict(re.findall(r"([0-9.e+-]+) (sharded|unsharded|reordered)", f32[0]))
    limit = float(re.search(r"limit ([0-9.e+-]+)", f32[0]).group(1))
    f64 = float(re.search(r"float64 ([0-9.e+-]+)\)", f32[0]).group(1))
    inverse = {v: float(k) for k, v in nums.items()}
    assert inverse["sharded"] <= limit and f64 <= 1e-12
    assert inverse["unsharded"] <= inverse["reordered"] < limit


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    done = dryrun_multichip(4, device="cpu", timeout_s=300)
    _check_adapter_lines(done, 2)
    for check in ("dp extraction", "fuse_qkv dp extraction == unfused",
                  "tp ViT and RN attnpool extraction == dp only",
                  "seed-sharded sweep (4 seeds)", "grid-stacked sweep (4 cells)",
                  "kernels 1 and 4 on batch shards", "ring attention", "ulysses attention",
                  "pipeline parallel: 4 layers over 4 stages x dp=1 x tp=1 x sp=1 "
                  "== sequential stack"):
        assert check in done
    assert capsys.readouterr().out.count(" ok\n") == len(done)


def test_dryrun_multichip_on_eight_cpu_ranks(capsys):
    done = dryrun_multichip(8, device="cpu", timeout_s=300)
    _check_adapter_lines(done, 4)
    for check in ("tp ViT and RN attnpool extraction == dp only",
                  "seed-sharded sweep (8 seeds)", "grid-stacked sweep (8 cells)",
                  "pipeline parallel: 4 layers over 2 stages x dp=1 x tp=2 x sp=2 "
                  "== sequential stack"):
        assert check in done
    assert capsys.readouterr().out.count(" ok\n") == len(done)

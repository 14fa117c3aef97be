"""Data, tensor, sequence and pipeline parallelism on ``torch.distributed``
(port of ``parallel/``): meshes and row sharding (:mod:`.mesh`), process
groups and the multi-process launcher (:mod:`.multihost`), differentiable
collectives (:mod:`.collectives`), single-buffer staging (:mod:`.packing`),
tensor parallelism of the towers (:mod:`.tp`), the GPipe pipeline schedule
of the towers' stacks (:mod:`.pp`) and the multi-rank dry run
(:mod:`.dryrun`)."""

from debiasing_multi_modal_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_rows,
    gather_rows,
    make_mesh,
)
from debiasing_multi_modal_tpu_torch.parallel.pp import (  # noqa: F401
    pipeline_transformer,
    pipelined_text_encode,
    pipelined_vit_encode,
)
from debiasing_multi_modal_tpu_torch.parallel.tp import (  # noqa: F401
    shard_variables,
    tp_specs,
    validate_tp,
)

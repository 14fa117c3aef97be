"""Data, tensor and sequence parallelism on ``torch.distributed`` (port of
``parallel/``): meshes and row sharding (:mod:`.mesh`), process groups and
the multi-process launcher (:mod:`.multihost`), differentiable collectives
(:mod:`.collectives`), single-buffer staging (:mod:`.packing`), tensor
parallelism of the towers (:mod:`.tp`) and the multi-rank dry run
(:mod:`.dryrun`).  The pipeline schedule (``parallel/pp.py``) is not ported
yet."""

from debiasing_multi_modal_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_rows,
    gather_rows,
    make_mesh,
)
from debiasing_multi_modal_tpu_torch.parallel.tp import (  # noqa: F401
    shard_variables,
    tp_specs,
    validate_tp,
)

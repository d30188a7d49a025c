"""Multi-device parallelism on torch.distributed: mesh construction +
sharded demod scoring (counterpart of minimodem_tpu/parallel/)."""

from .sharding import (  # noqa: F401
    make_mesh,
    sharded_score_fn,
    sharded_decode_step,
)

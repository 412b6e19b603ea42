"""Port of ``radar_tpu/parallel/``: the multi-device layer on
``torch.distributed`` (SPMD ranks, one shard each), with the ring-halo
kernel K6."""

from .collectives import (covariance_snapshot_sharded, dbf_channel_sharded,
                          gather_along, mtd_cpi_sharded,
                          pulse_compress_range_sharded, shard_along)
from .mesh import AXIS_CH, AXIS_CPI, AXIS_DP, Mesh, make_mesh
from .multihost import (initialize, local_batch_slice, make_multihost_mesh,
                        run_ranks)
from .sharded import make_sharded_frame_processor

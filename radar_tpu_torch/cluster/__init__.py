"""Port of ``radar_tpu/cluster/``."""

from .connected import connected_components_np, connected_labels
from .legacy import cluster_single_stage_v5
from .stages import ClusteredTargets, cluster_stage1, cluster_stage2

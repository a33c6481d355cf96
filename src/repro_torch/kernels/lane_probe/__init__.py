from repro_torch.kernels.lane_probe.ops import lane_probe_level
from repro_torch.kernels.lane_probe.ref import lane_probe_level_ref

__all__ = ["lane_probe_level", "lane_probe_level_ref"]

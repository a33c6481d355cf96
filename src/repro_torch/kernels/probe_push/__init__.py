from repro_torch.kernels.probe_push.ops import probe_push
from repro_torch.kernels.probe_push.ref import probe_push_ref

__all__ = ["probe_push", "probe_push_ref"]

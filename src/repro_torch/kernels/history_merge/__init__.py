from repro_torch.kernels.history_merge.ops import history_merge  # noqa: F401
from repro_torch.kernels.history_merge.ref import history_merge_ref  # noqa: F401

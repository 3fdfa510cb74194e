from repro_torch.kernels.grouped_mm.ops import grouped_mm
from repro_torch.kernels.grouped_mm.ref import grouped_mm_ref

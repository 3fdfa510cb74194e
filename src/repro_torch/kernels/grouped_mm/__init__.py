from repro_torch.kernels.grouped_mm.ops import grouped_mm, grouped_mm_swiglu
from repro_torch.kernels.grouped_mm.ref import (grouped_mm_dgrad_ref,
                                                grouped_mm_ref,
                                                grouped_mm_swiglu_ref,
                                                grouped_mm_wgrad_ref,
                                                swiglu_grad)

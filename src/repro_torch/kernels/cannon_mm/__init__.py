from repro_torch.kernels.cannon_mm.ops import blocked_matmul
from repro_torch.kernels.cannon_mm.ref import matmul_ref

from repro_torch.kernels.ssd_scan.ops import (_state_passing, ssd_decode_step,
                                              ssd_scan)
from repro_torch.kernels.ssd_scan.ref import (ssd_apply_ref, ssd_chunk_ref,
                                              ssd_ref)

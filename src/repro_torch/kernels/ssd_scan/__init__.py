from repro_torch.kernels.ssd_scan.ops import ssd_decode_step, ssd_scan
from repro_torch.kernels.ssd_scan.ref import (_state_passing, ssd_apply_ref,
                                              ssd_chunk_ref, ssd_ref,
                                              ssd_scan_fused_ref)

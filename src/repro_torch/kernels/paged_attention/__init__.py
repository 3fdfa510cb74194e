from repro_torch.kernels.paged_attention.ops import (PagedPartial,
                                                     paged_attention,
                                                     table_routing)
from repro_torch.kernels.paged_attention.ref import (gather_pages, merge_rows,
                                                     paged_attention_ref)

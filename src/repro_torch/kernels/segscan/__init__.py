from repro_torch.kernels.segscan.ops import (segmented_cumsum,
                                             segscan_decoupled,
                                             segscan_kernel)
from repro_torch.kernels.segscan.ref import segmented_cumsum_ref

__all__ = ["segmented_cumsum", "segmented_cumsum_ref", "segscan_decoupled",
           "segscan_kernel"]

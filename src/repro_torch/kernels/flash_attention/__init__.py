"""Flash attention: the softmax-pair registration of the scan engine,
forward and backward, with its dense, blockwise and banded oracles."""

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd_kernel, flash_attention_kernel)
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, resolved_attention_schedule)
from repro_torch.kernels.flash_attention.ref import (banded_ref,
                                                     blockwise_ref,
                                                     masked_softmax, mha_ref)

__all__ = ["flash_attention", "flash_attention_bwd_kernel",
           "flash_attention_kernel", "banded_ref", "blockwise_ref",
           "masked_softmax", "mha_ref", "resolved_attention_schedule"]

from repro_torch.kernels.compact.ops import mask_compact, mask_compact_kernel

__all__ = ["mask_compact", "mask_compact_kernel"]

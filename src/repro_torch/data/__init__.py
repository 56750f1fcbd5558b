"""Training data: the deterministic synthetic pipeline and sequence packing
(the reference's ``data`` exports; ``make_batch_specs``, the batch's mesh
sharding, waits for the ``torch.distributed`` slice)."""

from repro_torch.data.packing import pack_documents, packing_offsets
from repro_torch.data.pipeline import Batch, DataConfig, SyntheticDataset

__all__ = [
    "Batch", "DataConfig", "SyntheticDataset", "pack_documents",
    "packing_offsets",
]

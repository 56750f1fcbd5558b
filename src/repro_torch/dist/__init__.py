"""Distribution layer: logical-axis sharding over the installed mesh.

The single-device surface of the reference's ``dist``. Its
``sanitize_spec``, ``shard_map`` and ``spec_for_params`` wait for the
``torch.distributed`` slice (ROADMAP Queue 1 item 8).
"""

from repro_torch.dist import sharding
from repro_torch.dist.sharding import current_mesh, resolve, shard, use_mesh

__all__ = ["current_mesh", "resolve", "shard", "sharding", "use_mesh"]

"""Monoid registrations for the scan engine.

Each kernel family is one of these entries; the kernel specs live next to
their library monoids in ``repro_torch.core.scan.assoc``. This slice
registers the sum.
"""

from __future__ import annotations

from repro_torch.core.scan import assoc

SUM = assoc.SUM_KERNEL

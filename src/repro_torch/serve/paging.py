"""Paged KV cache: page table + prefix-sum page allocator.

The PyTorch counterpart of the reference's ``serve/paging.py``. A POOL of
fixed-size pages and a per-sequence page-index vector replace the
contiguous layout's padded ``max_len`` buffer per slot — the vLLM
organization — with every allocator decision running as a relational
plan on the scan substrate (the paper's DB framing):

  * free-page discovery is stream compaction over the free bitmap
    (``relational.compact.filter_compact`` — one mask scan packs the free
    page ids to the front);
  * batched multi-sequence allocation slices that packed free list at
    offsets from an EXCLUSIVE prefix sum of the per-sequence page counts
    (``core.scan.cumsum(exclusive=True)``);
  * ``defrag`` is a stable ``relational.partition`` of the physical pages
    by liveness.

Those scans run on the allocator's ``device`` (the card by default: the
mask-compact and cumsum kernels; the tests pass the CPU); the bookkeeping
(bitmaps, refcounts, epochs, tables) lives on the host in numpy, as in
the reference.

Physical page 0 is the NULL page: never allocated, and every unassigned
page-table entry points at it. Decode writes for inactive pool rows and
gathers past a sequence's allocated extent land there harmlessly — the
zeroed-probability masking turns those positions into exact-zero softmax
contributions, which keeps paged decode BITWISE identical to the
contiguous layout (``models/layers/attention.py``).

Copy-on-write sharing rides on a per-page REFCOUNT: ``alloc`` hands a
page out at refcount 1, ``retain`` adds table references, ``release``
decrements and frees only at zero. ``PrefixRegistry`` indexes prompt-prefix
chunks to physical pages.

Observability: the allocator publishes ``serve.pages.in_use`` /
``serve.pages.free`` / ``serve.pages.fragmentation`` gauges plus
``serve.pages.alloc`` / ``serve.pages.free_op`` / ``serve.pages.defrag``
trace instants, and bumps an engine's stats counters where given.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core import scan as scanlib
from repro_torch.obs import trace
from repro_torch.obs.metrics import Registry
from repro_torch.relational import compact as rel_compact
from repro_torch.relational import partition as rel_partition

#: Block kinds whose KV cache is paged. Local (sliding-window) layers page
#: their O(window) ring: it rides the first ``window // page_size`` entries
#: of the (shared) page-table row. Recurrent kinds carry O(1) state per
#: slot — nothing to page.
PAGED_KINDS = ("global", "local", "moe", "shared_attn")


def paged_layer_names(cfg) -> tuple:
    """Stacked-block names (``p{pos}_{kind}``) whose KV leaves page."""
    return tuple(f"p{pos}_{kind}"
                 for pos, kind in enumerate(cfg.layer_pattern)
                 if kind in PAGED_KINDS)


def pages_for(length: int, page_size: int) -> int:
    """Pages needed to hold positions ``[0, length)`` plus the slot the
    NEXT decode write lands in (position ``length``)."""
    return length // page_size + 1


def validate_paged_support(cfg, max_len: int, page_size: int) -> None:
    """Construction-time guard for the paged layout: unsupported
    layer/geometry combinations fail here, naming the ``p{pos}_{kind}``
    layer."""
    if getattr(cfg, "is_encdec", False):
        raise ValueError("paged cache layout supports decoder-only models")
    if max_len % page_size:
        raise ValueError(
            f"max_len={max_len} not a multiple of page_size={page_size}")
    bad = []
    for pos, kind in enumerate(cfg.layer_pattern):
        if kind != "local":
            continue
        w = getattr(cfg, "sliding_window", None)
        if not w:
            bad.append(f"p{pos}_local (sliding_window unset)")
        elif min(int(w), int(max_len)) % page_size:
            bad.append(
                f"p{pos}_local (ring extent min(window={w}, "
                f"max_len={max_len}) not a multiple of "
                f"page_size={page_size})")
    if bad:
        raise ValueError(
            "paged cache layout cannot host: " + "; ".join(bad))
    if not paged_layer_names(cfg):
        raise ValueError(
            f"paged cache layout needs at least one attention layer; "
            f"pattern {cfg.layer_pattern} has none")


class PageTable:
    """Per-slot page-index vectors (host bookkeeping + device view).

    ``table[slot, j]`` is the physical page backing logical page ``j`` of
    the sequence in ``slot``; unassigned entries are 0 (the null page).
    ``device(dev)`` returns the (slots, pages_per_seq) int32 tensor the
    paged step gathers through.
    """

    def __init__(self, num_slots: int, pages_per_seq: int):
        self.table = np.zeros((num_slots, pages_per_seq), np.int32)
        self.counts = np.zeros(num_slots, np.int64)

    def assign(self, slot: int, pages: np.ndarray) -> None:
        n = int(self.counts[slot])
        pages = np.asarray(pages, np.int32)
        if n + pages.size > self.table.shape[1]:
            raise ValueError(
                f"slot {slot}: {n} + {pages.size} pages exceed "
                f"pages_per_seq={self.table.shape[1]}")
        self.table[slot, n:n + pages.size] = pages
        self.counts[slot] = n + pages.size

    def pages_of(self, slot: int) -> np.ndarray:
        return self.table[slot, : int(self.counts[slot])].copy()

    def release(self, slot: int) -> np.ndarray:
        pages = self.pages_of(slot)
        self.table[slot] = 0
        self.counts[slot] = 0
        return pages

    def remap(self, new_of_old: np.ndarray) -> None:
        """Rewrite every live entry through an old->new page permutation
        (defrag). Null entries stay null (``new_of_old[0] == 0``)."""
        self.table = np.asarray(new_of_old, np.int32)[self.table]

    def device(self, device="cuda") -> torch.Tensor:
        return torch.from_numpy(self.table).to(device)


class PageAllocator:
    """Free-page bookkeeping whose alloc/free paths are relational plans.

    Page 0 is reserved as the null page at construction and never handed
    out. Every live page carries a refcount: ``alloc`` hands pages out at
    refcount 1, ``retain`` adds copy-on-write sharers, ``release``
    decrements and frees only at zero. ``epoch[p]`` counts free->live
    transitions of page ``p`` so weak references (the prefix registry's
    partial-page entries) can detect reuse. ``stats`` and ``metrics`` (an
    obs ``Registry``) are optional write-through mirrors; ``device`` is
    where the allocation scans run.
    """

    def __init__(self, num_pages: int, page_size: int, *,
                 stats=None, metrics: Optional[Registry] = None,
                 device="cuda"):
        if num_pages < 2:
            raise ValueError(f"num_pages={num_pages} leaves no allocatable "
                             f"page after the null page")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.device = torch.device(device)
        self.free = np.ones(num_pages, bool)
        self.free[0] = False                     # null page: pinned live
        self.refcount = np.zeros(num_pages, np.int64)
        self.refcount[0] = 1                     # null page: pinned ref
        self.epoch = np.zeros(num_pages, np.int64)
        self.stats = stats
        self.metrics = metrics
        self._publish()

    # -- introspection ---------------------------------------------------
    @property
    def free_count(self) -> int:
        return int(self.free.sum())

    @property
    def in_use(self) -> int:
        return self.num_pages - 1 - self.free_count   # excl. null page

    def longest_free_run(self) -> int:
        """Length of the largest contiguous free extent (0 when full)."""
        idx = np.flatnonzero(self.free)
        if idx.size == 0:
            return 0
        runs = np.split(idx, np.flatnonzero(np.diff(idx) > 1) + 1)
        return max(len(r) for r in runs)

    def fragmentation(self) -> float:
        """1 - (largest contiguous free run / free pages): 0 when all free
        memory is one extent, approaching 1 as it shatters, and 1.0 at
        full occupancy (no free extent at all: the pool is tightest)."""
        n_free = self.free_count
        if n_free == 0:
            return 1.0
        return 1.0 - self.longest_free_run() / n_free

    def _publish(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("serve.pages.in_use").set(self.in_use)
            self.metrics.gauge("serve.pages.free").set(self.free_count)
            self.metrics.gauge("serve.pages.fragmentation").set(
                self.fragmentation())

    # -- alloc / free (the relational plans) -----------------------------
    def alloc(self, counts: Sequence[int]) -> "list[np.ndarray] | None":
        """Batched multi-sequence allocation: ``counts[i]`` pages for
        sequence ``i``. Returns per-sequence physical page-id vectors, or
        None (and counts a failure) when the pool cannot satisfy the whole
        batch — allocation is all-or-nothing."""
        counts = [int(c) for c in counts]
        total = sum(counts)
        if any(c < 0 for c in counts):
            raise ValueError(f"bad page counts {counts}")
        if total == 0:
            # a growth tick where no live row crosses a page boundary
            return [np.empty(0, np.int64) for _ in counts]
        if total > self.free_count:
            if self.stats is not None:
                self.stats.page_alloc_failures += 1
            trace.instant("serve.pages.alloc", ok=False, want=total,
                          free=self.free_count)
            return None
        dev = self.device
        # Free-page discovery: stream compaction over the free bitmap —
        # one mask scan packs the free page ids to the front.
        ids, n = rel_compact.filter_compact(
            torch.arange(self.num_pages, dtype=torch.int32, device=dev),
            torch.from_numpy(self.free).to(dev))
        ids = ids[: int(n)].cpu().numpy()
        # Batched gather offsets: the exclusive prefix sum of the
        # per-sequence counts slices the packed free list (paper §1 —
        # "new index values" from a histogram scan).
        offs = scanlib.cumsum(
            torch.tensor(counts, dtype=torch.int32, device=dev),
            exclusive=True).cpu().numpy()
        out = [ids[int(o): int(o) + c].astype(np.int64)
               for o, c in zip(offs, counts)]
        flat = np.concatenate(out)
        # A real exception, not an assert: handing out a live page
        # corrupts every sharer of it.
        if not self.free[flat].all() or (self.refcount[flat] != 0).any():
            raise RuntimeError(
                f"double allocation: pages "
                f"{flat[~self.free[flat] | (self.refcount[flat] != 0)]} "
                f"are already live")
        self.free[flat] = False
        self.refcount[flat] = 1
        self.epoch[flat] += 1
        if self.stats is not None:
            self.stats.page_allocs += total
        self._publish()
        trace.instant("serve.pages.alloc", ok=True, pages=total,
                      seqs=len(counts), free=self.free_count)
        return out

    def retain(self, pages: np.ndarray) -> None:
        """Add one reference per page — a new slot mapping shared
        (copy-on-write) pages, or the prefix registry pinning a prompt
        page beyond its donor's lifetime."""
        pages = np.asarray(pages, np.int64)
        if pages.size == 0:
            return
        if (pages == 0).any():
            raise ValueError("cannot retain the null page")
        if (self.refcount[pages] <= 0).any():
            raise ValueError(
                f"retain of free pages {pages[self.refcount[pages] <= 0]}")
        np.add.at(self.refcount, pages, 1)

    def release(self, pages: np.ndarray) -> None:
        """Drop one reference per page; pages reaching refcount 0 return
        to the free pool (``stats.page_frees`` counts only those)."""
        pages = np.asarray(pages, np.int64)
        if pages.size == 0:
            return
        if (pages == 0).any():
            raise ValueError("cannot free the null page")
        dec = np.bincount(pages, minlength=self.num_pages)
        over = dec > self.refcount
        if over.any():
            raise ValueError(f"double free: {np.flatnonzero(over)}")
        self.refcount -= dec
        freed = (self.refcount == 0) & (dec > 0)
        n_freed = int(freed.sum())
        self.free |= freed
        if self.stats is not None:
            self.stats.page_frees += n_freed
        self._publish()
        trace.instant("serve.pages.free_op", pages=int(pages.size),
                      freed=n_freed, free=self.free_count)

    # -- defrag (partition by liveness) ----------------------------------
    def defrag_plan(self) -> np.ndarray:
        """Old->new physical page permutation compacting live pages to the
        front: a stable ``relational.partition`` of the page ids by
        liveness (bucket 0 = live, bucket 1 = free). Stability keeps the
        null page at index 0 and preserves live-page relative order."""
        bucket = torch.from_numpy(self.free.astype(np.int32)).to(self.device)
        plan = rel_partition.partition_plan(bucket, 2)
        return plan.dest.cpu().numpy()

    def apply_defrag(self, new_of_old: np.ndarray) -> int:
        """Commit a defrag plan: permute refcounts/epochs through the
        old->new mapping and rebuild the free bitmap as refcount == 0.
        Returns live pages moved. (The caller permutes the pools and
        remaps its page tables and prefix registry through the same
        plan.)"""
        new_of_old = np.asarray(new_of_old)
        moved = int(((new_of_old != np.arange(self.num_pages))
                     & ~self.free).sum())
        rc = np.zeros_like(self.refcount)
        rc[new_of_old] = self.refcount
        self.refcount = rc
        ep = np.zeros_like(self.epoch)
        ep[new_of_old] = self.epoch
        self.epoch = ep
        self.free = self.refcount == 0
        self.free[0] = False                            # null page pinned
        if self.stats is not None:
            self.stats.defrags += 1
        self._publish()
        trace.instant("serve.pages.defrag", moved=moved,
                      live=self.in_use, free=self.free_count)
        return moved


class PrefixRegistry:
    """Engine-level prompt-prefix -> physical-page cache (COW sharing).

    Keys are the raw prompt-token bytes up to each page boundary — a CHAIN
    key: matching page ``j`` implies pages ``[0, j)`` matched the same
    prompt too. FULL prompt pages register STRONG (the registry holds one
    allocator reference, so a common system prompt's pages survive their
    donor); the PARTIAL tail page registers WEAK (no reference, validated
    against the allocator's page ``epoch`` at match time so a
    freed-and-reused page never leaks into a new request). ``capacity``
    is an LRU entry cap; evicting a strong entry releases its reference.
    ``remap`` follows a defrag permutation.
    """

    def __init__(self, allocator: PageAllocator, page_size: int,
                 capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity={capacity} must be >= 1")
        self.allocator = allocator
        self.page_size = int(page_size)
        self.capacity = int(capacity)
        # key bytes -> (physical page, strong, epoch at registration)
        self._entries: "OrderedDict[bytes, tuple]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def _lookup(self, key: bytes):
        ent = self._entries.get(key)
        if ent is None:
            return None
        page, strong, epoch = ent
        if not strong and (self.allocator.refcount[page] <= 0
                           or self.allocator.epoch[page] != epoch):
            del self._entries[key]              # stale weak entry
            return None
        self._entries.move_to_end(key)
        return page

    def match(self, prompt: np.ndarray) -> "list[int]":
        """Longest chain of registered pages covering ``prompt``: full
        page-sized chunks first, then (only on a complete full-page match)
        the exact partial tail. The caller retains what it maps."""
        ps = self.page_size
        prompt = np.ascontiguousarray(prompt, np.int32)
        pages = []
        full = int(prompt.size) // ps
        for j in range(full):
            page = self._lookup(prompt[: (j + 1) * ps].tobytes())
            if page is None:
                return pages
            pages.append(int(page))
        if prompt.size % ps:
            page = self._lookup(prompt.tobytes())
            if page is not None:
                pages.append(int(page))
        return pages

    def register(self, prompt: np.ndarray, pages: np.ndarray) -> int:
        """Register a just-installed prompt's prefix chunks against the
        physical pages now holding them. Returns new entries added."""
        ps = self.page_size
        prompt = np.ascontiguousarray(prompt, np.int32)
        S = int(prompt.size)
        chunks = [((j + 1) * ps, int(pages[j]), True)
                  for j in range(S // ps)]
        if S % ps:
            chunks.append((S, int(pages[S // ps]), False))
        added = 0
        for extent, page, strong in chunks:
            key = prompt[:extent].tobytes()
            if self._lookup(key) is not None:
                continue                         # live entry already serves
            if strong:
                self.allocator.retain(np.array([page]))
            self._entries[key] = (page, strong,
                                  int(self.allocator.epoch[page]))
            added += 1
            while len(self._entries) > self.capacity:
                _, (p0, s0, _) = self._entries.popitem(last=False)
                if s0:
                    self.allocator.release(np.array([p0]))
        return added

    def remap(self, new_of_old: np.ndarray) -> None:
        """Rewrite entry page ids through a defrag permutation (epochs ride
        along inside the allocator's own permuted array)."""
        new_of_old = np.asarray(new_of_old)
        self._entries = OrderedDict(
            (k, (int(new_of_old[p]), s, e))
            for k, (p, s, e) in self._entries.items())

    def strong_pages(self) -> "list[int]":
        """Pages the registry itself holds a reference on (audit)."""
        return [p for p, s, _ in self._entries.values() if s]

    def clear(self) -> None:
        """Drop every entry, releasing strong references."""
        strong = self.strong_pages()
        self._entries.clear()
        if strong:
            self.allocator.release(np.asarray(strong, np.int64))


# ---------------------------------------------------------------------------
# device-side pool views (used by the paged step / an engine's admission)
# ---------------------------------------------------------------------------


def gather_pages(pool: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """(P, Hkv, ps, hd) pool x (B, n_log) table -> (B, Hkv, n_log·ps, hd)
    contiguous per-row view — the shape the cached attention path
    consumes, so paged decode reuses it bit for bit."""
    P, Hkv, ps, hd = pool.shape
    B, n_log = page_table.shape
    g = pool[page_table.long()].transpose(1, 2)   # (B, Hkv, n_log, ps, hd)
    return g.reshape(B, Hkv, n_log * ps, hd)


def scatter_token(pool: torch.Tensor, values: torch.Tensor,
                  page_table: torch.Tensor, write_at: torch.Tensor
                  ) -> torch.Tensor:
    """Write one token row per sequence back into (a copy of) the pool.

    pool (P, Hkv, ps, hd); values (B, Hkv, hd) — the K or V vector each
    row just appended; write_at (B,) absolute positions. Rows whose
    logical page is unassigned (inactive slots at position 0) hit the
    null page.
    """
    ps = pool.shape[2]
    write_at = write_at.long()
    phys = torch.gather(page_table.long(), 1, (write_at // ps)[:, None])[:, 0]
    off = write_at % ps
    out = pool.clone()
    # advanced indices (phys, off) straddle the Hkv slice, so they
    # broadcast to the front: the target view is (B, Hkv, hd)
    out[phys, :, off, :] = values.to(pool.dtype)
    return out


def scatter_prefix(pool: torch.Tensor, row: torch.Tensor,
                   pages: np.ndarray, start_page: int = 0) -> torch.Tensor:
    """Copy a prefilled contiguous cache row into freshly allocated pages
    of (a copy of) the pool. pool (per, P, Hkv, ps, hd); row (per, 1, Hkv,
    L, hd) with L >= (start_page + len(pages))·ps; pages (n,) physical ids
    backing logical pages [start_page, start_page + n) — a nonzero start
    skips the logical pages a prefix-sharing install mapped from the
    registry."""
    per, P, Hkv, ps, hd = pool.shape
    n = int(np.asarray(pages).size)
    if n == 0:
        return pool
    lo = int(start_page) * ps
    seg = row[:, 0, :, lo: lo + n * ps].reshape(per, Hkv, n, ps, hd)
    seg = seg.transpose(1, 2)                      # (per, n, Hkv, ps, hd)
    idx = torch.from_numpy(np.asarray(pages, np.int64)).to(pool.device)
    out = pool.clone()
    out[:, idx] = seg.to(pool.dtype)
    return out


def gather_prefix(pool: torch.Tensor, page_table: torch.Tensor
                  ) -> torch.Tensor:
    """(per, P, Hkv, ps, hd) pool x (B, n_log) table ->
    (per, B, Hkv, n_log·ps, hd): the contiguous staging-cache view of a
    table row (inverse of ``scatter_prefix``)."""
    return torch.stack([gather_pages(p, page_table) for p in pool])

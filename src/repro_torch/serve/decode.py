"""Requests served the way the reference's engine serves them: each prompt
prefilled alone into a cache of its own, then greedy decode of all rows
together with a per-row ``cache_len``, through a contiguous cache (the
rows concatenated) or through paged pools (pages from ``PageAllocator``,
a ``PageTable``, each prefill installed by ``scatter_prefix`` as the
reference's engine installs one, ``engine.py:531``).

Not one of the reference's modules: the engine, which will own this
install, waits for a later slice (ROADMAP Queue 1 item 7). Until then
``chip_smoke.py``'s serve phase and the tests drive the model path
through these functions.
"""

import torch

from repro_torch.models import lm
from repro_torch.serve import paging


def prefill_each(model, cfg, prompts, max_len, **kw):
    """[(last logits (1, V), cache)] of each (S,) prompt prefilled alone."""
    return [lm.prefill(model, p[None], cfg, max_len, **kw) for p in prompts]


def contiguous_cache(caches):
    """The single-row caches as one batch (rows on axis 1, after the
    periods axis)."""
    return lm.tree_map(lambda *xs: torch.cat(xs, dim=1), *caches)


def paged_cache(cfg, caches, lens, max_len, page_size, steps):
    """The single-row caches installed into page pools: each row gets the
    pages of its prompt and of ``steps`` decode writes; attention layers'
    K/V go to their pages (a local layer's ring to its first
    ring // page_size pages), recurrent state stays a row of the batch.
    Returns (cache, allocator, table)."""
    paging.validate_paged_support(cfg, max_len, page_size)
    names = paging.paged_layer_names(cfg)
    dev = caches[0][names[0]]["kv"]["k"].device
    want = [paging.pages_for(int(n) + steps, page_size) for n in lens]
    alloc = paging.PageAllocator(1 + sum(want), page_size, device=dev)
    table = paging.PageTable(len(caches), max_len // page_size)
    cache = contiguous_cache([{k: v for k, v in c.items() if k not in names}
                              for c in caches])
    ring = min(cfg.sliding_window or max_len, max_len) // page_size
    pools = {}
    for name in names:
        k = caches[0][name]["kv"]["k"]
        per, _, hkv, _, hd = k.shape
        pools[name] = {key: torch.zeros((per, alloc.num_pages, hkv,
                                         page_size, hd), dtype=k.dtype,
                                        device=dev)
                       for key in ("k_pages", "v_pages")}
    for slot, (c, pages) in enumerate(zip(caches, alloc.alloc(want))):
        table.assign(slot, pages)
        for name in names:
            lp = pages[:ring] if name.endswith("_local") else pages
            for key in ("k", "v"):
                pools[name][key + "_pages"] = paging.scatter_prefix(
                    pools[name][key + "_pages"], c[name]["kv"][key], lp)
    pt = table.device(dev)
    for name in names:
        per = pools[name]["k_pages"].shape[0]
        cache[name] = {"kv": dict(pools[name],
                                  pt=pt[None].expand((per,) + pt.shape))}
    return cache, alloc, table


def greedy_decode(model, cfg, cache, lens, first, steps, run=None):
    """``steps`` greedy decode steps of all rows from the tokens ``first``
    (B,) at per-row lengths ``lens`` (B,): (tokens (B, steps), logits
    (steps, B, V)). ``run(fn)`` calls each step's ``fn`` (a timer, say)."""
    run = run or (lambda fn: fn())
    toks, logits = [first], []
    n = lens.clone()
    for _ in range(steps):
        lg, cache = run(lambda: lm.decode_step(model, toks[-1][:, None],
                                               cache, n, cfg))
        logits.append(lg)
        toks.append(lg.argmax(-1))
        n = n + 1
    return torch.stack(toks[1:], 1), torch.stack(logits)

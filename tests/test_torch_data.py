"""The port's data pipeline and packing (``repro_torch.data``) against the
reference's: ``_batch_for_step`` bit for bit for several (seed, step)
pairs, with and without ``frontend_tokens``, and through
``SyntheticDataset``; the packing cases of ``tests/test_segmented_moe.py``
re-run on the port and held bit for bit against the reference, zero-length
documents included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import packing as jpacking
from repro.data import pipeline as jpipeline
from repro_torch.data import packing, pipeline


@pytest.mark.parametrize("frontend", (0, 3))
@pytest.mark.parametrize("seed,step", ((0, 0), (3, 7), (11, 123456)))
def test_batch_for_step_bitwise(seed, step, frontend):
    kw = dict(seq_len=48, global_batch=3, vocab_size=1000, seed=seed,
              mean_doc_len=8, frontend_tokens=frontend, frontend_dim=16)
    want = jpipeline._batch_for_step(jpipeline.DataConfig(**kw), step)
    got = pipeline._batch_for_step(pipeline.DataConfig(**kw), step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape
        assert got[k].tobytes() == want[k].tobytes(), k
    batch = pipeline.SyntheticDataset(pipeline.DataConfig(**kw),
                                      device="cpu").batch_at(step)
    ref = jpipeline.SyntheticDataset(jpipeline.DataConfig(**kw)).batch_at(
        step)
    for k in ref:
        assert batch[k].numpy().tobytes() == np.asarray(ref[k]).tobytes()
    assert batch.tokens is batch["tokens"]


def test_dataset_iterates_from_start_step():
    cfg = pipeline.DataConfig(seq_len=8, global_batch=2, vocab_size=50)
    ds = pipeline.SyntheticDataset(cfg, device="cpu", start_step=5)
    first, second = next(ds), next(ds)
    assert ds.step == 7
    assert torch.equal(first["tokens"], ds.batch_at(5)["tokens"])
    assert torch.equal(second["tokens"], ds.batch_at(6)["tokens"])


def _both_offsets(lengths, row_len):
    jr, jc = jpacking.packing_offsets(jnp.asarray(lengths, jnp.int32),
                                      row_len)
    tr, tc = packing.packing_offsets(torch.tensor(lengths,
                                                  dtype=torch.int32),
                                     row_len)
    assert tr.dtype == tc.dtype == torch.int32
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    return tr.numpy(), tc.numpy()


def test_packing_offsets_and_scatter():
    lengths = [3, 4, 2, 5, 1]
    rows, cols = _both_offsets(lengths, 8)
    # no document crosses its row boundary
    assert ((cols + np.asarray(lengths)) <= 8).all()
    docs = np.arange(1, 5 * 6 + 1).reshape(5, 6).astype(np.int32)
    toks, segs = packing.pack_documents(
        torch.from_numpy(docs), torch.tensor(lengths, dtype=torch.int32),
        row_len=8, num_rows=3)
    jt, js = jpacking.pack_documents(jnp.asarray(docs),
                                     jnp.asarray(lengths, jnp.int32),
                                     row_len=8, num_rows=3)
    assert np.array_equal(toks.numpy(), np.asarray(jt))
    assert np.array_equal(segs.numpy(), np.asarray(js))
    for d, ln in enumerate(lengths):
        r, c = rows[d], cols[d]
        assert np.array_equal(toks.numpy()[r, c: c + ln], docs[d, :ln])
        assert (segs.numpy()[r, c: c + ln] == d + 1).all()


def test_packing_zero_length_docs():
    """Zero-length documents do not perturb the packing of the others nor
    open phantom rows, in both packages alike."""
    lengths = [8, 0, 3, 0, 0, 5]                 # 8 fills a row
    rows, cols = _both_offsets(lengths, 8)
    nz = np.asarray(lengths) > 0
    drows, dcols = _both_offsets([n for n in lengths if n], 8)
    assert np.array_equal(rows[nz], drows)
    assert np.array_equal(cols[nz], dcols)
    docs = np.arange(1, 6 * 9 + 1).reshape(6, 9).astype(np.int32)
    toks, segs = packing.pack_documents(
        torch.from_numpy(docs), torch.tensor(lengths, dtype=torch.int32),
        row_len=8, num_rows=3)
    jt, js = jpacking.pack_documents(jnp.asarray(docs),
                                     jnp.asarray(lengths, jnp.int32),
                                     row_len=8, num_rows=3)
    assert np.array_equal(toks.numpy(), np.asarray(jt))
    assert np.array_equal(segs.numpy(), np.asarray(js))
    assert int((segs == 2).sum()) == 0       # doc 1 is empty
    assert int((segs == 3).sum()) == 3       # doc 2 intact
    assert int((segs == 6).sum()) == 5       # doc 5 intact


@pytest.mark.parametrize("seed", range(4))
def test_packing_random_lengths_bitwise(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 9, 40)
    lengths[rng.random(40) < 0.2] = 0
    docs = rng.integers(1, 100, (40, 8)).astype(np.int32)
    rows, _ = _both_offsets(lengths.tolist(), 8)
    n_rows = int(rows.max()) + 1
    toks, segs = packing.pack_documents(
        torch.from_numpy(docs), torch.from_numpy(lengths.astype(np.int32)),
        row_len=8, num_rows=n_rows, pad_id=-1)
    jt, js = jpacking.pack_documents(jnp.asarray(docs),
                                     jnp.asarray(lengths, jnp.int32),
                                     row_len=8, num_rows=n_rows, pad_id=-1)
    assert np.array_equal(toks.numpy(), np.asarray(jt))
    assert np.array_equal(segs.numpy(), np.asarray(js))


def test_segment_starts_tolerate_duplicate_starts():
    """Scatter-added begin-flags above 1 begin one segment each: ids do
    not skip, as in the reference."""
    starts = [1, 0, 2, 0, 1, 0]
    got = packing.segment_starts_to_ids(torch.tensor(starts,
                                                     dtype=torch.int32))
    want = jpacking.segment_starts_to_ids(jnp.asarray(starts, jnp.int32))
    assert got.tolist() == [1, 1, 2, 2, 3, 3]
    assert np.array_equal(got.numpy(), np.asarray(want))

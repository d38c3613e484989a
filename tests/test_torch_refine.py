"""The facades' full-precision answer (``utils/refine``) on the CPU.

``refine_on_device`` over S tables whose ids interleave (id g is row
``g // S`` of table ``g % S``, as in ``ShardedIndex``) returns the ids and
distances of the same call over those rows stacked into one table, for
S = 1, 2 and 3.  ``HostMirror`` reads its host copy (float64 refine) while
the tables take at most ``MIRROR_MAX_BYTES``, the budget itself included,
and the devices (float32 refine) one byte past it: the same ids, and the
distances of ``refine_pairs`` and ``refine_on_device`` respectively."""

import numpy as np
import pytest
import torch

from hnswindex_torch.utils import refine as TR

C, D, B, W, K = 40, 16, 6, 12, 5


def _case(S, seed=21):
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.standard_normal((C, D)).astype(np.float32))
              for _ in range(S)]
    stacked = torch.stack(tables, dim=1).reshape(S * C, D)   # row g = id g
    q = rng.standard_normal((B, D)).astype(np.float32)
    ids = rng.integers(0, S * C, (B, W)).astype(np.int32)
    ids[::2, -3:] = -1                     # padded candidate slots
    return tables, stacked, q, ids


@pytest.mark.parametrize("metric", ["sq_euclid", "cosine"])
@pytest.mark.parametrize("S", [1, 2, 3])
def test_interleaved_tables_equal_one_stacked_table(S, metric):
    tables, stacked, q, ids = _case(S)
    want = TR.refine_on_device(metric, stacked, q, ids, K)
    got = TR.refine_on_device(metric, tables, q, ids, K)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32


@pytest.mark.parametrize("S", [1, 3])
def test_mirror_refines_on_the_host_up_to_its_budget(S, monkeypatch):
    tables, stacked, q, ids = _case(S, seed=22)
    mirror = TR.HostMirror("sq_euclid", lambda: tables)
    rows = stacked.numpy()[np.clip(ids, 0, S * C - 1)]

    monkeypatch.setattr(TR, "MIRROR_MAX_BYTES", S * C * D * 4)
    assert mirror.mirrorable()
    host = mirror.refine(q, ids, K)
    assert mirror._host is not None
    want = TR.refine_pairs("sq_euclid", q, ids, rows, K)
    np.testing.assert_array_equal(host[0], want[0])
    np.testing.assert_array_equal(host[1], want[1])
    np.testing.assert_array_equal(mirror.rows(ids), rows)

    monkeypatch.setattr(TR, "MIRROR_MAX_BYTES", S * C * D * 4 - 1)
    mirror.clear()
    assert not mirror.mirrorable()
    dev = mirror.refine(q, ids, K)
    assert mirror._host is None
    want = TR.refine_on_device("sq_euclid", stacked, q, ids, K)
    np.testing.assert_array_equal(dev[0], host[0])
    np.testing.assert_array_equal(dev[1], want[1])
    np.testing.assert_array_equal(mirror.rows(ids), rows)
    assert mirror._host is None

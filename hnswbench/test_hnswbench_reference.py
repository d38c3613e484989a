"""The plain reference against a numpy brute force, the control's lower
precision, the checks' arithmetic and the scan's work count."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hnswbench import checks, datagen, reference, roofline


def _numpy_topk(metric, base, q, k):
    b, x = base.astype(np.float64), q.astype(np.float64)
    if metric == "sq_euclid":
        d = ((x[:, None, :] - b[None]) ** 2).sum(-1)
    else:
        d = 1.0 - (x @ b.T) / (np.linalg.norm(x, axis=1)[:, None]
                               * np.linalg.norm(b, axis=1)[None])
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return order, np.take_along_axis(d, order, 1)


def _data(metric, n=3000, nq=64, dim=24, seed=5):
    cfg = {"rows": n, "dim": dim, "data": {
        "rows_per_cluster": 300, "noise": 0.03,
        "normalize": metric == "cosine"}}
    g = datagen.Clustered(cfg, seed, "cpu")
    return g.rows("corpus", 0, n), g.rows("query", 0, nq)


@pytest.mark.parametrize("metric", reference.METRICS)
def test_topk_equals_numpy_brute_force(metric, monkeypatch):
    monkeypatch.setattr(reference, "ROW_BLOCK", 700)   # several row blocks
    monkeypatch.setattr(reference, "Q_BLOCK", 40)
    base, q = _data(metric)
    rows, d = reference.topk(metric, base, q, 10)
    want_r, want_d = _numpy_topk(metric, base.numpy(), q.numpy(), 10)
    np.testing.assert_array_equal(rows.numpy(), want_r)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("metric", reference.METRICS)
def test_control_precision_is_lower(metric):
    base, q = _data(metric)
    rows, d = reference.topk(metric, base, q, 10, precision="tf32")
    exact = reference.direct(metric, q, base[rows])
    err = ((d.double() - exact).abs() / exact).max().item()
    assert err > 1e-4
    with pytest.raises(ValueError):
        reference.topk(metric, base, q, 10, precision="bf16")


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11 + 2.0 ** -12,
                      1.0 + 2.0 ** -12, -3.0])
    r = reference._tf32_round(x)
    assert r.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, 1.0, -3.0]


def test_datagen_is_seeded_and_streams_are_held_out():
    cfg = {"rows": 4000, "dim": 8, "data": {
        "rows_per_cluster": 500, "noise": 0.03, "normalize": False}}
    a = datagen.Clustered(cfg, 2 ** 31 + 11, "cpu")
    b = datagen.Clustered(cfg, 2 ** 31 + 11, "cpu")
    c = datagen.Clustered(cfg, 2 ** 31 + 12, "cpu")
    span = a.rows("corpus", datagen.CHUNK - 5, 10)
    assert torch.equal(span, b.rows("corpus", datagen.CHUNK - 5, 10))
    assert torch.equal(span[:5], a.rows("corpus", datagen.CHUNK - 5, 5))
    assert not torch.equal(span, c.rows("corpus", datagen.CHUNK - 5, 10))
    assert not torch.equal(a.rows("corpus", 0, 10), a.rows("query", 0, 10))
    host = a.host_rows("query", 3, 7)
    assert np.array_equal(host, a.rows("query", 3, 7).numpy())


def test_build_scan_work_by_hand():
    # 5 rows of 2 values in waves of 2: prefixes of 0, 2 and 4 rows
    assert roofline.build_scan_work(5, 2, 2) == (
        5 * 4 * 2, (0 + 2 + 4) * 2 * 2 + 5 * 2 * 4)
    # the sift1m-m16 build: 1,954 waves of 512 rows
    flops, nbytes = roofline.build_scan_work(1_000_000, 128, 512)
    assert flops == 127_999_872_000_000
    assert nbytes == 250_607_992_832
    b = roofline.bound(flops, roofline.PEAK_BF16, nbytes)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(flops / 989e12 * 1e3)


def test_malformed_rows():
    row_of_id = np.array([0, 1, 2, -1, 4])
    ids = np.array([[0, 1], [1, 1], [3, 0], [0, 9], [2, 0], [0, 2]])
    d = np.array([[0.1, 0.2], [0.1, 0.2], [0.1, 0.2], [0.1, 0.2],
                  [0.3, 0.2], [0.1, np.nan]])
    assert checks.malformed_rows(ids, d, row_of_id).tolist() == [
        False, True, True, True, True, True]
    fi, fd = checks.fit(ids[:3], d[:3], 4, 3)
    assert fi.shape == (4, 3)
    assert (fi[3] == -1).all() and (fi[:, 2] == -1).all()
    assert np.isnan(fd[3]).all()

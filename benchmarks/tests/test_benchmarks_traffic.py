"""The open-loop schedule's size, rate and seeding, and the requests."""

import numpy as np

from benchmarks.drivers import serve


def test_schedule_count_span_and_rate():
    due = serve.schedule(5000.0, 4.0, 123)
    assert due.shape == (20000,)
    assert np.all(np.diff(due) >= 0) and 0 < due[0] and due[-1] < 4.0
    gaps = np.diff(due)
    assert abs(1 / gaps.mean() - 5000.0) / 5000.0 < 0.01
    # Exponential gaps: their spread equals their mean.
    assert abs(gaps.std() / gaps.mean() - 1.0) < 0.05


def test_schedule_seeding():
    a, b, c = (serve.schedule(1000.0, 2.0, s) for s in (7, 7, 8))
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert a.shape == c.shape


def test_requests_by_item_drawn_by_ratings():
    class Data:
        num_movies = 4
        movie_idx = np.array([0] * 60 + [1] * 30 + [2] * 10)   # item 3 has no ratings

    emb = np.random.default_rng(1).normal(size=(4, 8)).astype(np.float32)
    q, ex = serve.requests(Data, emb, 20000, np.random.default_rng(2))
    items = np.array([e[0] for e in ex])
    assert all(len(e) == 1 for e in ex) and np.array_equal(q, emb[items])
    share = np.bincount(items, minlength=4) / items.size
    assert np.allclose(share, [0.6, 0.3, 0.1, 0.0], atol=0.015)

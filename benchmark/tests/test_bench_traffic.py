"""The pool of frames that a mix cycles through, made from its seed."""

import numpy as np
import pytest

from benchmark import frames
from benchmark.run import ROOT

SEED = 2**31 + 12345          # seeds run past 32 signed bits


def test_same_seed_same_frames():
    fa = frames.make_pool(ROOT, SEED, 6, 64)
    fb = frames.make_pool(ROOT, SEED, 6, 64)
    assert fa.dtype == np.uint8 and fa.shape == (6, 64, 64, 3)
    assert np.array_equal(fa, fb)
    assert not np.array_equal(fa, frames.make_pool(ROOT, SEED + 1, 6, 64))


def test_letterbox_keeps_the_grey_border():
    pool = frames.make_pool(ROOT, 3, 10, 96, "letterbox")
    # photo 7 is 1280x720: a crop of it is wider than tall at most seeds,
    # and every frame has rows or columns of grey at an edge or none
    edges = np.concatenate([pool[:, 0].reshape(-1, 3),
                            pool[:, -1].reshape(-1, 3),
                            pool[:, :, 0].reshape(-1, 3),
                            pool[:, :, -1].reshape(-1, 3)])
    assert (edges == frames.PAD).all(1).any()


def test_feed_repeats_the_first_batch_at_the_end():
    from benchmark import loops
    pool = frames.make_pool(ROOT, SEED, 6, 16)
    ring = loops.feed(pool, 4, "pageable")
    assert ring.shape == (10, 16, 16, 3)
    assert np.array_equal(ring[6:], pool[:4])
    # pinned memory needs a card; without one the frames stay as they are
    assert np.array_equal(loops.feed(pool, 4, "pinned", on_card=False), ring)
    with pytest.raises(ValueError):
        loops.feed(pool, 4, "shared")

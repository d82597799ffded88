"""Rates over the whole window, the batches of the loop, and device
intervals."""

import pytest

from benchmark import loops, stats


def test_window_rate_is_completed_frames_over_window_seconds():
    win = loops.Window(seconds=30.0, completed_in_window=1_800_000)
    assert win.images_per_s == 60_000.0


def test_union_clip_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.union_length(iv) == pytest.approx(3 + 1 + 1)
    assert stats.clip(iv, 2.5, 8.5) == [(2.5, 3), (5, 6), (5.5, 5.7),
                                        (8, 8.5)]
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.union_length([]) == 0.0



def test_each_row_of_a_batch_meets_every_frame_of_the_pool():
    for b, p in ((256, 2048), (64, 512), (8, 16)):
        ids, slots = loops.cycle(b, p)
        assert len(ids) == b * p
        for row in (0, b - 1):
            assert sorted(ids[slots == row]) == list(range(p))

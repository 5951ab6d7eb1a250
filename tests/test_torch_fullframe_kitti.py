"""The port's frame path on a full-size KITTI frame against the reference
(tests/torch_full_frames.py)."""
import pytest

from torch_full_frames import KITTI_FRAME, check_full_size_frame, frame_id


@pytest.mark.parametrize("cfg,d_max,mismatches", [KITTI_FRAME], ids=frame_id)
def test_full_size_frame_against_reference(cfg, d_max, mismatches):
    check_full_size_frame(cfg, d_max, mismatches)

# SemanticKITTI test-submission config: inference over sequences 11-21 with
# placeholder labels, for the leaderboard .label dump.  Mirrors reference
# projects/configs/occformer_kitti/occformer_kitti_submit.py (split diff only).
# The PyTorch port's copy of occformer_tpu/configs/occformer_kitti_submit.py.
_base_ = ["./occformer_kitti.py"]

data = dict(
    test=dict(split="test-submit", test_mode=True),
)
evaluation = dict(interval=0)

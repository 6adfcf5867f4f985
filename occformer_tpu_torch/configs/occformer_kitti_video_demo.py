# SemanticKITTI video-demo config: iterate ALL camera frames (sweeps) of the
# val sequences instead of key frames only, for scene-video rendering with
# tools/visualize.py --video.  Mirrors reference occformer_kitti_video_demo.py
# (load_continuous=True diff).
# The PyTorch port's copy of occformer_tpu/configs/occformer_kitti_video_demo.py.
_base_ = ["./occformer_kitti.py"]

data = dict(
    test=dict(load_continuous=True, test_mode=True),
)
evaluation = dict(interval=0)

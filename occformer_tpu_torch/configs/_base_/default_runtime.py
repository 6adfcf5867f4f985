# Default runtime (reference projects/configs/_base_/default_runtime.py)
checkpoint_config = dict(interval=1, max_keep_ckpts=1)
log_config = dict(interval=50)
dist_params = dict(backend="nccl")
log_level = "INFO"
load_from = None
resume_from = None
workflow = [("train", 1)]
seed = 0

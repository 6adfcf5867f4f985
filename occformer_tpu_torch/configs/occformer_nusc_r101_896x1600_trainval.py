# R101-DCN high-res trained on train+val scenes, for the nuScenes test-server
# submission.  Mirrors reference occformer_nusc_r101_896x1600_trainval.py:
# trainval infos for training, test infos (test-submit placeholders) for
# inference, evaluation disabled (the test split has no labels).
# The PyTorch port's copy of
# occformer_tpu/configs/occformer_nusc_r101_896x1600_trainval.py.
_base_ = ["./occformer_nusc_r101_896x1600.py"]

data_config = {
    "cams": ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
             "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT"],
    "Ncams": 6,
    "input_size": (896, 1600),
    "src_size": (900, 1600),
    "resize": (-0.06, 0.11),
    "rot": (-5.4, 5.4),
    "flip": True,
    "crop_h": (0.0, 0.0),
    "resize_test": 0.00,
}
img_norm_cfg = dict(mean=[103.530, 116.280, 123.675], std=[1.0, 1.0, 1.0],
                    to_rgb=False)
point_cloud_range = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
occ_size = [256, 256, 32]
bda_aug_conf = dict(
    rot_lim=(0, 0),
    scale_lim=(0.95, 1.05),
    flip_dx_ratio=0.5,
    flip_dy_ratio=0.5,
    flip_dz_ratio=0.5,
)

# test split emits placeholder occupancy labels (is_test_submit=True,
# reference trainval config diff :244-246)
test_pipeline = [
    dict(type="LoadMultiViewImageFromFiles_OccFormer", is_train=False,
         data_config=data_config, img_norm_cfg=img_norm_cfg),
    dict(type="LoadNuscOccupancyAnnotations", is_test_submit=True,
         is_train=False, grid_size=occ_size,
         point_cloud_range=point_cloud_range, bda_aug_conf=bda_aug_conf),
]

data = dict(
    train=dict(ann_file="data/nuscenes_infos_temporal_trainval.pkl"),
    test=dict(ann_file="data/nuscenes_infos_temporal_test.pkl", test_mode=True,
              pipeline=test_pipeline),
)
evaluation = dict(interval=999)  # reference :319 — no eval during trainval runs

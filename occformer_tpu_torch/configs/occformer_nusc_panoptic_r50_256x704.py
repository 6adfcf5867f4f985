# Panoptic occupancy variant: Mask2FormerNuscPanopticOccHead with 150 queries
# and per-instance GT (class*1000 + instance).  Mirrors reference
# projects/configs/occformer_nusc/occformer_nusc_panoptic_r50_256x704.py.
# The PyTorch port's copy of occformer_tpu/configs/occformer_nusc_panoptic_r50_256x704.py:
# the model dict is identical; the port reads compute_dtype (from the base:
# float32 parameters, the forward under bf16 autocast) and ignores the head's
# feature_readout and point_chunks, which it always computes the same way.
_base_ = ["./occformer_nusc_r50_256x704.py"]

class_names = [
    "empty", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation",
]
stuff_classes = ["empty", "driveable_surface", "other_flat", "sidewalk",
                 "terrain", "manmade", "vegetation"]
thing_classes = ["barrier", "bicycle", "bus", "car", "construction_vehicle",
                 "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck"]
stuff_indices = [class_names.index(x) for x in stuff_classes]
thing_indices = [class_names.index(x) for x in thing_classes]

model = dict(
    # the reference config's (numerically identical, training-only): each
    # ResNet block recomputed in the backward
    img_backbone=dict(with_cp=True),
    pts_bbox_head=dict(
        type="Mask2FormerNuscPanopticOccHead",
        num_queries=150,
        stuff_indices=stuff_indices,
        thing_indices=thing_indices,
        feature_readout=True,
        point_chunks=8,
    ),
    # full reference density (reference config
    # occformer_nusc_panoptic_r50_256x704.py:202 num_points=12544*4, read by
    # the head at mask2former_nusc_panoptic_occ.py:132)
    train_cfg=dict(pts=dict(num_points=50176)),
)

# pipelines swap the semantic annotation loader for the panoptic one
# (lists override wholesale under _base_ merge)
point_cloud_range = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
occ_size = [256, 256, 32]
data_config = {
    "cams": ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
             "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT"],
    "Ncams": 6,
    "input_size": (256, 704),
    "src_size": (900, 1600),
    "resize": (-0.06, 0.11),
    "rot": (-5.4, 5.4),
    "flip": True,
    "crop_h": (0.0, 0.0),
    "resize_test": 0.00,
}
bda_aug_conf = dict(
    rot_lim=(0, 0), scale_lim=(0.95, 1.05),
    flip_dx_ratio=0.5, flip_dy_ratio=0.5, flip_dz_ratio=0.5,
)
img_norm_cfg = dict(
    mean=[123.675, 116.28, 103.53], std=[58.395, 57.12, 57.375], to_rgb=True
)
train_pipeline = [
    dict(type="LoadMultiViewImageFromFiles_OccFormer", is_train=True,
         data_config=data_config, img_norm_cfg=img_norm_cfg),
    dict(type="CreateDepthFromLiDAR", dataset="nusc"),
    dict(type="LoadNuscPanopticOccupancyAnnotations", is_train=True,
         grid_size=occ_size, point_cloud_range=point_cloud_range,
         bda_aug_conf=bda_aug_conf),
]
test_pipeline = [
    dict(type="LoadMultiViewImageFromFiles_OccFormer", is_train=False,
         data_config=data_config, img_norm_cfg=img_norm_cfg),
    dict(type="LoadNuscPanopticOccupancyAnnotations", is_train=False,
         grid_size=occ_size, point_cloud_range=point_cloud_range,
         bda_aug_conf=bda_aug_conf),
]
data = dict(
    train=dict(pipeline=train_pipeline),
    val=dict(pipeline=test_pipeline),
    test=dict(pipeline=test_pipeline),
)

# reference panoptic recipe: very tight grad clip, eval disabled during
# training (occformer_nusc_panoptic_r50_256x704.py:310,322)
optimizer_config = dict(grad_clip=dict(max_norm=0.01, norm_type=2))
evaluation = dict(interval=999, save_best="nuScenes_panoptic_PQ", rule="greater")

# OccFormer nuScenes R101-DCN 6x896x1600 — high-res variant (bf16 training).
# Mirrors the reference r101 config diff: deeper backbone with DCNv2 in stages
# 3-4, larger input, mixed precision.
# The PyTorch port's copy of occformer_tpu/configs/occformer_nusc_r101_896x1600.py:
# the model dict is identical; the port reads compute_dtype (float32 parameters,
# the forward under bf16 autocast) and ignores fp16, query_chunks and the mesh.
_base_ = ["./occformer_nusc_r50_256x704.py"]

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

# FCOS3D-pretrained caffe-style R101: BGR mean-only normalization
# (reference r101 config diff: img_norm_cfg, load_from, frozen stem+BN)
img_norm_cfg = dict(mean=[103.530, 116.280, 123.675], std=[1.0, 1.0, 1.0],
                    to_rgb=False)

model = dict(
    img_backbone=dict(
        _delete_=True,
        type="ResNet",
        depth=101,
        num_stages=4,
        out_indices=(0, 1, 2, 3),
        frozen_stages=1,
        norm_cfg=dict(type="BN2d", requires_grad=False),
        norm_eval=True,
        style="caffe",
        with_cp=True,
        dcn=dict(type="DCNv2", deform_groups=1, fallback_on_stride=False),
        stage_with_dcn=(False, False, True, True),
    ),
    img_view_transformer=dict(data_config=data_config),
    # the JAX package's TPU memory lever (numerically identical); the port
    # ignores it
    img_bev_encoder_neck=dict(query_chunks=8),
)

load_from = "ckpts/r101_dcn_fcos3d_pretrain.pth"
# the reference's fp16 training; under bf16 autocast with float32 parameters
# (compute_dtype) the port needs no loss scaler: bf16 has float32's exponent
# range, and the parameters and their gradients stay float32
fp16 = dict(loss_scale="dynamic")
compute_dtype = "bfloat16"

# pipelines re-declared: the base's lists captured its 256x704 data_config and
# torchvision img_norm_cfg at definition time (lists override wholesale)
point_cloud_range = [-51.2, -51.2, -5.0, 51.2, 51.2, 3.0]
occ_size = [256, 256, 32]
bda_aug_conf = dict(
    rot_lim=(0, 0),
    scale_lim=(0.95, 1.05),
    flip_dx_ratio=0.5,
    flip_dy_ratio=0.5,
    flip_dz_ratio=0.5,
)
train_pipeline = [
    dict(type="LoadMultiViewImageFromFiles_OccFormer", is_train=True,
         data_config=data_config, img_norm_cfg=img_norm_cfg),
    dict(type="CreateDepthFromLiDAR", dataset="nusc"),
    dict(type="LoadNuscOccupancyAnnotations", is_train=True, grid_size=occ_size,
         point_cloud_range=point_cloud_range, bda_aug_conf=bda_aug_conf),
]
test_pipeline = [
    dict(type="LoadMultiViewImageFromFiles_OccFormer", is_train=False,
         data_config=data_config, img_norm_cfg=img_norm_cfg),
    dict(type="LoadNuscOccupancyAnnotations", is_train=False, grid_size=occ_size,
         point_cloud_range=point_cloud_range, bda_aug_conf=bda_aug_conf),
]
data = dict(
    train=dict(pipeline=train_pipeline),
    val=dict(pipeline=test_pipeline),
    test=dict(pipeline=test_pipeline),
)

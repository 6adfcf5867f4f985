# Tiny synthetic-data config: CLI integration tests + loop benchmarks.
# The port's copy of occformer_tpu/configs/synthetic_tiny.py.
_base_ = ["./_base_/default_runtime.py"]

num_class = 5
class_names = [f"class_{i}" for i in range(num_class)]
point_cloud_range = [-8.0, -8.0, -2.0, 8.0, 8.0, 2.0]
occ_size = [32, 32, 16]

data_config = {"input_size": (32, 64), "Ncams": 2}
grid_config = {
    "xbound": [-8.0, 8.0, 1.0],
    "ybound": [-8.0, 8.0, 1.0],
    "zbound": [-2.0, 2.0, 0.5],
    "dbound": [1.0, 9.0, 1.0],
}

numC_Trans = 32
voxel_channels = [32, 32, 64, 64]
voxel_out_channels = 48
norm_cfg = dict(type="GN", num_groups=8)

model = dict(
    type="OccupancyFormer",
    img_backbone=dict(type="ResNet", depth=18, out_indices=(0, 1, 2, 3)),
    img_neck=dict(
        type="SECONDFPN",
        in_channels=[64, 128, 256, 512],
        upsample_strides=[0.5, 1, 2, 4],
        out_channels=[16, 16, 16, 16],
    ),
    img_view_transformer=dict(
        type="ViewTransformerLiftSplatShootVoxel",
        loss_depth_weight=1.0,
        grid_config=grid_config,
        data_config=data_config,
        numC_input=64,
        numC_Trans=numC_Trans,
        downsample=8,
        point_cloud_range=point_cloud_range,
    ),
    img_bev_encoder_backbone=dict(
        type="OccupancyEncoder",
        num_stage=4,
        in_channels=numC_Trans,
        block_numbers=[1, 1, 1, 1],
        block_inplanes=voxel_channels,
        block_strides=[1, 2, 2, 2],
        out_indices=(0, 1, 2, 3),
        norm_cfg=norm_cfg,
        with_cp=False,
    ),
    img_bev_encoder_neck=dict(
        type="MSDeformAttnPixelDecoder3D",
        strides=[2, 4, 8, 16],
        in_channels=voxel_channels,
        feat_channels=voxel_out_channels,
        out_channels=voxel_out_channels,
        norm_cfg=norm_cfg,
        encoder=dict(
            num_layers=1,
            transformerlayers=dict(
                attn_cfgs=dict(num_heads=4, num_levels=3, num_points=2),
                feedforward_channels=voxel_out_channels * 2,
            ),
        ),
        positional_encoding=dict(num_feats=voxel_out_channels // 3),
    ),
    pts_bbox_head=dict(
        type="Mask2FormerNuscOccHead",
        feat_channels=voxel_out_channels,
        out_channels=voxel_out_channels,
        num_queries=8,
        num_occupancy_classes=num_class,
        point_cloud_range=point_cloud_range,
        transformer_decoder=dict(
            num_layers=3,
            transformerlayers=dict(
                attn_cfgs=dict(num_heads=4),
                feedforward_channels=voxel_out_channels * 2,
            ),
        ),
        positional_encoding=dict(num_feats=voxel_out_channels // 3),
        loss_cls=dict(class_weight=[1.0] * num_class + [0.1], loss_weight=2.0),
        loss_mask=dict(loss_weight=5.0),
        loss_dice=dict(loss_weight=5.0, eps=1.0),
    ),
    train_cfg=dict(pts=dict(num_points=64, oversample_ratio=2.0,
                            importance_sample_ratio=0.75)),
)

data = dict(
    samples_per_gpu=1,
    train=dict(type="SyntheticOccDataset", num_samples=16, num_cams=2,
               input_size=data_config["input_size"], occ_size=occ_size,
               num_classes=num_class, pc_range=point_cloud_range),
)
data["val"] = dict(data["train"])
data["test"] = dict(data["train"])

optimizer = dict(type="AdamW", lr=1e-4, weight_decay=0.01)
optimizer_config = dict(grad_clip=dict(max_norm=5))
lr_config = dict(policy="step", step=[20, 23])
runner = dict(type="EpochBasedRunner", max_epochs=1)
log_config = dict(interval=1)
max_lidar_points = 512
compute_dtype = "float32"

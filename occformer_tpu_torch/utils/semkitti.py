"""SemanticKITTI class statistics (dataset constants).

The port's copy of ``occformer_tpu/utils/semkitti.py``: voxel counts per
class over the training split, for the 1/log(freq) loss weights and the
frequency-weighted point sampling (reference utils/semkitti.py:3-26,
mask2former_occ.py:133-166).
"""
import numpy as np

semantic_kitti_class_frequencies = np.array(
    [
        5.41773033e09, 1.57835390e07, 1.25136000e05, 1.18809000e05,
        6.46799000e05, 8.21951000e05, 2.62978000e05, 2.83696000e05,
        2.04750000e05, 6.16887030e07, 4.50296100e06, 4.48836500e07,
        2.26992300e06, 5.68402180e07, 1.57196520e07, 1.58442623e08,
        2.06162300e06, 3.69705220e07, 1.15198800e06, 3.34146000e05,
    ]
)

kitti_class_names = [
    "empty", "car", "bicycle", "motorcycle", "truck", "other-vehicle",
    "person", "bicyclist", "motorcyclist", "road", "parking", "sidewalk",
    "other-ground", "building", "fence", "vegetation", "trunk", "terrain",
    "pole", "traffic-sign",
]


def kitti_class_weights(background_weight: float = 0.1) -> np.ndarray:
    """1/log(freq) class weights normalized by class 0, and the background
    slot's weight last (reference mask2former_occ.py:133-142)."""
    w = 1.0 / np.log(semantic_kitti_class_frequencies)
    w = w / w[0]
    return np.concatenate([w, [background_weight]]).astype(np.float32)


def kitti_sample_weights() -> np.ndarray:
    """Per-class sampling weights 1/freq normalized by their minimum
    (reference mask2former_occ.py:144-150); the loss raises them to the
    power ``sample_weight_gamma``."""
    w = 1.0 / semantic_kitti_class_frequencies
    return (w / w.min()).astype(np.float32)

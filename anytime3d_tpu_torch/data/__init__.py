"""Host data: the procedural, ModelNet, Pascal3D, KITTI and ImageNet
loaders, image reading and augmentation, bit-packed voxel transfer and
the batch prefetcher."""

from anytime3d_tpu_torch.data.augment import (
    image_random_augmentation,
    photometric_augment,
    random_flip_horizontal,
    remap_bbox,
)
from anytime3d_tpu_torch.data.imagenet import ImagenetLoader
from anytime3d_tpu_torch.data.imread import imread_color
from anytime3d_tpu_torch.data.kitti import KittiSingleObjectLoader
from anytime3d_tpu_torch.data.modelnet import (
    ModelNetLoader,
    SyntheticImageObjectLoader,
    SyntheticMultiObjectLoader,
    SyntheticVoxelLoader,
)
from anytime3d_tpu_torch.data.pascal3d import Pascal3DMultiObjectLoader, Pascal3DSingleObjectLoader
from anytime3d_tpu_torch.data.prefetch import DevicePrefetcher
from anytime3d_tpu_torch.data.voxel import binarize, convert_axis_32to64, zoom_nearest

__all__ = [
    "binarize",
    "zoom_nearest",
    "convert_axis_32to64",
    "ModelNetLoader",
    "SyntheticVoxelLoader",
    "SyntheticImageObjectLoader",
    "SyntheticMultiObjectLoader",
    "imread_color",
    "image_random_augmentation",
    "photometric_augment",
    "remap_bbox",
    "random_flip_horizontal",
    "Pascal3DSingleObjectLoader",
    "Pascal3DMultiObjectLoader",
    "KittiSingleObjectLoader",
    "ImagenetLoader",
    "DevicePrefetcher",
]

"""Dataset parsers of the keypoint and KG experiments (host NumPy /
SciPy; the VGG16 feature extractor runs on the device). Nothing here
downloads: each parser reads the published raw layout from a root
directory."""

from dgmc_tpu_torch.datasets.convert_vgg import convert_checkpoint
from dgmc_tpu_torch.datasets.dbp15k import DBP15K
from dgmc_tpu_torch.datasets.features import VGG16Features
from dgmc_tpu_torch.datasets.pascal_pf import PascalPF
from dgmc_tpu_torch.datasets.pascal_voc import PascalVOCKeypoints
from dgmc_tpu_torch.datasets.willow import WILLOWObjectClass

__all__ = ['convert_checkpoint', 'DBP15K', 'PascalPF', 'WILLOWObjectClass',
           'PascalVOCKeypoints', 'VGG16Features']

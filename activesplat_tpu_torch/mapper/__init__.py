"""Online SplaTAM-style mapper (GT poses, per-frame optimization).

State machine and enums mirror the reference (src/mapper/__init__.py:119-132)
and activesplat_tpu/mapper/__init__.py.
"""

from enum import Enum


class MapperState(Enum):
    BOOTSTRAP = 0
    INITIALIZING = 1
    MAPPING = 2
    IDLE = 3


class GaussianColorType(Enum):
    Color = "Color"
    Depth = "Depth"
    Opacity = "Opacity"
    RGBD = "RGBD"


class MapperType(Enum):
    SplaTAM = "SplaTAM"


def get_mapper(mapper_type: MapperType):
    if mapper_type == MapperType.SplaTAM:
        from activesplat_tpu_torch.mapper.splatam import SplaTAMMapper

        return SplaTAMMapper
    raise ValueError(f"Unsupported mapper type: {mapper_type}")

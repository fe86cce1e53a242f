from .base import (  # noqa: F401
    ALL_SHAPES,
    SHAPES,
    ArchConfig,
    ShapeSpec,
    shape_applicable,
)
from .registry import ALIASES, ARCHS, get_arch, get_shape, grid  # noqa: F401

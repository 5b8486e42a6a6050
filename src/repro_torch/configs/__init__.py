from .base import SHAPES, ModelConfig, ShapeSpec, shape_applicable  # noqa: F401
from .registry import ARCH_IDS, ARCHS, get_config  # noqa: F401

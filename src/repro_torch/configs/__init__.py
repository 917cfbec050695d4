from .base import SHAPES, InputShape, get_config, list_archs, smoke_config  # noqa: F401

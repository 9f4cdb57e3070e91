"""Architecture configs of the port, at their published ``full`` widths
and their ``smoke`` presets (see ``configs.base``), for every
architecture of ``ARCH_IDS``."""
from .base import (ARCH_IDS, SHAPES, SWA_WINDOW, InputShape, get_config,
                   supported_shapes)

__all__ = ["ARCH_IDS", "SHAPES", "SWA_WINDOW", "InputShape", "get_config",
           "supported_shapes"]

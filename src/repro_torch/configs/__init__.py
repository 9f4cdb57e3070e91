"""Architecture configs of the port, at their published ``full`` widths
and their ``smoke`` presets (see ``configs.base``); ``get_config`` serves
those the ported model code runs (``ported_archs``)."""
from .base import (ARCH_IDS, SHAPES, SWA_WINDOW, InputShape, get_config,
                   ported_archs, supported_shapes)

__all__ = ["ARCH_IDS", "SHAPES", "SWA_WINDOW", "InputShape", "get_config",
           "ported_archs", "supported_shapes"]

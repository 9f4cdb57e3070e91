from .ssd import (SSDConfig, decode_detections, init_ssd, make_anchors,
                  params_from_numpy, params_to, ssd_candidates,
                  ssd_forward)

__all__ = ["SSDConfig", "decode_detections", "init_ssd", "make_anchors",
           "params_from_numpy", "params_to", "ssd_candidates", "ssd_forward"]

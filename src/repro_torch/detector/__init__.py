from .ssd import (SSDConfig, decode_detections, detector_loss, init_ssd,
                  make_anchors, params_from_numpy, params_to,
                  params_to_numpy, ssd_candidates, ssd_forward)

__all__ = ["SSDConfig", "decode_detections", "detector_loss", "init_ssd",
           "make_anchors", "params_from_numpy", "params_to",
           "params_to_numpy", "ssd_candidates", "ssd_forward"]

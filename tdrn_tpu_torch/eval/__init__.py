"""Evaluation: the VOC/VID mAP protocol and the detection-collection runners
(the port of ``tdrn_tpu/eval``)."""

from tdrn_tpu_torch.eval.voc_eval import (  # noqa: F401
    eval_class,
    evaluate_detections,
    voc_ap,
    write_voc_results_files,
)

"""Sigmoid focal loss, the RetinaNet / EfficientDet head loss (counterpart
of ``apex_tpu.contrib.focal_loss.focal_loss``).

- ``cls_output [..., C_padded]`` raw logits; only the first
  ``num_real_classes`` columns carry loss and gradient;
- ``cls_targets_at_level [...]`` int class ids; a negative (or
  out-of-range) id means no positive class: every class is a negative;
- label smoothing re-targets ``y' = (1 - s) onehot + s / C``;
- the summed loss is divided by ``num_positives_sum``.

Per element ``y' alpha (1 - p)^g (-log p) + (1 - y') (1 - alpha) p^g
(-log(1 - p))``, the logs as softplus of the logits.  Autograd through
the plain ops gives the gradient, as JAX's AD does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["FocalLoss", "focal_loss"]


def focal_loss(cls_output, cls_targets_at_level, num_positives_sum,
               num_real_classes, alpha, gamma, label_smoothing=0.0):
    """Summed sigmoid focal loss divided by ``num_positives_sum``."""
    x = cls_output[..., :num_real_classes].float()
    targets = cls_targets_at_level.to(torch.int64)
    classes = torch.arange(num_real_classes, device=x.device)
    # one_hot that leaves a row of zeros for negative / out-of-range ids
    onehot = (targets[..., None] == classes).float()
    y = ((1.0 - label_smoothing) * onehot + label_smoothing / num_real_classes
         if label_smoothing else onehot)

    # stable -log(sigmoid(x)) and -log(1 - sigmoid(x))
    neg_log_p = F.softplus(-x)
    neg_log_1p = F.softplus(x)
    p = torch.sigmoid(x)

    per_elem = (y * alpha * torch.pow(1.0 - p, gamma) * neg_log_p
                + (1.0 - y) * (1.0 - alpha) * torch.pow(p, gamma) * neg_log_1p)
    return per_elem.sum() / torch.as_tensor(num_positives_sum,
                                            dtype=torch.float32,
                                            device=x.device)


class FocalLoss:
    """Function-object form matching the reference's ``.apply`` call
    style."""

    @staticmethod
    def apply(cls_output, cls_targets_at_level, num_positives_sum,
              num_real_classes, alpha, gamma, label_smoothing=0.0):
        """Sigmoid focal loss summed over a detection level, divided by
        ``num_positives_sum``."""
        return focal_loss(cls_output, cls_targets_at_level, num_positives_sum,
                          num_real_classes, alpha, gamma, label_smoothing)

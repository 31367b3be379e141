"""Sigmoid focal loss (counterpart of ``apex_tpu.contrib.focal_loss``)."""

from apex_tpu_torch.contrib.focal_loss.focal_loss import FocalLoss, focal_loss

__all__ = ["FocalLoss", "focal_loss"]

"""Segmentation metrics from an on-device confusion matrix.

Counterpart of ``unet_tpu/train/metrics.py``: the batch update is one
``bincount(num_classes * target + pred)`` on the device, and only the
(C, C) matrix reaches the host. ``compute()`` gives the reference's
numbers, including its rule that mean IoU and mean Dice average only
the classes whose value is above 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def confusion_matrix_update(predictions: torch.Tensor, targets: torch.Tensor,
                            num_classes: int,
                            ignore_index: Optional[int] = None
                            ) -> torch.Tensor:
    """Batch confusion-matrix increment on the tensors' device.

    predictions: logits (N, C, H, W) or class indices (N, H, W);
    targets: class indices (N, H, W). Returns an int64 (C, C) matrix
    whose [t, p] counts pixels of true class t predicted as p.
    Out-of-range labels and predictions are dropped."""
    if predictions.dim() == 4:
        predictions = torch.argmax(predictions, dim=1)
    t = targets.reshape(-1).long()
    p = predictions.reshape(-1).long()
    valid = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    if ignore_index is not None:
        valid &= t != ignore_index
    cc = num_classes * num_classes
    idx = torch.where(valid, t * num_classes + p, torch.full_like(t, cc))
    counts = torch.bincount(idx, minlength=cc + 1)
    return counts[:cc].reshape(num_classes, num_classes)


def metrics_from_confusion(cm) -> Dict[str, float]:
    """Pixel accuracy, per-class and mean IoU and Dice from a confusion
    matrix, with class names ``class_<i>``."""
    cm = np.asarray(cm)
    return SegmentationMetrics._compute_from(
        cm, [f'class_{i}' for i in range(cm.shape[0])])


class SegmentationMetrics:
    """Accumulator with the reference's API (update / update_from_matrix
    / compute / reset / get_confusion_matrix). Device matrices are summed
    on the host only when ``compute`` or ``get_confusion_matrix`` asks."""

    def __init__(self, num_classes: int = 2,
                 class_names: Optional[List[str]] = None,
                 ignore_index: Optional[int] = None):
        self.num_classes = num_classes
        self.class_names = class_names or [f'class_{i}'
                                           for i in range(num_classes)]
        self.ignore_index = ignore_index
        self.reset()

    def reset(self) -> None:
        self._cm = np.zeros((self.num_classes, self.num_classes), np.int64)
        self._pending = []

    def update(self, predictions: torch.Tensor,
               targets: torch.Tensor) -> None:
        self._pending.append(confusion_matrix_update(
            predictions, targets, self.num_classes, self.ignore_index))

    def update_from_matrix(self, cm) -> None:
        self._pending.append(cm)

    def _drain(self) -> None:
        for cm in self._pending:
            if torch.is_tensor(cm):
                cm = cm.cpu().numpy()
            self._cm += np.asarray(cm, dtype=np.int64)
        self._pending = []

    def compute(self) -> Dict[str, float]:
        self._drain()
        return self._compute_from(self._cm, self.class_names)

    @staticmethod
    def _compute_from(cm: np.ndarray, class_names: List[str]
                      ) -> Dict[str, float]:
        num_classes = cm.shape[0]
        total = cm.sum()
        if total == 0:
            zero = {name: 0.0 for name in class_names}
            return {'pixel_accuracy': 0.0, 'mean_iou': 0.0, 'mean_dice': 0.0,
                    'class_iou': dict(zero), 'class_dice': dict(zero)}
        pixel_accuracy = np.diag(cm).sum() / total
        class_iou, class_dice = {}, {}
        for i in range(num_classes):
            tp = cm[i, i]
            fp = cm[:, i].sum() - tp
            fn = cm[i, :].sum() - tp
            iou_d = tp + fp + fn
            dice_d = 2 * tp + fp + fn
            class_iou[class_names[i]] = float(tp / iou_d) if iou_d > 0 else 0.0
            class_dice[class_names[i]] = (float(2 * tp / dice_d)
                                          if dice_d > 0 else 0.0)
        valid_ious = [v for v in class_iou.values() if v > 0]
        valid_dices = [v for v in class_dice.values() if v > 0]
        return {
            'pixel_accuracy': float(pixel_accuracy),
            'mean_iou': float(np.mean(valid_ious)) if valid_ious else 0.0,
            'mean_dice': float(np.mean(valid_dices)) if valid_dices else 0.0,
            'class_iou': class_iou,
            'class_dice': class_dice,
        }

    def get_confusion_matrix(self) -> np.ndarray:
        self._drain()
        return self._cm.copy()

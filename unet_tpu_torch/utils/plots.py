"""Plotting: training curves, prediction grids, confusion matrix,
overlays.

Counterpart of ``unet_tpu/utils/plots.py`` with the same artifacts
(two-panel curves PNG, N x 3 prediction grid, normalized confusion
heatmap, red-truth / green-prediction overlay), for NCHW tensors or
numpy arrays. Denormalization assumes mean = std = 0.5. matplotlib is
imported at first use; ``have_matplotlib()`` tells the CLIs whether to
draw, so a machine without it skips the plots with one line.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

SKIP_MESSAGE = 'plots skipped: matplotlib is not installed'


def have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def _plt():
    if not have_matplotlib():
        raise ImportError('matplotlib is required for plotting')
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _numpy(a) -> np.ndarray:
    if hasattr(a, 'detach'):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def _finish(plt, fig, save_path, dpi):
    fig.tight_layout()
    if save_path:
        Path(save_path).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(save_path, dpi=dpi)
        plt.close(fig)
        return None
    return fig


def plot_training_curves(history: Dict[str, List[float]], save_path=None,
                         dpi: int = 150):
    """Two panels: train/val loss, and validation Dice and IoU."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    epochs = range(1, len(history.get('train_loss', [])) + 1)
    ax = axes[0]
    if 'train_loss' in history:
        ax.plot(epochs, history['train_loss'], label='train')
    if 'val_loss' in history:
        ax.plot(epochs, history['val_loss'], label='val')
    ax.set_xlabel('epoch')
    ax.set_ylabel('loss')
    ax.set_title('Loss')
    ax.legend()
    ax.grid(alpha=0.3)

    ax = axes[1]
    for key, label in (('val_dice', 'mean dice'), ('tumor_dice',
                                                   'tumor dice'),
                       ('val_iou', 'mean IoU')):
        if key in history and history[key]:
            ax.plot(epochs, history[key], label=label)
    ax.set_xlabel('epoch')
    ax.set_ylabel('metric')
    ax.set_title('Validation metrics')
    ax.legend()
    ax.grid(alpha=0.3)
    return _finish(plt, fig, save_path, dpi)


def _denorm(img: np.ndarray, mean: float = 0.5, std: float = 0.5):
    return np.clip(img * std + mean, 0.0, 1.0)


def plot_predictions(images, masks, predictions, num_samples: int = 4,
                     save_path=None, class_names: Optional[List[str]] = None,
                     dpi: int = 150):
    """N x 3 grid: input | ground truth | prediction. images (N, C, H, W)
    normalized; masks (N, H, W); predictions logits (N, K, H, W) or
    class maps (N, H, W)."""
    plt = _plt()
    images, masks = _numpy(images), _numpy(masks)
    predictions = _numpy(predictions)
    if predictions.ndim == 4:
        predictions = predictions.argmax(1)
    n = min(num_samples, images.shape[0])
    fig, axes = plt.subplots(n, 3, figsize=(9, 3 * n))
    if n == 1:
        axes = axes[None, :]
    vmax = max(1, masks.max())
    for i in range(n):
        axes[i, 0].imshow(_denorm(images[i, 0]), cmap='gray')
        axes[i, 0].set_title('input' if i == 0 else '')
        axes[i, 1].imshow(masks[i], cmap='viridis', vmin=0, vmax=vmax)
        axes[i, 1].set_title('ground truth' if i == 0 else '')
        axes[i, 2].imshow(predictions[i], cmap='viridis', vmin=0, vmax=vmax)
        axes[i, 2].set_title('prediction' if i == 0 else '')
        for j in range(3):
            axes[i, j].axis('off')
    return _finish(plt, fig, save_path, dpi)


def plot_confusion_matrix(cm, class_names: Optional[List[str]] = None,
                          save_path=None, normalize: bool = True,
                          dpi: int = 150):
    """Row-normalized confusion heatmap with annotations."""
    plt = _plt()
    cm = np.asarray(_numpy(cm), np.float64)
    if normalize:
        row = cm.sum(axis=1, keepdims=True)
        cm = np.divide(cm, row, out=np.zeros_like(cm), where=row > 0)
    n = cm.shape[0]
    class_names = class_names or [f'class_{i}' for i in range(n)]
    fig, ax = plt.subplots(figsize=(4 + n, 3 + n))
    im = ax.imshow(cm, cmap='Blues', vmin=0, vmax=1 if normalize else None)
    fig.colorbar(im, ax=ax)
    ax.set_xticks(range(n), class_names, rotation=45)
    ax.set_yticks(range(n), class_names)
    ax.set_xlabel('predicted')
    ax.set_ylabel('true')
    for i in range(n):
        for j in range(n):
            ax.text(j, i,
                    f'{cm[i, j]:.2f}' if normalize else f'{int(cm[i, j])}',
                    ha='center', va='center',
                    color='white' if cm[i, j] > 0.5 * (cm.max() or 1)
                    else 'black')
    return _finish(plt, fig, save_path, dpi)


def plot_sample_with_overlay(image, mask, prediction, save_path=None,
                             alpha: float = 0.4, dpi: int = 150):
    """Red truth / green prediction overlays. image (H, W) or (C, H, W)
    normalized; mask and prediction (H, W)."""
    plt = _plt()
    image = _numpy(image)
    if image.ndim == 3:
        image = image[0]
    base = _denorm(image)
    rgb_gt = np.stack([base] * 3, -1)
    rgb_pr = rgb_gt.copy()
    gt = _numpy(mask) > 0
    pr = _numpy(prediction) > 0
    rgb_gt[gt] = (1 - alpha) * rgb_gt[gt] + alpha * np.array([1.0, 0, 0])
    rgb_pr[pr] = (1 - alpha) * rgb_pr[pr] + alpha * np.array([0, 1.0, 0])
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, (img, title) in zip(axes, [(base, 'input'),
                                       (rgb_gt, 'GT (red)'),
                                       (rgb_pr, 'prediction (green)')]):
        ax.imshow(img, cmap='gray' if img.ndim == 2 else None)
        ax.set_title(title)
        ax.axis('off')
    return _finish(plt, fig, save_path, dpi)

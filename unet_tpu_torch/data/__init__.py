"""Host-side data: the dataset and batch loader, on-device augmentation,
and the native request decode."""

"""Host-side data helpers (native request decode; the dataset and
augmentation pipeline join in later slices)."""

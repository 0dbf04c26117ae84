"""Command-line entry points (serve; the others join in later slices)."""

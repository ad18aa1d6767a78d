"""Per-task losses and the weighted multi-task sum."""

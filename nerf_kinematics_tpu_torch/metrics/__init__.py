"""Image metrics."""

"""Ray generation."""

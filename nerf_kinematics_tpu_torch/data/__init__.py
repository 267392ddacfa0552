"""Dataset containers and pose synthesis."""

"""Full-image renderers of the port."""

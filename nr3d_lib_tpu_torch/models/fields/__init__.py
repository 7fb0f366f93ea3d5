"""Field nets of the port."""

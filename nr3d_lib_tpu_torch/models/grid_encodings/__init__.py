"""Grid encodings of the port."""

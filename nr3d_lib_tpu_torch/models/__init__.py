"""Models of the port: fields, encodings, space, acceleration."""

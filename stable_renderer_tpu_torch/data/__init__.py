"""Frame-buffer and frame-pack data types."""

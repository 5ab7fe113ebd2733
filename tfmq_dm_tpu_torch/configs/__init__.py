"""Task configurations of the port."""

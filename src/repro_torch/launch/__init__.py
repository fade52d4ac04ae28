"""Launch drivers of the port (`serve`)."""

"""Data sources and the loader of the port."""

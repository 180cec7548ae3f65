"""Scripts that measure the port on a CUDA card (run by path, see each)."""

"""Split-KV paged decode read: ``ref`` (plain torch) and ``ops`` (CUDA
wrappers of the split and combine kernels)."""

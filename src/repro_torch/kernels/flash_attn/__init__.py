"""Flash attention: ``ref`` (plain torch: the full-sequence oracle and the
split-KV paged decode read) and ``ops`` (the ``FlashAttention`` op and the
CUDA wrappers of the flash, split and combine kernels)."""

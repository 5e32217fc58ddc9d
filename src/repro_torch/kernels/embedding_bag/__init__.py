"""EmbeddingBag: the CUDA kernel (``embedding_bag``), the public wrapper
with sum/mean modes (``ops``) and the plain torch versions (``ref``)."""

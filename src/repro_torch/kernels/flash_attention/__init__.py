"""Blocked (flash) attention: the CUDA kernel (``flash_attention``), the
(B, S, H, d) wrapper (``ops``) and the plain torch versions (``ref``)."""

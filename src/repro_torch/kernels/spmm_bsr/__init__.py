"""Block-sparse SpMM: the CUDA kernel and the host-side ``to_bsr``
(``spmm_bsr``), the ``BsrMatrix`` wrapper (``ops``) and the plain torch
versions (``ref``)."""

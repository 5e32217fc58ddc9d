"""PageRank by residual push for ``args["rounds"]`` rounds (``damping``,
``tol``), normalised, held to the float64 reference by the largest
relative gap of a vertex's rank."""

import torch

from gbharness import check, reference

CHECK = "ranks_max_rel_err"
fold = max
compare = check.max_rel_err


def reference_answer(csr, source, args, dtype=None):
    return reference.pagerank_push(csr, args["rounds"], args["damping"], args["tol"],
                                   dtype=torch.float64 if dtype is None else dtype)


def least_bytes(csr, ref):
    return None

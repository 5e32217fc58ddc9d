"""BFS levels: unit-weight shortest distances from the trial's source,
held exactly to the plain reference's (the count of vertices whose reached
state or level differs)."""

import operator

import torch

from gbharness import check, reference, roofline

CHECK = "levels_mismatched"
fold = operator.add
compare = check.mismatched


def reference_answer(csr, source, args, dtype=None):
    return reference.distances(csr, source, weighted=False,
                               dtype=torch.float32 if dtype is None else dtype)


def least_bytes(csr, ref):
    return roofline.bfs_bytes(int(torch.isfinite(ref).sum()))

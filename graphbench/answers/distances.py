"""SSSP distances over the cell's float32 weights from the trial's source,
held exactly to the plain reference's (the count of vertices whose reached
state or distance differs)."""

import operator

import torch

from gbharness import check, reference, roofline

CHECK = "distances_mismatched"
fold = operator.add
compare = check.mismatched


def reference_answer(csr, source, args, dtype=None):
    return reference.distances(csr, source, weighted=True,
                               dtype=torch.float32 if dtype is None else dtype)


def least_bytes(csr, ref):
    hit = torch.isfinite(ref)
    return roofline.sssp_bytes(int(hit.sum()), int(csr.out_deg[hit].sum()))

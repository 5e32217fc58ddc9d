"""The port's sharded path against the JAX package's on the full-mesh and
2-D cells: ``reducer="full"`` at ndev 1 and 8, CVC grids (2, 2) and
(2, 4) (the cvc2d reducer's column reduce and row gather), as
``test_torch_sharded.py`` holds the 1-D cells (its module docstring says
what is held)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_torch_sharded import (CELLS, GRID_CELLS, REDUCE_CASES, check_cell,  # noqa: E402
                                check_reducer, port_det, port_graphs, ref_stats,
                                run_reference, shard_cell, spec)

__all__ = ["port_det", "port_graphs"]   # module-scoped fixtures of this module


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("sharded_grid"), spec(GRID_CELLS, ["cells"]))


@pytest.mark.parametrize("substrate", ["torch", "cuda"])
@pytest.mark.parametrize("cell", GRID_CELLS)
def test_cell_matches_reference(ref, port_graphs, port_det, cell, substrate):
    check_cell(ref, port_graphs, port_det, cell, substrate)


@pytest.mark.parametrize("case", REDUCE_CASES, ids=lambda c: "-".join(c))
@pytest.mark.parametrize("cell", ["full8", "cvc24"])
def test_reducer_matches_reference(ref, port_graphs, cell, case):
    check_reducer(ref, port_graphs, cell, case)


def test_bc_on_a_grid_charges_reversed_sweeps_full_mesh(ref, port_graphs):
    """bc's backward sweep scatters along reversed edges: on a 2-D cut it
    runs (and is charged) at the full-mesh rate."""
    g, _, source = port_graphs
    sg = shard_cell(g, CELLS["cvc22"])
    e_fwd, e_rev = sg.comm_per_relax()[0], sg.comm_per_relax(reverse=True)[0]
    assert e_rev > e_fwd
    st = ref_stats(ref, "cvc22/bc")
    fwd = st["rounds"] // 2
    assert st["comm_elems"] == 2 * fwd * e_fwd + fwd * e_rev

"""Graph500's Kronecker graph (``gbharness.gen.kron``) from a
configuration's ``scale``, ``edge_factor``, ``a``, ``b``, ``c`` and
``permute_labels``."""

from gbharness import gen


def make(config, g, device):
    return gen.kron(config["scale"], config["edge_factor"], config["a"], config["b"],
                    config["c"], config["permute_labels"], g, device)

"""Chained RMAT communities (``gbharness.gen.crawl``) from a
configuration's ``n_communities``, ``community_scale``, ``edge_factor``,
``inter_links``, ``hub_links``, ``a``, ``b`` and ``c``."""

from gbharness import gen


def make(config, g, device):
    return gen.crawl(config["n_communities"], config["community_scale"],
                     config["edge_factor"], config["inter_links"], config["hub_links"],
                     config["a"], config["b"], config["c"], g, device)

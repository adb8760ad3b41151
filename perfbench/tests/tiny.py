"""Small copies of the cells' configurations and mixes, for CPU tests."""

import copy

from perfbench import plugins


def tiny(cell_name: str, docs: int = 2000, int8: bool = False):
    c = plugins.cell(cell_name, plugins.benchmark())
    cfg = copy.deepcopy(c["config"])
    tr = copy.deepcopy(c["traffic"])
    cfg["corpus"]["docs"] = docs
    length = cfg["corpus"]["length"]
    if length["dist"] == "lognormal":
        length["mean"] = 40
    else:
        length["n"] = 40
    if int8:
        # the 1M corpus's storage, at a size the CPU holds, where the
        # scorer takes 2,048 frequent terms
        cfg["scorer"]["impact_storage"] = "int8"
        cfg["reference"]["base_rate"]["frequent_terms"] = 2048
    if tr["batch"]["dist"] == "fixed" and tr["batch"]["n"] > 128:
        tr["batch"]["n"] = 128
        tr["pool"] = 4
        tr["warm_requests"] = 2
    else:
        tr["pool"] = 48
        tr["warm_requests"] = 4
    tr["check_rows"] = 160
    tr["trace_requests"] = 2
    return cfg, tr

"""The paper's own workload: the CHILES imaging pipeline as an LGT (§5).

This is the versioned Logical Graph Template a staff astronomer would
release (paper stage 2); `examples/chiles_pipeline.py` binds its parameters
(stage 3) and executes it.  Kept as a config so the paper's own
"architecture" sits next to the 10 assigned LM configs.
"""


def build_template(days: int = 4, bands: int = 6):
    from ..dsl import GraphBuilder
    g = GraphBuilder("chiles-imaging", version="1",
                     parameters={"days": days, "bands": bands})
    g.data("obs")
    with g.scatter("day", days) as sc:
        sc.params["$num_of_copies"] = "days"
        with g.scatter("band", bands) as sb:
            sb.params["$num_of_copies"] = "bands"
            g.component("split", app="chiles_split", time=0.01)
            g.data("chunk", volume=2e8)
            g.component("subtract", app="chiles_subtract", time=0.01)
            g.data("sub", volume=2e8)
    with g.group_by("byband"):
        g.component("clean", app="chiles_clean", time=0.05)
        g.data("img", volume=4e7, payload="file")
    with g.gather("cube", bands) as ga:
        ga.params["$num_of_inputs"] = "bands"
        g.component("concat", app="chiles_concat", time=0.01)
    g.data("final", payload="file")
    g.chain("obs", "split", "chunk", "subtract", "sub", "clean", "img",
            "concat", "final")
    return g.template()

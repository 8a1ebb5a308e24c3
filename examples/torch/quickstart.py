"""Quickstart: compose -> parametrise -> translate -> deploy -> execute.

The six-stage DALiuGE pipeline (paper Fig. 1) on a toy reduction:
  scatter a dataset into 8 partitions, square each, gather the sum.

The PyTorch port's copy: the same graph on ``repro_torch``'s engine and
app registry.

Run:  PYTHONPATH=src python examples/torch/quickstart.py
"""
from repro_torch.core import EngineConfig, Pipeline, register_app
from repro_torch.dsl import GraphBuilder


@register_app("square")
def square(inputs, outputs, app):
    v = inputs[0].read()
    for o in outputs:
        o.write(v * v)


@register_app("sum")
def add(inputs, outputs, app):
    for o in outputs:
        o.write(sum(i.read() for i in inputs))


@register_app("pick")
def pick(inputs, outputs, app):
    """Each scatter branch picks its slice by instance coordinate."""
    data = inputs[0].read()
    (i,) = app.meta["oid"]
    for o in outputs:
        o.write(data[i])


def main() -> None:
    # Stage 1-2: components (above) + logical graph template
    g = GraphBuilder("quickstart", parameters={"width": 4})
    g.data("dataset")
    with g.scatter("part", 4) as sc:
        sc.params["$num_of_copies"] = "width"
        g.component("slice", app="pick", time=0.001)
        g.data("piece")
        g.component("sq", app="square", time=0.001)
        g.data("squared")
    with g.gather("all", 4) as ga:
        ga.params["$num_of_inputs"] = "width"
        g.component("reduce", app="sum", time=0.001)
    g.data("result")
    g.chain("dataset", "slice", "piece", "sq", "squared", "reduce", "result")

    # Stage 3: select & parametrise (PI fills parameters)
    lg = g.lgt.parametrise(width=8)

    # Stages 4-6: translate -> deploy -> execute
    with Pipeline(EngineConfig(num_nodes=2, num_islands=1, dop=4)) as p:
        pgt = p.translate(lg)
        print(f"unrolled {len(pgt)} drops / {len(pgt.edges)} edges "
              f"into {len({s.partition for s in pgt.drops.values()})} "
              "partitions")
        p.deploy()
        report = p.execute(inputs={"dataset": list(range(8))})
        print("status:", report.state, report.status_counts)
        print("events:", report.events_published,
              f"wall: {report.wall_time*1e3:.1f} ms")
        result = p.session.drops["result"].read()
        print("sum of squares 0..7 =", result)
        assert result == sum(i * i for i in range(8))


if __name__ == "__main__":
    main()

"""CHILES case study analogue (paper §5) on synthetic visibilities.

The paper's production pipeline:
  1. split each day's measurement set into frequency chunks   (Scatter x2)
  2. subtract the local sky model per chunk
  3. CLEAN each frequency band across all days                (GroupBy!)
  4. convert to image products
  5. concatenate bands into the final cube                    (Gather)

Here each CASA task is a numpy stand-in over synthetic complex
visibilities; the *graph shape* is the paper's, including the corner-turn
from day-major to frequency-major order.

The PyTorch port's copy: the same apps (numpy, as in the reference)
registered in ``repro_torch``'s app registry, the port's copy of the
template, and its engine.

Run:  PYTHONPATH=src python examples/torch/chiles_pipeline.py
"""
import numpy as np

from repro_torch.core import EngineConfig, Pipeline, register_app
from repro_torch.dsl import GraphBuilder

DAYS = 4
BANDS = 6
CHANNELS_PER_BAND = 16
BASELINES = 35


def synthetic_day(day: int) -> np.ndarray:
    rng = np.random.default_rng(day)
    vis = (rng.normal(size=(BANDS * CHANNELS_PER_BAND, BASELINES))
           + 1j * rng.normal(size=(BANDS * CHANNELS_PER_BAND, BASELINES)))
    # inject a "source" in band 2: a fringe pattern across baselines
    # (zero-median, so the sky-model subtraction doesn't remove it —
    # exactly why interferometers see fringes, not DC offsets)
    fringe = 5.0 * np.exp(1j * np.linspace(0, 6 * np.pi, BASELINES))
    vis[2 * CHANNELS_PER_BAND:3 * CHANNELS_PER_BAND] += fringe[None, :]
    return vis.astype(np.complex64)


@register_app("chiles_split")
def split(inputs, outputs, app):
    """Split one day's MS into frequency chunks (paper step 1)."""
    day, band = app.meta["oid"]
    vis = synthetic_day(day)
    chunk = vis[band * CHANNELS_PER_BAND:(band + 1) * CHANNELS_PER_BAND]
    for o in outputs:
        o.write(chunk)


@register_app("chiles_subtract")
def subtract(inputs, outputs, app):
    """Subtract the local sky model (here: median over baselines)."""
    chunk = inputs[0].read()
    model = np.median(chunk.real, axis=1, keepdims=True)
    for o in outputs:
        o.write(chunk - model)


@register_app("chiles_clean")
def clean(inputs, outputs, app):
    """'CLEAN' one frequency band across ALL days (paper step 3 — this is
    the corner turn: inputs arrive day-major, grouped by band)."""
    stacked = np.stack([i.read() for i in inputs])      # (days, ch, bl)
    dirty = np.abs(stacked.mean(axis=0))                # integrate days
    peak = dirty.max()
    cleaned = np.where(dirty > 0.5 * peak, dirty, 0.0)  # Hogbom-ish
    for o in outputs:
        o.write(cleaned.astype(np.float32))


@register_app("chiles_concat")
def concat(inputs, outputs, app):
    cube = np.stack([i.read() for i in inputs])
    for o in outputs:
        o.write(cube)


def main() -> None:
    # stage 2: the released LGT lives in configs (versioned repository);
    # stage 3: the PI binds this observation's parameters.
    from repro_torch.configs.daliuge_chiles import build_template
    lgt = build_template()
    lg = lgt.parametrise(days=DAYS, bands=BANDS)

    with Pipeline(EngineConfig(num_nodes=4, num_islands=2, dop=8)) as p:
        pgt = p.translate(lg)
        print(f"PGT: {len(pgt)} drops, {len(pgt.edges)} edges")
        p.deploy()
        rep = p.execute(inputs={"obs": "chiles-semester-1"}, timeout=120)
        print("status:", rep.state, rep.status_counts)
        assert rep.ok, rep.errors[:3]
        cube = p.session.drops["final"].read()
        print("final cube:", cube.shape, cube.dtype,
              "| per-band peak:", np.round(cube.max(axis=(1, 2)), 2))
        # the injected source lives in band 2 and must dominate
        assert cube.max(axis=(1, 2)).argmax() == 2
        print("source recovered in band 2 — OK")


if __name__ == "__main__":
    main()

"""The dry-run's stand-ins at full width: every leaf of the port's
``abstract_params`` and ``input_specs`` (fake tensors) has the keystr path,
shape and dtype of the JAX package's ``jax.eval_shape`` counterpart, for
the ten configs and every ``SHAPES`` entry (the decode cache included)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import configs as JC  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models.common import SHAPES  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402


def jax_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), tuple(l.shape), np.dtype(l.dtype).name)
            for p, l in flat]


def port_leaves(tree):
    out = []
    for p, l in leaves_with_path(tree):
        assert type(l).__name__ == "FakeTensor", p      # nothing allocated
        out.append((p, tuple(l.shape), str(l.dtype).replace("torch.", "")))
    return out


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
def test_abstract_params_match_eval_shape(arch):
    got = port_leaves(TC.abstract_params(TC.get_config(arch)))
    want = jax_leaves(JC.abstract_params(JC.get_config(arch)))
    assert got == want


@pytest.mark.parametrize("arch", TC.ARCH_NAMES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_match_eval_shape(arch, shape):
    tcfg, jcfg = TC.get_config(arch), JC.get_config(arch)
    got = port_leaves(TC.input_specs(tcfg, SHAPES[shape]))
    want = jax_leaves(JC.input_specs(jcfg, SHAPES[shape]))
    assert got == want
    if SHAPES[shape].kind == "decode":
        assert any("cache" in p for p, _, _ in got)


def test_cell_supported_matches_the_reference():
    for arch in TC.ARCH_NAMES:
        for shape in SHAPES.values():
            assert TC.cell_supported(TC.get_config(arch), shape) == \
                JC.cell_supported(JC.get_config(arch), shape)

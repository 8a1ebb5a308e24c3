"""Port parity: the MoE layer (``repro_torch.models.moe``) against JAX.

Weights come from the JAX ``init_moe`` (the router f32, the experts in the
config's dtype), bridged as numpy; inputs are seeded numpy.  f32 smoke
configs, atol/rtol 1e-4.  Routing is discontinuous: ``torch.topk`` and
``jax.lax.top_k`` agree except on exact ties, which seeded inputs do not
give, so the outputs are held elementwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402

# smoke: swiglu, 8 experts top-4; geglu, 4 experts top-2
ARCHS = ["granite_moe_3b_a800m", "grok_1_314b"]
TOL = dict(atol=1e-4, rtol=1e-4)


def _params(jcfg, seed=0):
    return jax.tree.map(np.asarray, JMoE.init_moe(
        KeyGen(jax.random.PRNGKey(seed)), jcfg, jnp.dtype(jcfg.dtype)))


def _x(cfg, b, s, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def _both(arch, x, num_groups, **kw):
    """(port (y, aux), JAX (y, aux)) of one moe_block call."""
    cfg = dataclasses.replace(get_smoke_config(arch), **kw)
    jcfg = dataclasses.replace(jax_smoke(arch), **kw)
    tree = _params(jcfg)
    jy, jaux = JMoE.moe_block(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(x), jcfg, num_groups=num_groups)
    ty, taux = TMoE.moe_block(params_from_numpy(tree, "cpu"),
                              torch.from_numpy(x), cfg,
                              num_groups=num_groups)
    return (ty, taux), (np.asarray(jy), np.asarray(jaux)), cfg, tree


def _assert_close(got, want):
    (ty, taux), (jy, jaux) = got, want
    assert ty.dtype == torch.float32 and tuple(ty.shape) == jy.shape
    np.testing.assert_allclose(ty.numpy(), jy, **TOL)
    np.testing.assert_allclose(taux.numpy(), jaux, **TOL)


@pytest.mark.parametrize("num_groups", [None, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax(arch, num_groups):
    """Output and aux loss, per-batch dispatch groups (the prefill) and one
    group (the decode)."""
    got, want, _, _ = _both(arch, _x(get_smoke_config(arch), 2, 12),
                            num_groups)
    _assert_close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_overflow_drops_tokens_as_jax_does(arch):
    """capacity_factor 0.25 and 48 tokens a group: some experts get more
    slots than their capacity of 8, so later slots drop; the port drops the
    same ones."""
    x = _x(get_smoke_config(arch), 2, 48, seed=3)
    got, want, cfg, tree = _both(arch, x, None, capacity_factor=0.25)
    _assert_close(got, want)
    cap = TMoE.expert_capacity(cfg, 48)
    probs = torch.softmax(torch.from_numpy(x) @ torch.tensor(tree["router"]),
                          dim=-1)
    idx = torch.topk(probs, cfg.top_k, dim=-1).indices      # (b, s, k)
    per_expert = torch.stack([torch.bincount(i.reshape(-1),
                                             minlength=cfg.num_experts)
                              for i in idx])
    assert int(per_expert.max()) > cap, (per_expert, cap)
    # the dropped slots change the output: more capacity gives another y
    roomy, _, _, _ = _both(arch, x, None, capacity_factor=8.0)
    assert not torch.allclose(roomy[0], got[0], **TOL)


@pytest.mark.parametrize("tokens", [1, 4, 12, 48, 100, 512, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_jax(arch, tokens):
    for cfg, jcfg in ((get_smoke_config(arch), jax_smoke(arch)),
                      (get_config(arch), jax_config(arch))):
        assert TMoE.expert_capacity(cfg, tokens) == \
            JMoE.expert_capacity(jcfg, tokens)


def test_router_stays_f32_in_bf16():
    cfg = dataclasses.replace(get_smoke_config("granite_moe_3b_a800m"),
                              dtype="bfloat16")
    p = TMoE.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                      torch.device("cpu"))
    assert p["router"].dtype == torch.float32
    assert p["w1"].dtype == p["w2"].dtype == p["w3"].dtype == torch.bfloat16
    y, aux = TMoE.moe_block(p, torch.randn(2, 5, cfg.d_model,
                                           dtype=torch.bfloat16), cfg)
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32


def test_uneven_groups_raise():
    cfg = get_smoke_config("grok_1_314b")
    p = TMoE.init_moe(torch.Generator().manual_seed(0), cfg, torch.float32,
                      torch.device("cpu"))
    with pytest.raises(ValueError, match="groups"):
        TMoE.moe_block(p, torch.zeros(1, 5, cfg.d_model), cfg, num_groups=2)

"""The MoE block on tied router probabilities, on both of its routes,
against the reference's block (``repro/models/moe.py``) on the CPU.

``lax.top_k`` puts the lower expert first among equal probabilities.  With
the router zeroed every probability of a token is 1 / E, so the ties run
across the k-th place: a top-k that orders ties otherwise picks other
experts and gives another y.  Granite's and grok's smoke configs (weights
from the JAX ``init_moe``, the router's columns set to 0) hold y on the
plain route (``use_kernel=False``: the route of training, of the dry-run
and of every CPU call) and on the kernel route's plain version
(``use_kernel=True``) within ``tests/test_torch_moe.py``'s 1e-4 of JAX's
block, and the plain route's grads of x and of the router within 1e-4 of
``jax.grad`` of the reference block (the kernel route has no backward).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.models import moe as JMoE  # noqa: E402
from repro.models.common import KeyGen  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402

ARCHS = ["granite_moe_3b_a800m", "grok_1_314b"]
TOL = dict(atol=1e-4, rtol=1e-4)        # tests/test_torch_moe.py's
B, S = 2, 12


def _tied(arch):
    """The smoke config, the JAX init's MoE weights with the router zeroed,
    tokens (B, S, d) and the weights of y in the scalar the grads are of,
    from numpy."""
    cfg = get_smoke_config(arch)
    jcfg = jax_smoke(arch)
    tree = jax.tree.map(np.asarray, JMoE.init_moe(
        KeyGen(jax.random.PRNGKey(0)), jcfg, jnp.dtype(jcfg.dtype)))
    tree["router"] = np.zeros_like(tree["router"])
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return cfg, jcfg, tree, x, w


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_tied_probabilities_pick_jax_experts(arch, use_kernel):
    cfg, jcfg, tree, x, _ = _tied(arch)
    assert cfg.top_k < cfg.num_experts     # ties across the k-th place
    jy, jaux = JMoE.moe_block(jax.tree.map(jnp.asarray, tree),
                              jnp.asarray(x), jcfg)
    y, aux = TMoE.moe_block(params_from_numpy(tree, "cpu"),
                            torch.from_numpy(x), cfg, use_kernel=use_kernel)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(jaux), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_tied_probabilities_grads_are_jax(arch):
    """sum(y w) + aux: the plain route's grads of x and of the router (the
    gates' backward through the sort's values) against ``jax.grad``."""
    cfg, jcfg, tree, x, w = _tied(arch)

    def jloss(router, xx):
        y, aux = JMoE.moe_block({**jax.tree.map(jnp.asarray, tree),
                                 "router": router}, xx, jcfg)
        return jnp.sum(y * w) + aux
    jg_router, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(tree["router"]), jnp.asarray(x))

    p = params_from_numpy(tree, "cpu")
    router = p["router"].clone().requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = TMoE.moe_block({**p, "router": router}, tx, cfg)
    (y * torch.from_numpy(w)).sum().add(aux).backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg_x), **TOL)
    np.testing.assert_allclose(router.grad.numpy(), np.asarray(jg_router),
                               **TOL)


def test_tied_router_is_a_real_tie():
    """Zeroed router columns give every expert the same probability, so
    the order of the top k is the tie rule's alone."""
    _, _, tree, x, _ = _tied(ARCHS[0])
    probs = torch.softmax(torch.einsum(
        "bsd,de->bse", torch.from_numpy(x),
        torch.from_numpy(tree["router"])), -1)
    assert bool((probs == probs[..., :1]).all())

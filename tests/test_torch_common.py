"""Port parity: ``repro_torch.models.common`` against ``repro.models.common``.

Same numpy inputs (``default_rng``) through both; f32, atol 1e-6 unless
stated with its reason.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES as JAX_ARCH_NAMES  # noqa: E402
from repro.configs import cell_supported as jax_cell_supported  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro_torch import configs as TCFG  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402

ATOL = 1e-6


def _np(t):
    return np.asarray(t, dtype=np.float32)


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _rng(seed):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(3, 16), (2, 5, 64)])
def test_rms_norm(shape):
    x = _rng(0).standard_normal(shape).astype(np.float32)
    s = 0.1 * _rng(1).standard_normal(shape[-1]).astype(np.float32)
    _close(TC.rms_norm(torch.from_numpy(x), torch.from_numpy(s)),
           JC.rms_norm(jnp.asarray(x), jnp.asarray(s)))


def test_rms_norm_keeps_bf16():
    x = _rng(2).standard_normal((4, 32)).astype(np.float32)
    out = TC.rms_norm(torch.from_numpy(x).bfloat16(), torch.zeros(32))
    assert out.dtype == torch.bfloat16


@pytest.mark.parametrize("xdt,wdt", [("float32", "bfloat16"),
                                     ("bfloat16", "float32"),
                                     ("bfloat16", "bfloat16"),
                                     ("float32", "float32")])
def test_einsum_promotes_as_jax(xdt, wdt):
    """Mixed bf16/f32 operands promote to f32 as in jnp.einsum (the whisper
    encoder's f32 frames through bf16 weights); one dtype stays as is."""
    x = _rng(3).standard_normal((2, 5, 16)).astype(np.float32)
    w = _rng(4).standard_normal((16, 4, 8)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(xdt), jnp.asarray(w).astype(wdt)
    tx = torch.from_numpy(x).to(getattr(torch, xdt))
    tw = torch.from_numpy(w).to(getattr(torch, wdt))
    want = jnp.einsum("bsd,dhk->bshk", jx, jw)
    got = TC.einsum("bsd,dhk->bshk", tx, tw)
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    tol = 1e-5 if want.dtype == jnp.float32 else 2e-2
    _close(got.float(), want.astype(jnp.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["swiglu", "geglu", "gelu", "relu2"])
def test_activation_fn(name):
    x = 3.0 * _rng(3).standard_normal((8, 33)).astype(np.float32)
    _close(TC.activation_fn(name)(torch.from_numpy(x)),
           JC.activation_fn(name)(jnp.asarray(x)))


def test_activation_fn_unknown_raises():
    with pytest.raises(ValueError):
        TC.activation_fn("tanh")


@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap):
    # |x| up to ~200 so the cap bites.  Outputs reach |cap|, where one f32
    # ulp (3.8e-6 at 32) already exceeds 1e-6, so atol scales with cap:
    # 1e-6 * cap, a few ulp of the largest output
    x = 60.0 * _rng(4).standard_normal((5, 40)).astype(np.float32)
    _close(TC.softcap(torch.from_numpy(x), cap),
           JC.softcap(jnp.asarray(x), cap), atol=ATOL * max(cap, 1.0))


@pytest.mark.parametrize("hd,theta", [(8, 1e4), (16, 1e4), (128, 1e6)])
def test_rope_freqs(hd, theta):
    _close(TC.rope_freqs(hd, theta), JC.rope_freqs(hd, theta))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("hd", [8, 16, 128])
def test_apply_rope(hd, theta):
    b, s, h = 2, 12, 3
    x = _rng(5).standard_normal((b, s, h, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s), (b, s)).astype(np.int32)
    _close(TC.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           JC.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("seq,dim", [(7, 16), (33, 64)])
def test_sinusoidal_positions(seq, dim):
    _close(TC.sinusoidal_positions(seq, dim),
           JC.sinusoidal_positions(seq, dim))


def test_cross_entropy_masks_out_of_range_labels():
    logits = 4.0 * _rng(6).standard_normal((3, 5, 40)).astype(np.float32)
    labels = _rng(7).integers(0, 32, size=(3, 5)).astype(np.int32)
    labels[0, 0] = -1          # masked
    labels[1, 2] = 35          # padded-vocab slot >= vocab_size: masked
    _close(TC.cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), 32),
           JC.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 32))


def test_dense_init_scale_and_dtype():
    gen = torch.Generator().manual_seed(0)
    w = TC.dense_init(gen, (256, 64), torch.bfloat16, fan_in=256)
    assert w.shape == (256, 64) and w.dtype == torch.bfloat16
    assert abs(float(w.float().std()) - 1 / 16) < 5e-3
    again = TC.dense_init(torch.Generator().manual_seed(0), (256, 64),
                          torch.bfloat16, fan_in=256)
    assert torch.equal(w, again)


def test_round_up():
    for x, m in [(0, 256), (1, 256), (256, 256), (92416, 256), (65, 8)]:
        assert TC.round_up(x, m) == JC.round_up(x, m)


@pytest.mark.parametrize("arch", JAX_ARCH_NAMES)
def test_configs_match_field_for_field(arch):
    assert TCFG.ARCH_NAMES == JAX_ARCH_NAMES
    for t, j in [(TCFG.get_config(arch), jax_get_config(arch)),
                 (TCFG.get_smoke_config(arch), jax_get_smoke(arch))]:
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()
        assert t.padded_vocab == j.padded_vocab
        assert t.resolved_head_dim == j.resolved_head_dim
        for shape in JC.SHAPES.values():
            assert (TCFG.cell_supported(t, TC.SHAPES[shape.name])
                    == jax_cell_supported(j, shape))
    assert set(TCFG.all_configs()) == set(JAX_ARCH_NAMES)


def test_shapes_match():
    assert {k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JC.SHAPES.items()}


def test_resolve_device_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA")
    with pytest.raises(RuntimeError, match="cuda"):
        TC.resolve_device("cuda")
    assert TC.resolve_device("cpu").type == "cpu"


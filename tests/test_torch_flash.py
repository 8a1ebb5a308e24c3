"""Port parity: flash attention.

The port's CPU route of ``flash_attention_bhsd`` (its plain version) and
``mha_reference`` against the JAX Pallas kernel run in interpret mode and
the JAX oracle, on the shape, mask/softcap and dtype cases of
``tests/test_kernels.py``; tolerances as there (f32 2e-5, bf16 2e-2).  The
CUDA kernel itself is checked against the plain version on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_bhsd as jax_flash  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def both(a, dtype="float32"):
    """The same numpy array as a JAX array and a torch tensor of dtype."""
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (1, 1, 1, 32, 32, 16),
    (2, 4, 2, 64, 64, 32),       # GQA 2:1
    (1, 8, 2, 128, 128, 64),     # GQA 4:1
    (2, 2, 2, 48, 80, 32),       # non-square, non-block-multiple
    (1, 4, 4, 17, 33, 8),        # ragged (padding path)
])
def test_shapes_vs_jax_kernel(b, hq, hkv, sq, sk, d):
    (jq, q), (jk, k), (jv, v) = (both(rnd(0, (b, hq, sq, d))),
                                 both(rnd(1, (b, hkv, sk, d))),
                                 both(rnd(2, (b, hkv, sk, d))))
    got = fa.flash_attention_bhsd(q, k, v, causal=False)
    close(got, jax_flash(jq, jk, jv, causal=False, block_q=32, block_k=32,
                         interpret=True), 2e-5)
    close(tref.mha_reference(q, k, v, causal=False),
          jref.mha_reference(jq, jk, jv, causal=False), 2e-5)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (2, 4, 4, 6, 6, 16, False),      # whisper encoder: non-causal MHA,
                                     # Sk=6 not a multiple of block_k
    (2, 6, 2, 40, 40, 16, True),     # granite prefill: GQA 3:1, causal
    (1, 6, 2, 20, 36, 8, False),     # GQA 3:1, non-causal, ragged
])
def test_new_path_shapes_vs_jax_kernel(b, hq, hkv, sq, sk, d, causal):
    """The moe and encdec paths' attention: non-causal MHA in f32 (the
    whisper encoder) and a 3:1 GQA group (granite-moe)."""
    (jq, q), (jk, k), (jv, v) = (both(rnd(16, (b, hq, sq, d))),
                                 both(rnd(17, (b, hkv, sk, d))),
                                 both(rnd(18, (b, hkv, sk, d))))
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    close(got, jax_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                         interpret=True), 2e-5)
    close(got, jref.mha_reference(jq, jk, jv, causal=causal), 2e-5)


@pytest.mark.parametrize("causal,window,cap", [
    (True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0),
    (True, 0, 30.0), (True, 8, 50.0), (False, 0, 20.0),
])
def test_mask_and_softcap_vs_jax_kernel(causal, window, cap):
    (jq, q), (jk, k), (jv, v) = (both(rnd(3, (2, 4, 64, 32))),
                                 both(rnd(4, (2, 2, 64, 32))),
                                 both(rnd(5, (2, 2, 64, 32))))
    opts = dict(causal=causal, window=window, logit_cap=cap)
    got = fa.flash_attention_bhsd(q, k, v, **opts)
    close(got, jax_flash(jq, jk, jv, block_q=32, block_k=32, interpret=True,
                         **opts), 2e-5)
    close(tref.mha_reference(q, k, v, **opts),
          jref.mha_reference(jq, jk, jv, **opts), 2e-5)


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_dtypes_vs_jax(dtype, atol):
    (jq, q), (jk, k), (jv, v) = (both(rnd(6, (1, 2, 64, 32), 0.5), dtype),
                                 both(rnd(7, (1, 2, 64, 32), 0.5), dtype),
                                 both(rnd(8, (1, 2, 64, 32), 0.5), dtype))
    got = fa.flash_attention_bhsd(q, k, v)
    assert got.dtype == q.dtype
    want = jref.mha_reference(jq.astype(jnp.float32), jk.astype(jnp.float32),
                              jv.astype(jnp.float32))
    close(got, want, atol)
    close(got, jax_flash(jq, jk, jv, block_q=32, block_k=32,
                         interpret=True), atol)


def test_ops_layout_wrapper_vs_jax():
    """Model layout (B,S,H,D) in and out, GQA + window + cap."""
    (jq, q), (jk, k), (jv, v) = (both(rnd(9, (2, 40, 4, 16))),
                                 both(rnd(10, (2, 40, 2, 16))),
                                 both(rnd(11, (2, 40, 2, 16))))
    opts = dict(causal=True, window=8, logit_cap=30.0)
    got = tops.flash_attention(q, k, v, **opts)
    assert got.shape == q.shape
    close(got, jops.flash_attention(jq, jk, jv, block_q=32, block_k=32,
                                    **opts), 2e-5)


def test_cpu_route_counts_no_launch():
    q = torch.from_numpy(rnd(12, (1, 2, 8, 8)))
    before = fa.flash_attention_bhsd.launches
    out = fa.flash_attention_bhsd(q, q, q)
    assert fa.flash_attention_bhsd.launches == before
    assert torch.equal(out, fa.flash_attention_plain(q, q, q))


@pytest.mark.parametrize("case,msg", [
    ("head_dim_12", "head_dim"), ("head_dim_264", "head_dim"),
    ("fp16", "dtype"), ("strided", "contiguous"), ("gqa_3_2", "multiple"),
    ("kv_dtype", "is torch"), ("empty", "empty"), ("window", "window"),
])
def test_kernel_input_checks_raise(case, msg):
    """What the CUDA kernel does not take raises before any launch."""
    q = torch.zeros((1, 2, 16, 16))
    k = v = torch.zeros((1, 2, 16, 16))
    window = 0
    if case == "head_dim_12":
        q = k = v = torch.zeros((1, 2, 16, 12))
    elif case == "head_dim_264":
        q = k = v = torch.zeros((1, 2, 16, 264))
    elif case == "fp16":
        q = k = v = q.half()
    elif case == "strided":
        q = torch.zeros((1, 16, 2, 16)).transpose(1, 2)
    elif case == "gqa_3_2":
        q = torch.zeros((1, 3, 16, 16))
    elif case == "kv_dtype":
        k = k.bfloat16()
    elif case == "empty":
        q = torch.zeros((1, 2, 0, 16))
    elif case == "window":
        window = -1
    with pytest.raises(ValueError, match=msg):
        fa._check(q, k, v, window)


def test_meta_tensors_raise_instead_of_falling_back():
    q = torch.empty((1, 2, 16, 16), device="meta")
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, q, q)


def test_build_needs_nvcc_and_targets_sm90a():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    path = _build.lib_path("flash_attention")
    assert path.parent == _build.BUILD_DIR
    assert path == _build.lib_path("flash_attention")    # stable hash
    try:
        _build._nvcc()
    except RuntimeError:
        pass
    else:
        pytest.skip("this box has nvcc")
    if path.exists():
        pytest.skip("the kernel is already built here")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(["flash_attention"])


def test_rows_without_a_visible_key_follow_the_jax_oracle():
    """Sq > Sk with a window: rows 12..19 see no key and average V over all
    keys in the oracle.  The JAX Pallas kernel differs there (it also
    averages its zero padding); the port follows the oracle."""
    (jq, q), (jk, k), (jv, v) = (both(rnd(13, (1, 2, 20, 8))),
                                 both(rnd(14, (1, 1, 10, 8))),
                                 both(rnd(15, (1, 1, 10, 8))))
    opts = dict(causal=True, window=3)
    want = jref.mha_reference(jq, jk, jv, **opts)
    close(fa.flash_attention_bhsd(q, k, v, **opts), want, 2e-5)
    close(fa.flash_attention_bhsd(q, k, v, **opts)[:, :, 12:],
          np.broadcast_to(np.asarray(jv).mean(axis=2, keepdims=True),
                          (1, 2, 8, 8)), 2e-5)

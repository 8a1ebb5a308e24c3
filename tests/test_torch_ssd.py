"""Port parity: the Mamba2 SSD chunk scan.

The port's CPU route of ``ssd_scan_bhsd`` (its plain version), its
``ssd_reference`` oracle, ``ops.ssd_scan`` and the model's ``ssd_chunked``
against the JAX Pallas kernel run in interpret mode and the JAX oracle, on
the cases of ``tests/test_kernels.py::TestSSDScan`` and
``TestModelScanAgreement``.  Tolerances: 1e-5 against the JAX kernel (the
same chunked f32 math), 2e-4 against the sequential oracle (another order
of sums over the sequence, as in test_kernels), 5e-2 in bf16.  The CUDA
kernel itself is checked against the plain version on the card by
``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_bhsd as jax_ssd  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def softplus(a):
    return np.log1p(np.exp(a)).astype(np.float32)


def inputs(seed, b, h, s, p, n, g=None):
    """x, dt, a, b, c as numpy (kernel layout; b/c with g groups, default
    one per head)."""
    g = h if g is None else g
    return (rnd(seed, (b, h, s, p), 0.5),
            softplus(rnd(seed + 1, (b, h, s))),
            -np.exp(rnd(seed + 2, (h,), 0.3)),
            rnd(seed + 3, (b, g, s, n), 0.5),
            rnd(seed + 4, (b, g, s, n), 0.5))


def to_torch(arrs, dtype=torch.float32):
    """x, b, c in ``dtype``; dt and a stay f32."""
    x, dt, a, b, c = (torch.from_numpy(v) for v in arrs)
    return x.to(dtype), dt, a, b.to(dtype), c.to(dtype)


def to_jax(arrs, dtype="float32"):
    x, dt, a, b, c = (jnp.asarray(v) for v in arrs)
    return x.astype(dtype), dt, a, b.astype(dtype), c.astype(dtype)


def close(got, want, atol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=atol)


SHAPES = [                          # tests/test_kernels.py::TestSSDScan
    (1, 1, 32, 8, 4, 8),
    (2, 3, 64, 16, 8, 16),
    (1, 2, 128, 32, 16, 32),
    (2, 1, 64, 8, 8, 64),           # single chunk
]


@pytest.mark.parametrize("b,h,s,p,n,chunk", SHAPES)
def test_plain_vs_jax_kernel_and_oracle(b, h, s, p, n, chunk):
    arrs = inputs(0, b, h, s, p, n)
    y, st = ss.ssd_scan_bhsd(*to_torch(arrs), chunk)
    jy, jst = jax_ssd(*to_jax(arrs), chunk, interpret=True)
    close(y, jy, 1e-5)
    close(st, jst, 1e-5)
    ry, rst = jref.ssd_reference(*to_jax(arrs))
    close(y, ry, 2e-4)
    close(st, rst, 2e-4)


def test_chunk_invariance():
    t = to_torch(inputs(5, 1, 2, 64, 8, 4))
    y1, s1 = ss.ssd_scan_bhsd(*t, 8)
    y2, s2 = ss.ssd_scan_bhsd(*t, 32)
    torch.testing.assert_close(y1, y2, atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(s1, s2, atol=2e-4, rtol=2e-4)


def test_bf16_vs_jax():
    arrs = inputs(10, 1, 2, 32, 8, 4)
    y, st = ss.ssd_scan_bhsd(*to_torch(arrs, torch.bfloat16), 8)
    assert y.dtype == st.dtype == torch.bfloat16
    ry, _ = jref.ssd_reference(*to_jax(arrs))       # f32 inputs
    close(y, ry, 5e-2)
    jy, jst = jax_ssd(*to_jax(arrs, "bfloat16"), 8, interpret=True)
    close(y, jy, 5e-2)
    close(st, jst, 5e-2)


@pytest.mark.parametrize("with_state", [False, True])
def test_oracle_vs_jax_oracle(with_state):
    arrs = inputs(20, 2, 3, 24, 8, 4)
    init = rnd(25, (2, 3, 4, 8)) if with_state else None
    y, st = tref.ssd_reference(
        *to_torch(arrs),
        initial_state=None if init is None else torch.from_numpy(init))
    jy, jst = jref.ssd_reference(
        *to_jax(arrs), initial_state=None if init is None
        else jnp.asarray(init))
    close(y, jy, 1e-5)
    close(st, jst, 1e-5)


def test_grouped_b_c_by_index_match_broadcast():
    """G=2 groups of two heads: the kernel layout reads each group by index,
    the same as the JAX signature's pre-broadcast heads."""
    x, dt, a, b, c = to_torch(inputs(30, 2, 4, 32, 8, 4, g=2))
    y_g, st_g = ss.ssd_scan_bhsd(x, dt, a, b, c, 8)
    y_h, st_h = ss.ssd_scan_bhsd(x, dt, a, b.repeat_interleave(2, dim=1),
                                 c.repeat_interleave(2, dim=1), 8)
    torch.testing.assert_close(y_g, y_h)
    torch.testing.assert_close(st_g, st_h)


def test_ops_ssd_scan_groups_vs_jax():
    """Model layout (B,S,H,P), b/c (B,S,G,N) with G=2, against JAX's
    ``kops.ssd_scan`` (Pallas, interpret mode)."""
    bsz, s, h, p, g, n = 2, 32, 4, 8, 2, 4
    x = rnd(40, (bsz, s, h, p), 0.5)
    dt = softplus(rnd(41, (bsz, s, h)))
    a = -np.exp(rnd(42, (h,), 0.3))
    b = rnd(43, (bsz, s, g, n), 0.5)
    c = rnd(44, (bsz, s, g, n), 0.5)
    y, st = tops.ssd_scan(*(torch.from_numpy(v) for v in (x, dt, a, b, c)),
                          8)
    assert y.shape == (bsz, s, h, p) and st.shape == (bsz, h, n, p)
    jy, jst = jops.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, b, c)), 8)
    close(y, jy, 1e-5)
    close(st, jst, 1e-5)


def test_three_way_agreement():
    """The port of TestModelScanAgreement: the model-layout ``ssd_chunked``,
    the sequential oracle and the kernel's plain version, one math."""
    b, h, s, p, n = 2, 4, 64, 8, 4
    x = torch.from_numpy(rnd(20, (b, s, h, p), 0.5))
    dt = torch.from_numpy(softplus(rnd(21, (b, s, h))))
    a = torch.from_numpy(-np.exp(rnd(22, (h,), 0.3)))
    bb = torch.from_numpy(rnd(23, (b, s, 1, n), 0.5))
    cc = torch.from_numpy(rnd(24, (b, s, 1, n), 0.5))
    y_model, st_model = tssm.ssd_chunked(x, dt, a, bb, cc, chunk=16)
    xt, dtt = x.transpose(1, 2).contiguous(), dt.transpose(1, 2).contiguous()
    bt = bb.transpose(1, 2).repeat_interleave(h, dim=1)
    ct = cc.transpose(1, 2).repeat_interleave(h, dim=1)
    y_ref, st_ref = tref.ssd_reference(xt, dtt, a, bt, ct)
    y_plain, st_plain = ss.ssd_scan_plain(xt, dtt, a, bt, ct, 16)
    tol = dict(atol=2e-4, rtol=2e-4)
    torch.testing.assert_close(y_model.transpose(1, 2), y_ref, **tol)
    torch.testing.assert_close(y_plain, y_ref, **tol)
    torch.testing.assert_close(st_model, st_ref, **tol)
    torch.testing.assert_close(st_plain, st_ref, **tol)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 5e-2)])
def test_ssd_chunked_vs_jax(dtype, atol):
    """The model's torch path (loop over chunks) against the JAX jnp path
    (associative scan over chunks), with an initial state."""
    b, s, h, p, g, n = 2, 32, 4, 8, 2, 4
    x = rnd(50, (b, s, h, p), 0.5)
    dt = softplus(rnd(51, (b, s, h)))
    a = -np.exp(rnd(52, (h,), 0.3))
    bb, cc = rnd(53, (b, s, g, n), 0.5), rnd(54, (b, s, g, n), 0.5)
    init = rnd(55, (b, h, n, p), 0.5)
    tdt = getattr(torch, dtype)
    y, st = tssm.ssd_chunked(
        torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
        torch.from_numpy(a), torch.from_numpy(bb).to(tdt),
        torch.from_numpy(cc).to(tdt), 8,
        initial_state=torch.from_numpy(init).to(tdt))
    jy, jst = jssm.ssd_chunked(
        jnp.asarray(x).astype(dtype), jnp.asarray(dt), jnp.asarray(a),
        jnp.asarray(bb).astype(dtype), jnp.asarray(cc).astype(dtype), 8,
        initial_state=jnp.asarray(init).astype(dtype))
    assert y.dtype == torch.float32 and st.dtype == tdt
    close(y, jy, atol)
    close(st, jst, atol)


def test_kernel_route_rejects_initial_state():
    x = torch.zeros((1, 8, 2, 4))
    dt = torch.zeros((1, 8, 2))
    b = torch.zeros((1, 8, 1, 4))
    with pytest.raises(NotImplementedError, match="zero state"):
        tops.ssd_scan(x, dt, torch.zeros(2), b, b, 8,
                      initial_state=torch.zeros((1, 2, 4, 4)))
    with pytest.raises(NotImplementedError, match="zero state"):
        tssm.ssd_chunked(x, dt, torch.zeros(2), b, b, 8,
                         initial_state=torch.zeros((1, 2, 4, 4)),
                         use_kernel=True)


def test_cpu_route_counts_no_launch():
    t = to_torch(inputs(60, 1, 2, 16, 8, 4))
    before = ss.ssd_scan_bhsd.launches
    y, st = ss.ssd_scan_bhsd(*t, 8)
    assert ss.ssd_scan_bhsd.launches == before
    y2, st2 = ss.ssd_scan_plain(*t, 8)
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.parametrize("case,msg", [
    ("chunk", "multiple of chunk"), ("rank", "ranks"), ("dt_shape", "fit"),
    ("bc_shape", "fit"), ("groups_3_of_4", "multiple of G"),
    ("fp16", "not supported"), ("b_dtype", "expected"),
    ("dt_dtype", "expected"), ("strided", "contiguous"),
    ("misaligned", "aligned"), ("empty", "empty"), ("state_256", "N"),
])
def test_kernel_input_checks_raise(case, msg):
    """What the CUDA kernel does not take raises before any launch."""
    x, dt, a, b, c = (torch.zeros((1, 4, 16, 8)), torch.zeros((1, 4, 16)),
                      torch.zeros(4), torch.zeros((1, 1, 16, 4)),
                      torch.zeros((1, 1, 16, 4)))
    chunk = 8
    if case == "chunk":
        chunk = 6
    elif case == "rank":
        x = x[0]
    elif case == "dt_shape":
        dt = torch.zeros((1, 4, 8))
    elif case == "bc_shape":
        c = torch.zeros((1, 1, 16, 5))
    elif case == "groups_3_of_4":
        b = c = torch.zeros((1, 3, 16, 4))
    elif case == "fp16":
        x, b, c = x.half(), b.half(), c.half()
    elif case == "b_dtype":
        b = b.bfloat16()
    elif case == "dt_dtype":
        dt = dt.double()
    elif case == "strided":
        x = torch.zeros((1, 16, 4, 8)).transpose(1, 2)
    elif case == "misaligned":
        x = torch.zeros(1 * 4 * 16 * 8 + 1)[1:].view(1, 4, 16, 8)
    elif case == "empty":
        x = torch.zeros((1, 4, 16, 0))
    elif case == "state_256":
        b = c = torch.zeros((1, 1, 16, 264))
    with pytest.raises(ValueError, match=msg):
        ss._check(x, dt, a, b, c, chunk)


def test_meta_tensors_raise_instead_of_falling_back():
    x = torch.empty((1, 2, 16, 8), device="meta")
    dt = torch.empty((1, 2, 16), device="meta")
    b = torch.empty((1, 2, 16, 4), device="meta")
    with pytest.raises(ValueError):
        ss.ssd_scan_bhsd(x, dt, torch.empty(2, device="meta"), b, b, 8)


def test_build_lists_the_source():
    assert "ssd_scan" in _build.KERNEL_SOURCES
    assert (_build.CSRC / "ssd_scan.cu").exists()
    path = _build.lib_path("ssd_scan")
    assert path.parent == _build.BUILD_DIR
    assert path != _build.lib_path("flash_attention")

"""RMSNorm and RoPE: ``kernels/norm_rope.py`` and its plain versions.

The CUDA kernels (``csrc/norm_rope.cu``) run only on the card, where
``chip_smoke.py`` holds them to the plain versions.  Here, on the CPU,
with inputs made from a seed with numpy:

(a) the plain forwards (``models.common.rms_norm_plain``,
    ``apply_rope_plain``) and the plain backward formulas
    (``rms_norm_bwd_plain``, ``rope_bwd_plain``) against ``jax.vjp`` of the
    JAX package's ``rms_norm`` and ``apply_rope``: f32, bf16, and f32 x
    with a bf16 scale; widths 16, 80, 768 and 4096 and qk-norm's
    (B, S, H, hd); positions ``arange``, shifted by 3, and a decode step's
    (B, 1).  The reference is JAX's result on f32 upcasts of the same
    values (JAX computes both in f32 inside, then rounds): an f32 result
    within 1e-5 x max|ref|, a bf16 one within 2^-8 |ref| + 1e-5 x max|ref|
    (one rounding of a value within 1e-5 x max|ref|), as chip_smoke
    holds the kernels (``ta_within``);
(b) an emulation of ``rms_norm_dscale``'s fixed order of sums (chunks of
    rows, the block's row slots in order, strided runs of the chunks'
    partials, the runs in order; ``plan``) within 1e-6 of the sum's
    magnitude of an f64 sum, the same bits on every call;
(c) the dispatch: CPU and meta tensors take the plain versions, other
    devices, CUDA DTensors and mixes raise, the launch functions refuse
    CPU tensors, and the kernels take every width the configs use (rows
    past 8,192 elements in passes: command-r-plus's 12,288);
(d) the autograd functions (``RMSNorm``, ``Rope``) with their launches
    emulated on the CPU by the plain formulas: a small dense config's
    and chameleon's (qk-norm, GQA) ``forward_train`` loss and grads equal
    JAX's ``value_and_grad`` with and without remat, and the launches a
    train step and a serve run make (every smoke path) are the ones
    ``chip_smoke.py`` expects of the card;
(e) the build lists the source, and the wrapper's launch-shape constants
    are the source's.

Every test runs on one intra-op thread: the plain versions' reductions
split across pool threads could give other bits from call to call.
"""
import re
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke  # noqa: E402
from repro.data import synthetic_batch  # noqa: E402
from repro.models import common as JC  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import norm_rope as K  # noqa: E402
from repro_torch.launch.train import PRESETS  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.train import make_train_step, train_state_init  # noqa: E402
from repro_torch.train.steps import _grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL_TOL = 1e-5
BF16_HALF_ULP = 2.0 ** -8
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def within(got: torch.Tensor, ref) -> None:
    """``got`` (in its dtype) against the f32 reference ``ref``."""
    ref = np.asarray(ref, dtype=np.float32)
    got_np = got.detach().float().numpy()
    assert got_np.shape == ref.shape
    scale = float(np.abs(ref).max())
    tol = REL_TOL * scale + (BF16_HALF_ULP * np.abs(ref)
                             if got.dtype == torch.bfloat16 else 0.0)
    err = np.abs(got_np - ref)
    assert (err <= tol).all(), float((err - tol).max())


def as_torch(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def upcast(t: torch.Tensor) -> jnp.ndarray:
    """The values of ``t`` as an f32 JAX array (exact)."""
    return jnp.asarray(t.float().numpy())


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# ---------------------------------------------------------------------------
# (a) the plain versions against jax.vjp
# ---------------------------------------------------------------------------

NORM_SHAPES = [(3, 16), (2, 5, 80), (2, 3, 768), (2, 4096),
               (2, 3, 4, 128)]           # the last: qk-norm's (B, S, H, hd)
NORM_DTYPES = [("float32", "float32"), ("bfloat16", "bfloat16"),
               ("float32", "bfloat16")]


def norm_inputs(seed, shape, x_dt, s_dt):
    rng = np.random.default_rng(seed)
    x = 2 * rng.standard_normal(shape).astype(np.float32)
    s = 0.1 * rng.standard_normal(shape[-1]).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return (as_torch(x, DTYPES[x_dt][0]), as_torch(s, DTYPES[s_dt][0]),
            as_torch(dy, DTYPES[x_dt][0]))


@pytest.mark.parametrize("x_dt,s_dt", NORM_DTYPES)
@pytest.mark.parametrize("shape", NORM_SHAPES)
def test_rms_norm_plain_and_its_backward_match_jax_vjp(shape, x_dt, s_dt):
    x, s, dy = norm_inputs(len(shape) + shape[-1], shape, x_dt, s_dt)
    y_ref, vjp = jax.vjp(JC.rms_norm, upcast(x), upcast(s))
    dx_ref, ds_ref = vjp(upcast(dy))
    y = TC.rms_norm(x, s)
    assert y.dtype == x.dtype
    within(y, y_ref)
    dx, ds = K.rms_norm_bwd_plain(x, s, dy)
    assert (dx.dtype, ds.dtype) == (x.dtype, s.dtype)
    assert dx.shape == x.shape and ds.shape == s.shape
    within(dx, dx_ref)
    within(ds, ds_ref)
    # the JAX package in the inputs' own dtypes rounds the same values
    y_j, vjp_j = jax.vjp(JC.rms_norm,
                         jnp.asarray(x.float().numpy(), DTYPES[x_dt][1]),
                         jnp.asarray(s.float().numpy(), DTYPES[s_dt][1]))
    dx_j, ds_j = vjp_j(jnp.asarray(dy.float().numpy(), DTYPES[x_dt][1]))
    for got, want in ((y, y_j), (dx, dx_j), (ds, ds_j)):
        within(got, np.asarray(want, dtype=np.float32)
               if got.dtype == torch.float32 else
               np.asarray(want.astype(jnp.float32)))


def rope_inputs(seed, b, s, h, hd, dt, kind):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, hd)).astype(np.float32)
    if kind == "decode":                     # one position a sequence
        pos = np.full((b, 1), 517, dtype=np.int64)
    else:
        pos = np.broadcast_to(np.arange(s) + (3 if kind == "shifted" else 0),
                              (b, s)).astype(np.int64)
    return (as_torch(x, DTYPES[dt][0]), as_torch(dy, DTYPES[dt][0]),
            torch.from_numpy(np.ascontiguousarray(pos)))


ROPE_CASES = [(2, 12, 3, 16, "arange"), (2, 9, 2, 128, "shifted"),
              (3, 1, 4, 64, "decode"), (1, 33, 2, 80, "arange"),
              (2, 7, 3, 18, "shifted")]


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hd,kind", ROPE_CASES)
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_plain_and_its_backward_match_jax_vjp(b, s, h, hd, kind, dt,
                                                   theta):
    x, dy, pos = rope_inputs(b + s + hd, b, s, h, hd, dt, kind)
    jpos = jnp.asarray(pos.numpy())
    y_ref, vjp = jax.vjp(lambda a: JC.apply_rope(a, jpos, theta), upcast(x))
    (dx_ref,) = vjp(upcast(dy))
    y = TC.apply_rope(x, pos, theta)
    assert y.dtype == x.dtype
    within(y, y_ref)
    dx = K.rope_bwd_plain(dy, pos, theta)
    assert dx.dtype == dy.dtype
    within(dx, dx_ref)


def test_apply_rope_qk_is_apply_rope_of_each():
    q, _, pos = rope_inputs(1, 2, 6, 4, 32, "float32", "arange")
    k, _, _ = rope_inputs(2, 2, 6, 2, 32, "float32", "arange")
    got = TC.apply_rope_qk(q, k, pos, 1e4)
    for g, x in zip(got, (q, k)):
        assert torch.equal(g, TC.apply_rope(x, pos, 1e4))


def test_rope_backward_is_the_plain_autograd():
    """``rope_bwd_plain`` is autograd's backward of the plain rotation
    (the parent's path) to the bit, in f32 and bf16."""
    for dt in ("float32", "bfloat16"):
        x, dy, pos = rope_inputs(3, 2, 5, 3, 64, dt, "shifted")
        x = x.requires_grad_()
        (want,) = torch.autograd.grad(TC.apply_rope_plain(x, pos, 1e4), x,
                                      dy)
        assert torch.equal(K.rope_bwd_plain(dy, pos, 1e4), want)


# ---------------------------------------------------------------------------
# (b) the order of dscale's sums
# ---------------------------------------------------------------------------


def emulate_dscale(contrib: np.ndarray, vec: bool) -> np.ndarray:
    """dscale's f32 sums of ``contrib`` (rows x n, each row's dy x r) in
    the kernels' order: each chunk of ``rows_per_chunk`` rows, a block,
    its row slots (slot s: rows first + s, first + s + slots, ...) each
    summed in row order, the slots in order; then each column's chunk
    partials as ``DSCALE_SPLIT`` strided runs in chunk order, the runs in
    order."""
    rows, n = contrib.shape
    p = K.plan(rows, n, vec)
    slots, per, chunks = p["slots"], p["rows_per_chunk"], p["chunks"]
    partials = np.zeros((chunks, n), np.float32)
    for c in range(chunks):
        first, end = c * per, min((c + 1) * per, rows)
        acc = np.zeros((slots, n), np.float32)
        for base in range(first, end, slots):
            for s in range(slots):
                if base + s < end:
                    acc[s] = acc[s] + contrib[base + s]
        part = acc[0]
        for s in range(1, slots):
            part = part + acc[s]
        partials[c] = part
    runs = np.zeros((K.DSCALE_SPLIT, n), np.float32)
    for k in range(K.DSCALE_SPLIT):
        for c in range(k, chunks, K.DSCALE_SPLIT):
            runs[k] = runs[k] + partials[c]
    total = runs[0]
    for k in range(1, K.DSCALE_SPLIT):
        total = total + runs[k]
    return total


@pytest.mark.parametrize("rows,n,vec", [(4096, 4096, True), (5, 768, True),
                                        (1000, 128, True), (530, 83, False),
                                        (300, 8192, False),
                                        (600, 12288, True),
                                        (40, 12289, False)])
def test_emulated_dscale_is_within_1e6_of_an_f64_sum(rows, n, vec):
    rng = np.random.default_rng(rows + n)
    contrib = rng.standard_normal((rows, n)).astype(np.float32)
    got = emulate_dscale(contrib, vec)
    want = contrib.astype(np.float64).sum(axis=0)
    mag = np.abs(contrib.astype(np.float64)).sum(axis=0)
    assert (np.abs(got - want) <= 1e-6 * mag).all()
    assert np.array_equal(emulate_dscale(contrib, vec).view(np.int32),
                          got.view(np.int32))


def test_plan():
    # codeqwen's d_model in bf16: 512 groups of 8, 4 a thread of 128
    assert K.plan(4096, 4096, True) == {"threads_per_row": 128, "passes": 1,
                                        "slots": 2, "rows_per_chunk": 16,
                                        "chunks": 256}
    assert K.plan(4096, 128, True)["threads_per_row"] == 32
    assert K.plan(4096, 128, True)["slots"] == 8
    assert K.plan(5, 8192, True)["threads_per_row"] == 256
    assert K.plan(5, 8192, False) == {"threads_per_row": 256, "passes": 1,
                                      "slots": 1, "rows_per_chunk": 1,
                                      "chunks": 5}
    assert K.plan(7, 83, False)["threads_per_row"] == 32
    assert K.plan(264 * 3 + 1, 64, True)["chunks"] == 199
    # command-r-plus's d_model: 1,536 groups, 6 a thread of 256 in two
    # passes of 4, a row a block; unaligned, two passes of 32 elements
    assert K.plan(4096, 12288, True) == {"threads_per_row": 256,
                                         "passes": 2, "slots": 1,
                                         "rows_per_chunk": 16,
                                         "chunks": 256}
    assert K.plan(3, 12288, False)["passes"] == 2
    assert K.plan(3, 8200, True)["passes"] == 2
    assert K.plan(3, 8192, True)["passes"] == 1


# the backward's route at chip_smoke.py's cases: the staged route where
# the rows may be copied in 16-byte pieces, a row takes one pass and the
# ring holds two stages or more; these take the register route (unaligned,
# n % 8 != 0, a z row stride not a multiple of 16 bytes, rows in passes,
# f32 rows whose stage of every slot's staged inputs passes half the ring)
REGISTER_ROUTE_CASES = {
    ("norm", "mamba2_gated_f32"), ("norm", "command_r_12288"),
    ("norm", "command_r_decode_12288_f32"), ("norm", "odd_17_f32"),
    ("norm", "odd_83_bf16"), ("norm", "unaligned_4096_bf16"),
    ("norm", "unaligned_8192_f32"), ("norm", "unaligned_12288_bf16"),
    ("norm", "odd_12289_f32"),
    ("add", "whisper_enc_1280"), ("add", "lm100m_f32"),
    ("add", "command_r_12288"), ("add", "wide_12288_f32_bias"),
    ("add", "unaligned_4096_bf16"), ("add", "odd_83_bf16"),
    ("add", "odd_12289_f32"),
    ("gate", "f32_f32"), ("gate", "odd_stride_bf16"),
    ("gate", "wide_12288_bf16"), ("gate", "unaligned_4096_bf16")}


def _bwd_cases():
    """(kind, chip_smoke case) of every norm, add norm and gated norm case
    of ``chip_smoke.py``."""
    cs = _chip_smoke()
    return ([("norm", c) for c in cs.NR_NORM_CASES]
            + [("add", c) for c in cs.NR_ADD_CASES]
            + [("gate", c) for c in cs.NR_GATE_CASES])


def _case_plan(kind, case):
    """The backward plan of a chip_smoke case, as ``backward_route`` sees
    its tensors (an unaligned case's rows one element past a 16-byte
    boundary; the gated norm's z by the projection's row stride)."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}
    if kind == "gate":
        _, shape, width, x_dt, _, unaligned = case
        stride = width * (4 if x_dt == "f32" else 2)
    else:
        _, shape, x_dt, _, *rest = case
        unaligned, stride = rest[-1], 16
    n = shape[-1]
    rows = int(np.prod(shape[:-1]))
    vec = n % K.VEC == 0 and stride % 16 == 0 and not unaligned
    pro = {"norm": "", "add": "add", "gate": "gate"}[kind]
    return K.bwd_plan(rows, n, vec, dt[x_dt], pro), rows, n


@pytest.mark.parametrize("kind,case", _bwd_cases(),
                         ids=lambda v: v if isinstance(v, str) else v[0])
def test_bwd_plan_takes_every_row_once_on_the_stated_route(kind, case):
    """The backward's row assignment at each case of chip_smoke.py, as
    both routes run it: chunks of ``rows_per_chunk`` contiguous rows in
    order, a block each; its slots take rows first + slot, first + slot +
    slots, ... in ``ceil(chunk / slots)`` iterations, every row once.  The
    staged route holds 2 to ``MAX_STAGES`` stages in ``RING_BYTES`` (two
    blocks an SM fit its 228 KB), and its ring takes the slots' partial
    rows at the end; the route is the one the shape and alignment state
    (``REGISTER_ROUTE_CASES``)."""
    p, rows, n = _case_plan(kind, case)
    per, chunks, slots = p["rows_per_chunk"], p["chunks"], p["slots"]
    assert chunks <= K.BWD_BLOCKS and (chunks - 1) * per < rows <= \
        chunks * per
    taken = []
    for block in range(chunks):
        first, end = block * per, min((block + 1) * per, rows)
        iters = -(-(end - first) // slots)
        for it in range(iters):
            for slot in range(slots):
                row = first + it * slots + slot
                if row < end:
                    taken.append((block, row))
    assert [r for _, r in taken] == sorted(r for _, r in taken)
    assert sorted(r for _, r in taken) == list(range(rows))
    for block in range(chunks):
        mine = [r for b, r in taken if b == block]
        assert mine == list(range(block * per, block * per + len(mine)))
    staged = (kind, case[0]) not in REGISTER_ROUTE_CASES
    assert p["route"] == ("staged" if staged else "regs")
    if staged:
        inputs = K.STAGED_INPUTS[{"norm": "", "add": "add",
                                  "gate": "gate"}[kind]]
        stage = slots * n * (4 if case[2 if kind != "gate" else 3] == "f32"
                             else 2) * inputs
        assert 2 <= p["stages"] <= K.MAX_STAGES
        # the add and gated norms' weights in f32 past the stages
        w_bytes = 4 * n if kind != "norm" else 0
        assert p["ring_bytes"] == p["stages"] * stage + w_bytes <= \
            K.RING_BYTES
        # two blocks' rings, their mbarriers' 128 bytes, 1 KB reserved
        assert 2 * (K.RING_BYTES + 128 + 1024) <= 228 * 1024
        parts = 2 if kind == "add" and case[4] is not None else 1
        assert slots == 1 or 4 * n * parts <= p["ring_bytes"]
        assert p["passes"] == 1 and n % K.VEC == 0
    else:
        assert (p["stages"], p["ring_bytes"]) == (0, 0)


def test_backward_route_reads_the_alignment():
    """``backward_route`` on tensors: aligned rows of a width the ring
    takes on the staged route, the same rows one element off a 16-byte
    boundary, a z row stride not a multiple of 16 bytes, and the
    ``FORCE_REGS_DEFINES`` build on the register route."""
    base = torch.zeros(2 * 4096 + 8, dtype=torch.bfloat16)
    x, scale = base[:2 * 4096].view(2, 4096), torch.zeros(4096)
    assert x.data_ptr() % 16 == 0
    assert K.backward_route("", x, scale) == "staged_bf16_f32"
    assert K.backward_route("", x, scale, force_regs=True) == "bf16_f32"
    off = base[1:1 + 2 * 4096].view(2, 4096)
    assert K.backward_route("", off, scale) == "bf16_f32"
    assert K.backward_route("add", x, scale, (off,)) == "add_bf16_f32"
    assert K.backward_route("gate", x, scale, (), 8512 * 2) == \
        "staged_gate_bf16_f32"
    assert K.backward_route("gate", x, scale, (), 101 * 2) == "gate_bf16_f32"
    # a width of several passes, an odd width
    wide = torch.zeros(1, 12288, dtype=torch.bfloat16)
    assert K.backward_route("", wide, torch.zeros(12288)) == "bf16_f32"
    odd = torch.zeros(3, 83)
    assert K.backward_route("", odd, torch.zeros(83)) == "f32_f32"


# ---------------------------------------------------------------------------
# (c) the dispatch
# ---------------------------------------------------------------------------


def _stand_in(device, placements=None):
    return SimpleNamespace(device=torch.device(device),
                           placements=placements)


def test_takes_kernel_by_device():
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert K.takes_kernel([cpu, meta]) is False
    assert K.takes_kernel([_stand_in("cuda"), _stand_in("cuda")]) is True
    for device in ("cpu", "meta"):                 # DTensors
        assert K.takes_kernel([_stand_in(device, placements=("Shard(0)",)),
                               cpu]) is False
    with pytest.raises(ValueError, match="DTensor on CUDA"):
        K.takes_kernel([_stand_in("cuda", placements=("Shard(0)",))])
    with pytest.raises(ValueError, match="device xpu"):
        K.takes_kernel([_stand_in("xpu")])
    with pytest.raises(ValueError, match="mix"):
        K.takes_kernel([cpu, _stand_in("cuda")])


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel launch on plain tensors")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_versions(device, monkeypatch):
    for name in ("rms_norm_fwd", "rms_norm_bwd", "rope"):
        monkeypatch.setattr(K, name, _refuse)
    for fn in (K.RMSNorm, K.Rope):
        monkeypatch.setattr(fn, "apply", _refuse)
    x = torch.ones((2, 3, 4, 8), device=device, requires_grad=True)
    scale = torch.zeros(8, device=device, requires_grad=True)
    pos = torch.arange(3, device=device).expand(2, 3)
    y = TC.rms_norm(x, scale)
    q, k = TC.apply_rope_qk(y, y, pos, 1e4)
    r = TC.apply_rope(y, pos, 1e4)
    assert {t.device.type for t in (y, q, k, r)} == {device}
    if device == "cpu":
        (q.sum() + k.sum() + r.sum()).backward()
        assert x.grad.shape == x.shape and scale.grad.shape == scale.shape


def test_launch_functions_refuse_cpu_tensors():
    x, s, dy = norm_inputs(0, (2, 16), "float32", "float32")
    with pytest.raises(ValueError, match="CUDA"):
        K.rms_norm_fwd(x, s)
    with pytest.raises(ValueError, match="CUDA"):
        K.rms_norm_bwd(x, s, dy)
    q, _, pos = rope_inputs(0, 1, 4, 2, 16, "float32", "arange")
    with pytest.raises(ValueError, match="CUDA"):
        K.rope([q], pos, TC.rope_freqs(16, 1e4))


def test_routes():
    assert K.norm_route(torch.bfloat16, torch.bfloat16) == "bf16_bf16"
    assert K.norm_route(torch.float32, torch.bfloat16) == "f32_bf16"
    assert K.rope_route(torch.bfloat16) == "forward_bf16"
    assert K.rope_route(torch.float32, backward=True) == "backward_f32"
    with pytest.raises(ValueError, match="float16"):
        K.norm_route(torch.float16, torch.float32)
    assert K.NORM_ROUTES.index("bf16_f32") == 2      # (x bf16) * 2 + (s)
    assert K.ROPE_ROUTES.index("backward_bf16") == 3  # backward * 2 + bf16
    # the backward's staged route: C counter 12 + its register route's
    assert K.KERNEL_ROUTES["rms_norm_bwd"] == K.BWD_ROUTES
    assert K.BWD_ROUTES[:12] == K.NORM_ROUTES
    assert K.BWD_ROUTES.index("staged_add_bf16_f32") == 12 + 4 + 2
    assert K.bwd_route(torch.bfloat16, torch.bfloat16, "gate", True) == \
        "staged_gate_bf16_bf16"
    assert K.bwd_route(torch.float32, torch.float32) == "f32_f32"
    assert K.dscale_route("staged_gate_f32_bf16") == "gate_f32_bf16"
    with pytest.raises(ValueError):
        K.dscale_route("staged_rope")


def test_host_launches_count_both_backward_routes_dscale(monkeypatch):
    """A backward's dscale launch is counted on its instance, whichever
    route its rows took."""
    monkeypatch.setattr(K.rms_norm_bwd, "launches_by_route",
                        dict.fromkeys(K.BWD_ROUTES, 0))
    K.rms_norm_bwd.launches_by_route["staged_add_bf16_bf16"] = 3
    K.rms_norm_bwd.launches_by_route["add_bf16_bf16"] = 2
    K.rms_norm_bwd.launches_by_route["staged_f32_f32"] = 1
    got = K.host_launches()
    assert got["rms_norm_dscale"]["add_bf16_bf16"] == 5
    assert got["rms_norm_dscale"]["f32_f32"] == 1
    assert got["rms_norm_bwd"]["staged_add_bf16_bf16"] == 3


# ---------------------------------------------------------------------------
# (d) the autograd functions, their launches emulated on the CPU
# ---------------------------------------------------------------------------


def _rotate(xs, positions, freqs, backward):
    cos, sin = K.rope_cos_sin(positions, freqs)
    sin = -sin if backward else sin
    out = []
    for x in xs:
        x1, x2 = x.float().chunk(2, dim=-1)
        out.append(torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                             dim=-1).to(x.dtype))
    return tuple(out)


@pytest.fixture
def emulated(monkeypatch):
    """CPU tensors take ``RMSNorm`` and ``Rope``, whose launches run the
    plain formulas here and count themselves (by kernel: the norm's
    backward counts its dscale kernel too)."""
    counts = dict.fromkeys(("rms_norm_fwd", "rms_norm_bwd",
                            "rms_norm_dscale", "rope_forward",
                            "rope_backward"), 0)
    lock = threading.Lock()

    def count(*names):
        with lock:
            for n in names:
                counts[n] += 1

    def fwd(x, scale, eps=1e-6):
        count("rms_norm_fwd")
        return TC.rms_norm_plain(x, scale, eps)

    def bwd(x, scale, dy, eps=1e-6):
        count("rms_norm_bwd", "rms_norm_dscale")
        return K.rms_norm_bwd_plain(x, scale, dy, eps)

    def rope(xs, positions, freqs, *, backward=False):
        count("rope_backward" if backward else "rope_forward")
        return _rotate(xs, positions, freqs, backward)
    monkeypatch.setattr(K, "takes_kernel",
                        lambda ts: all(t.device.type == "cpu" for t in ts))
    monkeypatch.setattr(K, "rms_norm_fwd", fwd)
    monkeypatch.setattr(K, "rms_norm_bwd", bwd)
    monkeypatch.setattr(K, "rope", rope)
    return counts


def _loss_and_grads(arch, remat):
    """The JAX package's value_and_grad of ``forward_train`` and the
    port's loss and grads from the same params and batch."""
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    batch = synthetic_batch(5, 0, 0, 2, 16, tcfg.vocab_size)
    jloss, jgrads = jax.value_and_grad(
        lambda p: JM.forward_train(p, jcfg, {k: jnp.asarray(v) for k, v
                                             in batch.items()},
                                   remat=remat)[0])(jparams)
    tloss, tgrads = _grads(lambda p, mb: TM.forward_train(
        p, tcfg, mb, remat=remat)[0], tparams,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return (float(jloss), jgrads), (float(tloss), tgrads)


def _assert_same_loss_and_grads(jax_side, port_side):
    (jloss, jgrads), (tloss, tgrads) = jax_side, port_side
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    jl, tl = jax.tree.leaves(jgrads), jax.tree.leaves(tgrads)
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        within(t, np.asarray(j, dtype=np.float32))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["codeqwen15_7b", "chameleon_34b"])
def test_forward_train_grads_match_jax(arch, remat):
    _assert_same_loss_and_grads(*_loss_and_grads(arch, remat))


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ["codeqwen15_7b", "chameleon_34b"])
def test_forward_train_grads_through_the_functions_match_jax(
        arch, remat, emulated):
    _assert_same_loss_and_grads(*_loss_and_grads(arch, remat))
    cfg = get_smoke_config(arch)
    c = _chip_smoke().norm_rope_calls(cfg, "forward")
    forwards = 2 if remat else 1
    assert emulated == {
        "rms_norm_fwd": c["layer_norms"] * forwards + c["outer_norms"],
        "rms_norm_bwd": c["layer_norms"] + c["outer_norms"],
        "rms_norm_dscale": c["layer_norms"] + c["outer_norms"],
        "rope_forward": c["ropes"] * forwards,
        "rope_backward": c["ropes"]}


def test_functions_give_the_plain_autograd(emulated):
    """``RMSNorm`` and ``Rope`` (their launches emulated) give what
    autograd on the plain ops gives: the outputs and RoPE's grads to the
    bit, the norm's grads within the tolerance (the backward formula
    orders its sums its own way), with one forward and one backward launch
    a call (q and k together)."""
    x, s, dy = norm_inputs(4, (3, 5, 32), "bfloat16", "bfloat16")
    q, dq, pos = rope_inputs(5, 3, 5, 4, 32, "bfloat16", "shifted")
    k, dk, _ = rope_inputs(6, 3, 5, 2, 32, "bfloat16", "shifted")
    got, want = [], []
    for route, out in ((True, got), (False, want)):
        leaves = [t.clone().requires_grad_() for t in (x, s, q, k)]
        if route:
            y = TC.rms_norm(leaves[0], leaves[1])
            rq, rk = TC.apply_rope_qk(leaves[2], leaves[3], pos, 1e4)
        else:
            y = TC.rms_norm_plain(leaves[0], leaves[1])
            rq, rk = (TC.apply_rope_plain(t, pos, 1e4) for t in leaves[2:])
        torch.autograd.backward((y, rq, rk), (dy, dq, dk))
        out += [y, rq, rk] + [t.grad for t in leaves]
    for i, (g, w) in enumerate(zip(got, want)):
        if i in (3, 4):                             # the norm's dx, dscale
            within(g, w.float().numpy())
        else:
            assert torch.equal(g, w)
    assert emulated == {"rms_norm_fwd": 1, "rms_norm_bwd": 1,
                        "rms_norm_dscale": 1, "rope_forward": 1,
                        "rope_backward": 1}


@pytest.mark.parametrize("kw", [dict(), dict(num_microbatches=2),
                                dict(remat=False)])
def test_train_step_launches_are_chip_smokes(kw, emulated):
    """One train step of ``tiny`` through the functions launches what
    ``chip_smoke.expected_norm_rope_launches`` counts a step."""
    cs = _chip_smoke()
    cfg = PRESETS["tiny"]
    state = train_state_init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    step = make_train_step(cfg, warmup_steps=1, **kw)
    batch = {k: torch.from_numpy(v) for k, v in
             synthetic_batch(5, 0, 0, 4, 32, cfg.vocab_size).items()}
    step(state, batch)
    c = cs.norm_rope_calls(cfg, "forward")
    n, forwards = kw.get("num_microbatches", 1), 1 if "remat" in kw else 2
    assert emulated == {
        "rms_norm_fwd": n * (c["layer_norms"] * forwards + c["outer_norms"]),
        "rms_norm_bwd": n * (c["layer_norms"] + c["outer_norms"]),
        "rms_norm_dscale": n * (c["layer_norms"] + c["outer_norms"]),
        "rope_forward": n * c["ropes"] * forwards,
        "rope_backward": n * c["ropes"]}


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "mamba2_1_3b",
                                  "zamba2_2_7b", "granite_moe_3b_a800m",
                                  "whisper_large_v3", "gemma2_27b",
                                  "nemotron_4_15b", "chameleon_34b"])
def test_serve_launches_are_chip_smokes(arch, emulated):
    """A serve run of each path's smoke config through the functions
    launches what ``chip_smoke.expected_norm_rope_serve`` counts on the
    device (on the CPU every decode step runs eagerly, as the card's
    replays run)."""
    from repro_torch.launch.serve import run_serving
    cs = _chip_smoke()
    assert arch in cs.PATHS
    cfg = get_smoke_config(arch)
    shape = dict(num_requests=4, microbatch=2, decode_steps=4,
                 prompt_len=cfg.local_window + 4 if cfg.local_window else 12)
    run_serving(cfg, device="cpu", **shape)
    want = cs.expected_norm_rope_serve(cfg, 2, shape["decode_steps"])
    assert emulated == {
        "rms_norm_fwd": want["rms_norm_fwd"]["device"],
        "rms_norm_bwd": 0, "rms_norm_dscale": 0,
        "rope_forward": want["rope"]["device"], "rope_backward": 0}


# ---------------------------------------------------------------------------
# (e) the build and chip_smoke.py's counts
# ---------------------------------------------------------------------------


def test_build_lists_the_source():
    assert "norm_rope" in _build.KERNEL_SOURCES
    assert (_build.CSRC / "norm_rope.cu").exists()


def test_launch_constants_are_the_sources():
    src = (_build.CSRC / "norm_rope.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))
    assert (const("kBlock"), const("kVec"), const("kItems"),
            const("kScalarItems"), const("kBwdBlocks"),
            const("kDscaleSplit")) == (K.THREADS, K.VEC, K.ITEMS,
                                       K.SCALAR_ITEMS, K.BWD_BLOCKS,
                                       K.DSCALE_SPLIT)
    # the staged route's ring, its stages, its staged inputs and counters
    assert "constexpr int kRingBytes = 112 * 1024;" in src
    assert K.RING_BYTES == 112 * 1024
    assert const("kMaxStages") == K.MAX_STAGES
    assert const("kStagedRoutes") == len(K.NORM_ROUTES)
    assert const("kCounters") >= len(K.BWD_ROUTES)
    assert "return kPro == kNone ? 2 : 3;" in src
    assert (K.STAGED_INPUTS[""], K.STAGED_INPUTS["add"],
            K.STAGED_INPUTS["gate"]) == (2, 3, 3)
    assert "#ifdef NORM_BWD_FORCE_REGS" in src
    assert K.FORCE_REGS_DEFINES == ("NORM_BWD_FORCE_REGS",)
    # the C entry points' names are the wrapper's
    for name in ("rms_norm_fwd", "rms_norm_bwd", "rope",
                 "norm_rope_launches", "rms_norm_bwd_plan"):
        assert re.search(rf'extern "C" \w+(?: \w+)* {name}\(', src), name


def _routes(routes, **by_route):
    return {**dict.fromkeys(routes, 0), **by_route}


# train: tiny (2 layers, f32, 2 norms a layer + the final) 4 steps each of
# 1, 2 and 1 microbatches and 8 of 2 (the bits check) with remat: 32
# passes; lm100m (12 layers) 307 steps without remat; codeqwen1.5-7b (bf16)
# at 16 layers the graph's and the eager columns' 10 timed and profiled
# steps, the plain gate and loss column's 4, the FLOP-counted one and step
# 1's plain-attention grads (16 fused passes), the parent column's 4 timed
# and profiled steps on the unfused norms and rotations (all remat), and
# forward_train's loss (one forward,
# no backward); at 2 layers 10 steps with and 2 without remat; examples:
# lm20m (6 layers) x 200 steps.  A fused pass's mlp norms take the add
# prologue (one a layer), tiny's and codeqwen's rotations their q and k
# biases (the dscale kernel sums their grads); the parent's run none of
# them.  The backward's rows run on the staged route but lm100m's add
# norms' (f32 at 768: a stage of 8 rows x 3 inputs, 72 KB, does not fit
# the ring twice), which keep the register route.
FULL, BITS = 12, 10
# The other families (bf16, remat): FULL passes at full width (the 8
# timed and 2 profiled steps, the FLOP-counted one and step 1's grads),
# forward_train's loss (one forward) and BITS passes at the bits check's
# depth (4 eager, 4 through the graph, one profiled and step 1's
# grads).  Norms a pass: mamba2 a
# plain and a gated norm a layer (48; 2) and the final norm; zamba2 the
# same (54; 6), its Mamba layers' 3 forwards (nested checkpoints), and the
# shared block's attn and add mlp norm and rotation a call (9; 1);
# granite an attn and an add norm and a rotation a layer (32; 2); whisper
# (bf16 frames) the decoder's attn, add cross and add mlp norms and the
# encoder's attn and add mlp norms a layer (32; 2), the final and the
# encoder's norms; chameleon the attn, q and k norms, the add mlp norm
# and a rotation a layer (4; 2), its 8,192-wide add norms' backward on the
# register route (two stages do not fit beside the weights)
FAMILY_FWD = {
    "bf16_bf16": (FULL * 97 + 49 + BITS * 5)                     # mamba2
    + (FULL * (54 * 3 + 9 * 2 + 1) + 64 + BITS * 21)             # zamba2
    + (FULL * 65 + 33 + BITS * 5)                                # granite
    + (FULL * 130 + 66 + BITS * 10)                              # whisper
    + (FULL * 25 + 13 + BITS * 13),                              # chameleon
    "add_bf16_bf16": (FULL * 18 + 9 + BITS * 2) + (FULL * 64 + 32 + BITS * 4)
    + (FULL * 192 + 96 + BITS * 12) + (FULL * 8 + 4 + BITS * 4),
    "gate_bf16_bf16": (FULL * 96 + 48 + BITS * 4)
    + (FULL * 162 + 54 + BITS * 18)}
FAMILY_BWD = {
    "bf16_bf16": (FULL * 49 + BITS * 3) + (FULL * 64 + BITS * 8)
    + (FULL * 33 + BITS * 3) + (FULL * 66 + BITS * 6) + (FULL * 13 + BITS * 7),
    "add_bf16_bf16": (FULL * 9 + BITS) + (FULL * 32 + BITS * 2)
    + (FULL * 96 + BITS * 6),
    "add_bf16_bf16 registers": FULL * 4 + BITS * 2,              # chameleon
    "gate_bf16_bf16": (FULL * 48 + BITS * 2) + (FULL * 54 + BITS * 6)}
# and each family's step 1 on the kernels in f32 (one pass, remat): the
# same norms on the f32 routes, the backward of mamba2's 2,048-wide and
# chameleon's 8,192-wide f32 rows, the gated rows and the add norms' on the
# register route (two f32 stages do not fit beside the weights)
FAMILY_F32_FWD = {"f32_f32": 97 + 181 + 65 + 130 + 25,
                  "add_f32_f32": 18 + 64 + 192 + 8, "gate_f32_f32": 96 + 162}
FAMILY_F32_BWD = {"f32_f32": 49 + 5, "staged_f32_f32": 64 + 33 + 66 + 8,
                  "add_f32_f32": 9 + 32 + 96 + 4, "gate_f32_f32": 48 + 54}
FAMILY_ROPE = {
    "forward_bf16": (FULL * 18 + 9 + BITS * 2) + (FULL * 64 + 32 + BITS * 4)
    + (FULL * 8 + 4 + BITS * 4),
    "backward_bf16": (FULL * 9 + BITS) + (FULL * 32 + BITS * 2)
    + (FULL * 4 + BITS * 2)}
EXPECTED_NORM_ROPE = {
    "train": {
        "rms_norm_fwd": _routes(
            K.NORM_ROUTES, f32_f32=32 * 5 + 307 * 13
            + FAMILY_F32_FWD["f32_f32"],
            add_f32_f32=32 * 4 + 307 * 12 + FAMILY_F32_FWD["add_f32_f32"],
            gate_f32_f32=FAMILY_F32_FWD["gate_f32_f32"],
            bf16_bf16=16 * 33 + 4 * 65 + 17 + 10 * 5 + 2 * 3
            + FAMILY_FWD["bf16_bf16"],
            add_bf16_bf16=16 * 32 + 16 + 10 * 4 + 2 * 2
            + FAMILY_FWD["add_bf16_bf16"],
            gate_bf16_bf16=FAMILY_FWD["gate_bf16_bf16"]),
        "rms_norm_bwd": _routes(
            K.BWD_ROUTES, staged_f32_f32=32 * 3 + 307 * 13
            + FAMILY_F32_BWD["staged_f32_f32"],
            staged_add_f32_f32=32 * 2,
            add_f32_f32=307 * 12 + FAMILY_F32_BWD["add_f32_f32"],
            f32_f32=FAMILY_F32_BWD["f32_f32"],
            gate_f32_f32=FAMILY_F32_BWD["gate_f32_f32"],
            staged_bf16_bf16=16 * 17 + 4 * 33 + 12 * 3
            + FAMILY_BWD["bf16_bf16"],
            staged_add_bf16_bf16=16 * 16 + 12 * 2
            + FAMILY_BWD["add_bf16_bf16"],
            add_bf16_bf16=FAMILY_BWD["add_bf16_bf16 registers"],
            staged_gate_bf16_bf16=FAMILY_BWD["gate_bf16_bf16"]),
        "rms_norm_dscale": _routes(
            K.DSCALE_ROUTES, f32_f32=32 * 3 + 307 * 13
            + FAMILY_F32_BWD["f32_f32"] + FAMILY_F32_BWD["staged_f32_f32"],
            add_f32_f32=32 * 2 + 307 * 12 + FAMILY_F32_BWD["add_f32_f32"],
            gate_f32_f32=FAMILY_F32_BWD["gate_f32_f32"],
            bf16_bf16=16 * 17 + 4 * 33 + 12 * 3 + FAMILY_BWD["bf16_bf16"],
            add_bf16_bf16=16 * 16 + 12 * 2 + FAMILY_BWD["add_bf16_bf16"]
            + FAMILY_BWD["add_bf16_bf16 registers"],
            gate_bf16_bf16=FAMILY_BWD["gate_bf16_bf16"],
            rope_bias_f32=32 * 2,
            rope_bias_bf16=16 * 16 + 10 * 2 + 2 * 2),
        "rope": _routes(K.ROPE_ROUTES, forward_f32=307 * 12 + 18 + 64 + 8,
                        backward_f32=307 * 12 + 9 + 32 + 4,
                        bias_forward_f32=32 * 4,
                        bias_backward_f32=32 * 2,
                        forward_bf16=4 * 32 + FAMILY_ROPE["forward_bf16"],
                        backward_bf16=4 * 16 + FAMILY_ROPE["backward_bf16"],
                        bias_forward_bf16=16 * 32 + 16 + 10 * 4 + 2 * 2,
                        bias_backward_bf16=16 * 16 + 10 * 2 + 2 * 2)},
    "examples": {
        "rms_norm_fwd": _routes(K.NORM_ROUTES, f32_f32=200 * 7,
                                add_f32_f32=200 * 6),
        "rms_norm_bwd": _routes(K.BWD_ROUTES, staged_f32_f32=200 * 7,
                                staged_add_f32_f32=200 * 6),
        "rms_norm_dscale": _routes(K.DSCALE_ROUTES, f32_f32=200 * 7,
                                   add_f32_f32=200 * 6),
        "rope": _routes(K.ROPE_ROUTES, forward_f32=200 * 6,
                        backward_f32=200 * 6)},
    "dryrun": {
        "rms_norm_fwd": _routes(K.NORM_ROUTES),
        "rms_norm_bwd": _routes(K.BWD_ROUTES),
        "rms_norm_dscale": _routes(K.DSCALE_ROUTES),
        "rope": _routes(K.ROPE_ROUTES)},
}


@pytest.mark.parametrize("phase", sorted(EXPECTED_NORM_ROPE))
def test_chip_smoke_expected_norm_rope_launches(phase):
    cs = _chip_smoke()
    assert cs.expected_norm_rope_launches(K, phase) == \
        EXPECTED_NORM_ROPE[phase]


def test_chip_smoke_window_checks_host_and_device(monkeypatch):
    """``norm_rope_window``'s check: totals on the host and the device for
    a serve run (replays count on the device only), by route for the
    others; it fails on a miscount."""
    cs = _chip_smoke()
    zero = {k: dict.fromkeys(K.KERNEL_ROUTES[k], 0) for k in K.KERNELS}
    device = {k: dict(v) for k, v in zero.items()}
    monkeypatch.setattr(K, "_lib", lambda: None)
    monkeypatch.setattr(K, "kernel_launches",
                        lambda lib: {k: dict(v) for k, v in device.items()})
    serve = {"rms_norm_fwd": {"host": 3, "device": 7},
             "rope": {"host": 1, "device": 2},
             "rms_norm_bwd": {"host": 0, "device": 0},
             "rms_norm_dscale": {"host": 0, "device": 0}}
    check = cs.norm_rope_window(K)
    K.rms_norm_fwd.launches_by_route["bf16_bf16"] = 3
    K.rope.launches_by_route["forward_bf16"] = 1
    device["rms_norm_fwd"]["bf16_bf16"] = 7
    device["rope"]["forward_bf16"] = 2
    check("path", serve)
    assert cs.NORM_ROPE_LAUNCHES["path"]["device"]["rope"][
        "forward_bf16"] == 2
    device["rope"]["forward_bf16"] = 3
    with pytest.raises(SystemExit):
        check("path", serve)
    device = {k: dict(v) for k, v in zero.items()}
    check = cs.norm_rope_window(K)
    want = {k: dict(v) for k, v in zero.items()}
    want["rms_norm_fwd"]["f32_f32"] = 2
    K.rms_norm_fwd.launches_by_route["f32_f32"] = 2
    device["rms_norm_fwd"]["f32_f32"] = 2
    check("phase", want)
    K.rms_norm_fwd.launches_by_route["f32_f32"] = 1
    with pytest.raises(SystemExit):
        check("phase", want)
    K.rms_norm_fwd.launches_by_route["f32_f32"] = 0


def test_chip_smoke_profile_names_every_norm_rope_kernel():
    cs = _chip_smoke()
    src = (_build.CSRC / "norm_rope.cu").read_text()
    names = set(re.findall(r"\b(\w+_kernel)\(", src))
    assert names == {"rms_norm_fwd_kernel", "rms_norm_bwd_kernel",
                     "rms_norm_bwd_staged_kernel", "rms_norm_dscale_kernel",
                     "rope_kernel"}
    for name in names:
        parts = [p for k, p in cs.NAMED_KERNEL_PARTS.items() if k in name]
        assert parts == ["norm_rope_kernels"], name

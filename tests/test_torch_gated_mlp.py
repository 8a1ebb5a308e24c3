"""The gated MLP's activation: ``kernels/gated_mlp.py`` and its plain
version.

The CUDA kernels (``csrc/gated_mlp.cu``) run only on the card, where
``chip_smoke.py`` holds them to the plain version.  Here, on the CPU, with
inputs made from a seed with numpy:

(a) the plain forward (``gated_act_plain``) and its written-out backward
    (``gated_act_bwd_plain``) against ``gate(h) * g`` of the JAX package
    (``jax.nn.silu`` for swiglu, ``jax.nn.gelu``, the tanh form, for
    geglu) and its ``jax.vjp``, on f32 upcasts of the same values: an f32
    result within 1e-6 x (|ref| + max|ref|) (1e-6 relative, and as much of
    the scale where gelu-tanh's derivative saturates: 1 - tanh^2 cancels,
    and torch's closed form and JAX's chain rule differ there by up to
    ~3e-6 of the element), a bf16 one within 2 x 2^-8 |ref| + 1e-5 x
    max|ref| (``tests/test_torch_norm_rope.py``'s bf16 rule, 2^-8 |ref| a
    rounding, for the two roundings of the bf16 route: act(a), then the
    product; and dy * b, then act's backward); widths 64, 33 (odd: the
    kernel's one element a thread) and the MoE experts' (g, e, c, f);
(b) the written-out backward is autograd's over the plain ops, to the bit;
(c) the dispatch: CPU and meta tensors take the plain ops (meta gives the
    shapes), other devices, CUDA DTensors and mixes raise, the launch
    functions refuse CPU tensors, other dtypes and activations and
    unequal shapes;
(d) ``GatedAct`` with its launches emulated on the CPU by the plain
    versions gives autograd's bits and one forward and one backward
    launch a call, and a serve run of every smoke path launches what
    ``chip_smoke.expected_gate_serve`` counts;
(e) the build lists the source and the C entry points are the wrapper's.
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

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import gated_mlp as G  # noqa: E402
from repro_torch.models import common as TC  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 1e-6
BF16_HALF_ULP = 2.0 ** -8
BF16_REL = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = [(2, 5, 64), (3, 7, 33), (2, 3, 4, 24)]
JAX_GATES = {"swiglu": jax.nn.silu, "geglu": jax.nn.gelu}


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
    if got.dtype == torch.bfloat16:
        tol = 2 * BF16_HALF_ULP * np.abs(ref) + BF16_REL * scale
    else:
        tol = F32_TOL * (np.abs(ref) + scale)
    err = np.abs(got_np - ref)
    assert (err <= tol).all(), float((err - tol).max())


def inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    a, b, dy = (3 * rng.standard_normal(shape).astype(np.float32)
                for _ in range(3))
    return tuple(torch.from_numpy(t).to(DTYPES[dtype]) for t in (a, b, dy))


def upcast(t: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(t.float().numpy())


# ---------------------------------------------------------------------------
# (a), (b) the plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("activation", sorted(G.ACTIVATIONS))
def test_plain_and_its_backward_match_jax_vjp(activation, shape, dtype):
    a, b, dy = inputs(len(shape) + 7 * len(activation), shape, dtype)
    gate = JAX_GATES[activation]
    want, vjp = jax.vjp(lambda x, g: gate(x) * g, upcast(a), upcast(b))
    want_da, want_db = vjp(upcast(dy))
    y = G.gated_act_plain(a, b, activation)
    da, db = G.gated_act_bwd_plain(a, b, dy, activation)
    assert y.dtype == da.dtype == db.dtype == DTYPES[dtype]
    within(y, want)
    within(da, want_da)
    within(db, want_db)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("activation", sorted(G.ACTIVATIONS))
def test_written_out_backward_is_autograd(activation, dtype):
    a, b, dy = inputs(3, (4, 9, 33), dtype)
    al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
    G.gated_act_plain(al, bl, activation).backward(dy)
    da, db = G.gated_act_bwd_plain(a, b, dy, activation)
    assert torch.equal(da, al.grad) and torch.equal(db, bl.grad)


def test_gated_act_on_the_cpu_is_the_models_ops():
    a, b, _ = inputs(1, (2, 3, 40), "bfloat16")
    for activation in G.ACTIVATIONS:
        assert torch.equal(TC.gated_act(a, b, activation),
                           TC.activation_fn(activation)(a) * b)


# ---------------------------------------------------------------------------
# (c) the dispatch and the wrappers' refusals
# ---------------------------------------------------------------------------


def _stand_in(device, placements=None):
    return SimpleNamespace(device=torch.device(device),
                           placements=placements)


def test_takes_kernel_by_device():
    cpu, meta = torch.zeros(2), torch.zeros(2, device="meta")
    assert G.takes_kernel([cpu, meta]) is False
    assert G.takes_kernel([_stand_in("cuda"), _stand_in("cuda")]) is True
    for device in ("cpu", "meta"):                 # DTensors
        assert G.takes_kernel([_stand_in(device, placements=("Shard(0)",)),
                               cpu]) is False
    with pytest.raises(ValueError, match="gated_act kernel for a DTensor"):
        G.takes_kernel([_stand_in("cuda", placements=("Shard(0)",))])
    with pytest.raises(ValueError, match="device xpu"):
        G.takes_kernel([_stand_in("xpu")])
    with pytest.raises(ValueError, match="mix"):
        G.takes_kernel([cpu, _stand_in("cuda")])


def _refuse(*args, **kwargs):
    raise AssertionError("a kernel launch on plain tensors")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_cpu_and_meta_take_the_plain_ops(device, monkeypatch):
    for name in ("gated_act_fwd", "gated_act_bwd"):
        monkeypatch.setattr(G, name, _refuse)
    monkeypatch.setattr(G.GatedAct, "apply", _refuse)
    a = torch.ones((2, 3, 4, 8), device=device, requires_grad=True)
    b = torch.ones((2, 3, 4, 8), device=device, requires_grad=True)
    for activation in G.ACTIVATIONS:
        y = TC.gated_act(a, b, activation)
        assert y.shape == a.shape and y.device.type == device
        if device == "cpu":
            y.sum().backward()
    if device == "cpu":
        assert a.grad.shape == a.shape and b.grad.shape == b.shape


def test_launch_functions_refuse_what_the_kernels_do_not_take():
    a, b, dy = inputs(0, (2, 16), "float32")
    with pytest.raises(ValueError, match="CUDA"):
        G.gated_act_fwd(a, b, "swiglu")
    with pytest.raises(ValueError, match="CUDA"):
        G.gated_act_bwd(a, b, dy, "geglu")
    with pytest.raises(ValueError, match="tensors"):
        G.gated_act_fwd(a, b[:, :8], "swiglu")
    with pytest.raises(ValueError, match="tensors"):
        G.gated_act_fwd(a, b.to(torch.bfloat16), "swiglu")
    with pytest.raises(ValueError, match="float16"):
        G.gated_act_fwd(a.half(), b.half(), "swiglu")
    with pytest.raises(ValueError, match="activation 'gelu'"):
        G.gated_act_fwd(a, b, "gelu")


def test_routes():
    assert G.route("swiglu", torch.bfloat16) == "silu_bf16"
    assert G.route("geglu", torch.float32) == "gelu_f32"
    # the C instance: activation * 2 + bf16
    assert G.ROUTES.index("gelu_bf16") == 2 * G.ACTIVATIONS["geglu"] + 1
    assert G.vectorised([torch.zeros(64, dtype=torch.bfloat16)]) == (
        torch.zeros(64, dtype=torch.bfloat16).data_ptr() % 16 == 0)
    assert not G.vectorised([torch.zeros(33)])         # 33 % 4 != 0


# ---------------------------------------------------------------------------
# (d) the autograd function, its launches emulated on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture
def emulated(monkeypatch):
    """CPU tensors take ``GatedAct`` and the forward launch, which run the
    plain versions here and count themselves by route."""
    counts = {"gated_act_fwd": {}, "gated_act_bwd": {}}
    lock = threading.Lock()

    def count(name, a, activation):
        r = G.route(activation, a.dtype)
        with lock:
            counts[name][r] = counts[name].get(r, 0) + 1

    def fwd(a, b, activation):
        count("gated_act_fwd", a, activation)
        return G.gated_act_plain(a, b, activation)

    def bwd(a, b, dy, activation):
        count("gated_act_bwd", a, activation)
        return G.gated_act_bwd_plain(a, b, dy, activation)
    monkeypatch.setattr(G, "takes_kernel",
                        lambda ts, what="gated_act":
                        all(t.device.type == "cpu" for t in ts))
    monkeypatch.setattr(G, "gated_act_fwd", fwd)
    monkeypatch.setattr(G, "gated_act_bwd", bwd)
    return counts


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_function_gives_the_plain_autograd(dtype, emulated):
    a, b, dy = inputs(9, (3, 5, 48), dtype)
    got, want = [], []
    for through, out in ((True, got), (False, want)):
        al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
        y = (TC.gated_act(al, bl, "swiglu") if through
             else G.gated_act_plain(al, bl, "swiglu"))
        y.backward(dy)
        out += [y, al.grad, bl.grad]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    r = G.route("swiglu", DTYPES[dtype])
    assert emulated == {"gated_act_fwd": {r: 1}, "gated_act_bwd": {r: 1}}
    with torch.no_grad():                  # no recording: the launch alone
        TC.gated_act(a, b, "swiglu")
    assert emulated["gated_act_fwd"] == {r: 2}


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


@pytest.mark.parametrize("arch", ["codeqwen15_7b", "mamba2_1_3b",
                                  "zamba2_2_7b", "granite_moe_3b_a800m",
                                  "whisper_large_v3", "gemma2_27b",
                                  "nemotron_4_15b", "chameleon_34b"])
def test_serve_launches_are_chip_smokes(arch, emulated):
    """A serve run of each path's smoke config launches the gate as often
    as ``chip_smoke.expected_gate_serve`` counts on the device (on the CPU
    every decode step runs eagerly, as the card's replays run), on the
    model dtype's route, and no backward."""
    from repro_torch.launch.serve import run_serving
    cs = _chip_smoke()
    assert arch in cs.PATHS
    cfg = get_smoke_config(arch)
    shape = dict(num_requests=4, microbatch=2, decode_steps=4,
                 prompt_len=cfg.local_window + 4 if cfg.local_window else 12)
    run_serving(cfg, device="cpu", **shape)
    want = cs.expected_gate_serve(cfg, 2, shape["decode_steps"])
    n = want["gated_act_fwd"]["device"]
    assert emulated["gated_act_fwd"] == (
        {G.route(cfg.activation, cfg.torch_dtype): n} if n else {})
    assert emulated["gated_act_bwd"] == {}
    assert all(v == {"host": 0, "device": 0} for k, v in want.items()
               if k != "gated_act_fwd")


# ---------------------------------------------------------------------------
# (e) the build
# ---------------------------------------------------------------------------


def test_build_lists_the_source():
    assert "gated_mlp" in _build.KERNEL_SOURCES
    src = (_build.CSRC / "gated_mlp.cu").read_text()
    for name in ("gated_act_fwd", "gated_act_bwd", "gated_act_launches"):
        assert re.search(rf'extern "C" \w+(?: \w+)* {name}\(', src), name
    # the instances' order: activation * 2 + bf16
    assert "const int route = act * 2 + (bf16 ? 1 : 0);" in src

"""Port parity: flash attention.

The port's CPU route of ``flash_attention_bhsd`` (its plain version) and
``mha_reference`` against the JAX Pallas kernel run in interpret mode and
the JAX oracle, on the shape, mask/softcap and dtype cases of
``tests/test_kernels.py``; tolerances as there (f32 2e-5, bf16 2e-2).  The
CUDA kernel itself is checked against the plain version on the card by
``chip_smoke.py``; here also its build's bookkeeping (library names,
ptxas summaries) and the launches per route that ``chip_smoke.py``
expects of each serve path.
"""
import shutil
import sys
from pathlib import Path

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


ROOT = Path(__file__).resolve().parents[1]


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


def test_lib_path_hashes_every_shared_header(tmp_path, monkeypatch):
    """A new ``csrc/*.cuh`` renames (so rebuilds) every library: each
    source may include any shared header."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.lib_path(n) for n in _build.KERNEL_SOURCES}
    assert before == {n: _build.lib_path(n) for n in _build.KERNEL_SOURCES}
    (csrc / "extra_helpers.cuh").write_text("#pragma once\n")
    after = {n: _build.lib_path(n) for n in _build.KERNEL_SOURCES}
    assert all(after[n] != before[n] for n in _build.KERNEL_SOURCES)
    assert _build.lib_path("flash_attention", ("FLASH_FORCE_MMA",)) \
        != after["flash_attention"]                    # defines count too


def test_ptxas_summary_names_template_args_and_warnings(monkeypatch):
    """Bool template arguments and the ptxas warnings that name a kernel
    (a serialised wgmma pipeline) reach ``chip_smoke.py``'s build line."""
    name = ("_ZN12_GLOBAL__N_118flash_wgmma_kernelILi128ELi128ELi2ELb1EEEv"
            "14CUtensorMap_stS1_S1_S1_iiiiiiff")
    log = (f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'\n"
           f"ptxas info    : Function properties for {name}\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers, used 16 barriers\n"
           "ptxas info    : (C7515) Potential Performance Loss: "
           "wgmma.mma_async instructions are serialized due to insufficient "
           f"register resources in the function '{name}'\n")
    monkeypatch.setattr(_build, "build_log", lambda n, d=(): log)
    (entry,) = _build.ptxas_summary("flash_attention")
    assert entry["kernel"] == "flash_wgmma_kernel<128,128,2,1>"
    assert entry["registers"] == 168 and entry["spill_bytes"] == 12
    assert len(entry["warnings"]) == 1
    assert "serialized" in entry["warnings"][0]


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


WGMMA_ENTRY = ("_ZN12_GLOBAL__N_118flash_wgmma_kernelILi128ELi128ELi2ELb1EEEv"
               "14CUtensorMap_stS1_S1_S1_iiiiiiffi")


@pytest.mark.parametrize("line, spill, faults", [
    pytest.param("", 0, 0, id="clean"),
    pytest.param("", 8, 1, id="spill"),
    pytest.param("ptxas info    : (C7515) Potential Performance Loss: "
                 "wgmma.mma_async instructions are serialized due to "
                 f"insufficient register resources in the function "
                 f"'{WGMMA_ENTRY}'", 0, 1, id="wgmma_serialized"),
    pytest.param("ptxas warning : (C7508) Potential Performance Loss: "
                 "setmaxnreg ignored; unable to determine register count at "
                 "entry", 0, 1, id="setmaxnreg_ignored"),
    pytest.param("ptxas info    : Used 168 registers, used 16 barriers", 0,
                 0, id="registers_only"),
])
def test_chip_smoke_fails_on_ptxas_faults(line, spill, faults):
    """The build phase fails on a spill, a serialised wgmma pipeline or an
    ignored setmaxnreg, and on nothing else ptxas says."""
    cs = _chip_smoke()
    summary = {"flash_attention": [{"kernel": "flash_wgmma_kernel<128,128,"
                                              "2,1>", "registers": 168,
                                    "spill_bytes": spill, "warnings": []}]}
    log = ("ptxas info    : Compiling entry function "
           f"'{WGMMA_ENTRY}' for 'sm_90a'\n{line}\n")
    got = cs.ptxas_faults(summary, {"flash_attention": log})
    assert len(got) == faults
    assert all(g.startswith("flash_attention: ") for g in got)


class _Event:
    def __init__(self, key, device_type, count):
        self.key, self.device_type, self.count = key, device_type, count


def test_chip_smoke_reads_flash_routes_from_kernel_names():
    """The route a flash call ran is read from the device kernels' names in
    a profile: one route per kernel template, host-side rows ignored."""
    cs = _chip_smoke()
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [
        _Event("void (anonymous namespace)::flash_wgmma_kernel<128, 128, 2, "
               "true>(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, "
               "int, int, int, int, int, int, int, float, float, int)",
               cuda, 46),
        _Event("void (anonymous namespace)::flash_wgmma_kernel<64, 128, 2, "
               "true>(...)", cuda, 2),
        _Event("void (anonymous namespace)::flash_mma_kernel<80, 64, 64, 1>"
               "(...)", cuda, 9),
        _Event("void (anonymous namespace)::flash_f32_kernel<64, 64, 4>(...)",
               cuda, 32),
        _Event("void (anonymous namespace)::flash_3xtf32_kernel<64, 0>(...)",
               cuda, 64),
        _Event("cudaLaunchKernel", cpu, 89),
        _Event("flash_wgmma_kernel", cpu, 5),         # not a device row
        _Event("nvjet_tst_192x192_64x4_1x2_h_bz_coopA_NNT", cuda, 322),
    ]
    assert cs.flash_routes_seen(torch, events) == {
        "wgmma_bf16": 48, "mma_bf16": 9, "scalar_f32": 32, "mma_3xtf32": 64}
    assert cs.flash_routes_seen(torch, events[5:]) == {}
    assert set(cs.FLASH_KERNEL_ROUTES.values()) == set(fa.ROUTES)


class _CountingLib:
    """A stand-in for the flash library's launch counters."""
    def __init__(self, counts):
        self.counts = list(counts)

    def flash_attention_launches(self, kernel):
        return self.counts[kernel] if 0 <= kernel < len(self.counts) else 0


def test_kernel_launches_reads_the_library_counters_in_route_order():
    """The library counts kernel i of ``ROUTES`` as its counter i, and
    ``chip_smoke.launch_delta`` keeps only the routes launched since."""
    cs = _chip_smoke()
    lib = _CountingLib([5, 7, 11, 13])
    before = fa.kernel_launches(lib)
    assert before == {"wgmma_bf16": 5, "mma_bf16": 7, "scalar_f32": 11,
                      "mma_3xtf32": 13}
    lib.counts = [5 + 46, 7, 11 + 2, 13 + 64]
    assert cs.launch_delta(fa, lib, before) == {"wgmma_bf16": 46,
                                                "scalar_f32": 2,
                                                "mma_3xtf32": 64}
    assert cs.launch_delta(fa, lib, fa.kernel_launches(lib)) == {}


@pytest.mark.parametrize("launched,seen,faults", [
    ({"wgmma_bf16": 1}, {"wgmma_bf16": 1}, 0),
    ({"wgmma_bf16": 1}, {}, 0),            # the profile lost the records
    ({"mma_bf16": 1}, {"mma_bf16": 1}, 2),  # the library took another route
    ({"wgmma_bf16": 1}, {"mma_bf16": 1}, 1),
    ({"wgmma_bf16": 2}, {"wgmma_bf16": 2}, 2),
    ({}, {}, 1),                           # nothing launched
], ids=["agree", "profile_short", "library_route", "profile_route",
        "twice", "none"])
def test_chip_smoke_route_faults(launched, seen, faults):
    """A call's flash launches must be the expected ones in the library's
    own counts; a profile may show fewer, never a route more often."""
    cs = _chip_smoke()
    assert len(cs.route_faults({"wgmma_bf16": 1}, launched, seen)) == faults


# launches per serve round on each flash route (two microbatches a path)
EXPECTED_FLASH_ROUTES = {
    "codeqwen15_7b": {"wgmma_bf16": 64},
    "mamba2_1_3b": {},
    "zamba2_2_7b": {"wgmma_bf16": 18},        # the shared block's D = 80
    "granite_moe_3b_a800m": {"wgmma_bf16": 64},
    "whisper_large_v3": {"wgmma_bf16": 64, "mma_3xtf32": 64},
    "gemma2_27b": {"wgmma_bf16": 92},
    "nemotron_4_15b": {"wgmma_bf16": 64},
    "chameleon_34b": {"wgmma_bf16": 96},
}


@pytest.mark.parametrize("arch", sorted(EXPECTED_FLASH_ROUTES))
def test_chip_smoke_expected_launches_split_by_route(arch):
    """chip_smoke.py holds each serve path to these counts on the card."""
    chip_smoke = _chip_smoke()
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ss
    assert set(chip_smoke.PATHS) == set(EXPECTED_FLASH_ROUTES)
    cfg = get_config(arch)
    shape = chip_smoke.serve_shape(arch)
    n_micro = shape["num_requests"] // shape["microbatch"]
    got = chip_smoke.expected_launches(torch, cfg, n_micro, fa, ss)
    assert got["flash_attention_bhsd"] == {
        **dict.fromkeys(fa.ROUTES, 0), **EXPECTED_FLASH_ROUTES[arch]}
    ssd = {"mamba2_1_3b": 96, "zamba2_2_7b": 108}.get(arch, 0)
    assert got["ssd_scan_bhsd"] == {"wgmma_bf16": ssd, "mma_bf16": 0,
                                    "scalar_f32": 0}


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


# ---------------------------------------------------------------------------
# The f32 route on the tensor cores (mma_3xtf32), emulated
# ---------------------------------------------------------------------------

X3_ROWS = X3_KEYS = 32          # flash_3xtf32_kernel's query and key tiles


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero): ``x3::tf32`` in ``csrc/f32_split.cuh``."""
    mag = x.float().abs().contiguous().view(torch.int32)
    r = ((mag + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(x < 0, -r, r)


def x3_accumulate(acc, a, b, split="3xtf32"):
    """acc + a @ b as ``x3::product_nt`` / ``product_nn`` sum it: the
    tile's product 8 deep at a time in a fresh accumulator, each f32
    operand a TF32 big part and its TF32 remainder, small a x big b, big a
    x small b, then big x big ("3xtf32"), or each operand rounded to TF32
    once ("tf32"); then added to acc."""
    ab, bb = tf32(a), tf32(b)
    a_s, b_s = tf32(a - ab), tf32(b - bb)
    part = torch.zeros_like(acc)
    for k0 in range(0, a.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        terms = [ab[..., sl] @ bb[..., sl, :]]
        if split == "3xtf32":
            terms = [a_s[..., sl] @ bb[..., sl, :],
                     ab[..., sl] @ b_s[..., sl, :]] + terms
        for t in terms:
            part = part + t
    return acc + part


def kv_tiles(q0, rows, sq, sk, causal, window, bk):
    """The kernel's ``kv_tiles``: the first key tile and how many."""
    q_last = min(q0 + rows, sq) - 1
    kv_end = min(sk, q_last + 1) if causal else sk
    kv_begin = 0
    if window > 0 and q_last < sk - 1 + window:
        kv_begin = max(0, q0 - window + 1)
    begin = kv_begin // bk
    return begin, -(-kv_end // bk) - begin


def emulate_flash_x3(q, k, v, *, causal=True, window=0, logit_cap=0.0,
                     qk_split="3xtf32"):
    """``flash_3xtf32_kernel`` on f32 (B, H, S, D) tensors: 32-row query
    tiles over 32-key tiles dealt in turns to two halves, each with its own
    online softmax from a running max of -1e30, merged at the end
    (``x3::merge_softmax``); its score (the scale as the wrapper rounds it
    to f32, the tanh cap, -1e30 where masked, keys past Sk left out) and
    the products of ``x3_accumulate`` (Q K^T's operands split as
    ``qk_split`` says)."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    sk = k.shape[2]
    kh, vh = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    scale = float(np.float32(1.0 / np.sqrt(d)))
    out = torch.zeros_like(q)
    for q0 in range(0, sq, X3_ROWS):
        rows = torch.arange(q0, min(q0 + X3_ROWS, sq))
        begin, count = kv_tiles(q0, X3_ROWS, sq, sk, causal, window, X3_KEYS)
        state = []
        for half in range(2):
            m = torch.full((b, hq, len(rows)), -1e30)
            l = torch.zeros((b, hq, len(rows)))
            acc = torch.zeros((b, hq, len(rows), d))
            for it in range(begin + half, begin + count, 2):
                cols = torch.arange(it * X3_KEYS,
                                    min(it * X3_KEYS + X3_KEYS, sk))
                s = x3_accumulate(torch.zeros((b, hq, len(rows), len(cols))),
                                  q[:, :, rows],
                                  kh[:, :, cols].transpose(-1, -2), qk_split)
                x = s * scale
                if logit_cap:
                    x = logit_cap * torch.tanh(x / logit_cap)
                r, c = rows[:, None], cols[None, :]
                seen = torch.ones_like(x, dtype=torch.bool)
                if causal:
                    seen &= c <= r
                if window:
                    seen &= r - c < window
                x = torch.where(seen, x, torch.tensor(-1e30))
                mx = torch.maximum(m, x.max(-1).values)
                corr = torch.exp(m - mx)
                p = torch.exp(x - mx[..., None])
                l = l * corr + p.sum(-1)
                acc = x3_accumulate(acc * corr[..., None], p, vh[:, :, cols])
                m = mx
            state.append((m, l, acc))
        (m, l, acc), (m1, l1, acc1) = state
        mx = torch.maximum(m, m1)
        c0, c1 = torch.exp(m - mx), torch.exp(m1 - mx)
        l = l * c0 + l1 * c1
        acc = acc * c0[..., None] + acc1 * c1[..., None]
        out[:, :, rows] = acc * (1.0 / l.clamp(min=1e-30))[..., None]
    return out


# (b, hq, hkv, sq, sk, d, causal, window, cap): the f32 cases of
# chip_smoke.py's flash phase at CPU sizes, whisper's encoder among them
X3_CASES = {
    "whisper_enc": (2, 4, 4, 64, 64, 64, False, 0, 0.0),
    "gqa2_d32": (2, 4, 2, 64, 64, 32, True, 0, 0.0),
    "ragged_noncausal": (2, 2, 2, 48, 80, 32, False, 0, 0.0),
    "ragged_17x33_d8": (1, 4, 4, 17, 33, 8, True, 0, 0.0),
    "window8_cap50": (2, 4, 2, 64, 64, 32, True, 8, 50.0),
    "d80": (1, 2, 1, 40, 40, 80, True, 0, 0.0),
    "d128_gqa4": (1, 8, 2, 40, 40, 128, True, 0, 20.0),
    # rows 12..19 see no key: they average V over every key (the oracle)
    "no_visible_key": (1, 2, 1, 20, 10, 8, True, 3, 0.0),
}


@pytest.mark.parametrize("name", sorted(X3_CASES))
def test_x3_route_emulated_matches_jax(name):
    """The ``mma_3xtf32`` route's arithmetic against the JAX oracle at
    f32's 2e-5."""
    b, hq, hkv, sq, sk, d, causal, window, cap = X3_CASES[name]
    assert fa.route(torch.float32, d) == "mma_3xtf32"
    (jq, q), (jk, k), (jv, v) = (both(rnd(20, (b, hq, sq, d))),
                                 both(rnd(21, (b, hkv, sk, d))),
                                 both(rnd(22, (b, hkv, sk, d))))
    opts = dict(causal=causal, window=window, logit_cap=cap)
    close(emulate_flash_x3(q, k, v, **opts),
          jref.mha_reference(jq, jk, jv, **opts), 2e-5)


def test_tf32_rounded_q_and_k_miss_the_f32_tolerance():
    """Q K^T from one TF32 rounding of q and k (what TF32 tensor cores do
    to f32 inputs) misses f32's 2e-5: the split is what meets it."""
    b, hq, hkv, sq, sk, d, causal, window, cap = X3_CASES["whisper_enc"]
    (jq, q), (jk, k), (jv, v) = (both(rnd(20, (b, hq, sq, d))),
                                 both(rnd(21, (b, hkv, sk, d))),
                                 both(rnd(22, (b, hkv, sk, d))))
    want = jref.mha_reference(jq, jk, jv, causal=causal)
    close(emulate_flash_x3(q, k, v, causal=causal), want, 2e-5)
    with pytest.raises(AssertionError):
        close(emulate_flash_x3(q, k, v, causal=causal, qk_split="tf32"),
              want, 2e-5)


def test_routes_by_dtype_and_head_dim():
    f32, bf = torch.float32, torch.bfloat16
    assert [fa.route(f32, d) for d in (8, 16, 64, 80, 128)] == \
        ["mma_3xtf32"] * 5
    assert fa.route(f32, 136) == fa.route(f32, 256) == "scalar_f32"
    assert fa.route(bf, 64) == fa.route(bf, 128) == "wgmma_bf16"
    assert fa.route(bf, 80) == "wgmma_bf16"            # zamba2's shared block
    assert [fa.route(bf, d) for d in (8, 40, 72, 88, 96, 136, 144, 256)] \
        == ["mma_bf16"] * 8
    assert fa.ROUTES.index("mma_3xtf32") == 3          # the C kernel id
    src = (_build.CSRC / "flash_attention.cu").read_text()
    assert "enum Kernel { kWgmma, kMma, kF32, kX3, kKernels };" in src

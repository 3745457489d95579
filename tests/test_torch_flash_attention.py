"""The PyTorch port's flash-attention forward
(`mxtpu_torch/ops/flash_attention.py`) against the JAX package's
(`mxtpu/ops/pallas_attention.py`), and the wrappers of all three CUDA
kernels (the backward's numerics: `test_torch_flash_backward.py`).

The same numpy inputs go through the Pallas kernel in interpreter mode
(as `tests/test_pallas_attention.py` runs it on the CPU) and through the
port on the CPU, which takes the plain PyTorch version; O and the LSE
are compared at the bounds `test_pallas_attention.py` holds the kernel
to (f32 rtol 2e-4 / atol 2e-5, bf16 0.05).  The CUDA kernel itself runs
only on the card: `chip_smoke.py` holds it against the plain version
there.  The wrappers' argument checks run here, on CPU tensors.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxtpu.ops import pallas_attention as jfa
from mxtpu_torch.base import MXNetError
from mxtpu_torch.ops import flash_attention as tfa

F32_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("MXTPU_PALLAS_INTERPRET", "1")


def _qkv(shape_q, tk, seed, dtype=np.float32):
    rng = np.random.RandomState(seed)
    bh, tq, d = shape_q
    return (rng.normal(0, 1, (bh, tq, d)).astype(dtype),
            rng.normal(0, 1, (bh, tk, d)).astype(dtype),
            rng.normal(0, 1, (bh, tk, d)).astype(dtype))


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 64), (1, 384, 128)])
def test_plain_matches_pallas_kernel_out_and_lse(causal, shape):
    """The port's routed forward (`_flash_impl`, plain on the CPU)
    against `_flash_forward_pallas` in interpret mode, LSE included."""
    q, k, v = _qkv(shape, shape[1], seed=0)
    scale = 1.0 / np.sqrt(shape[-1])
    jo, jl = jfa._flash_forward_pallas(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), scale, causal, 128,
                                       128, True)
    to, tl = tfa._flash_impl(*_port(q, k, v), scale, causal, True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)
    # the public entries agree too, and want_lse=False returns no LSE
    pub = tfa.flash_attention(*_port(q, k, v), causal=causal)
    np.testing.assert_allclose(
        pub.numpy(), np.asarray(jfa.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=128, block_k=128)), **F32_TOL)
    assert tfa._flash_impl(*_port(q, k, v), scale, causal, False)[1] is None


@pytest.mark.parametrize("causal", [False, True])
def test_ragged_lengths(causal):
    """Tq 100 x Tk 90.  JAX routes ragged K to its reference (blocks of
    64) and runs the kernel when the blocks fit the lengths; the port's
    kernel masks ragged lengths itself.  All three agree."""
    q, k, v = _qkv((2, 100, 32), 90, seed=3)
    scale = 1.0 / np.sqrt(32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    to, tl = tfa._flash_impl(*_port(q, k, v), scale, causal, True)
    ref = jfa.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                              block_k=64)
    np.testing.assert_allclose(to.numpy(), np.asarray(ref), **F32_TOL)
    jo, jl = jfa._flash_forward_pallas(jq, jk, jv, scale, causal, 100, 90,
                                       True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32_TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)


def test_4d_layout_and_strided_heads():
    """(batch, heads, seq, head_dim) in, same layout out; heads split
    by a transpose (a strided view, as the transformer's `split` makes)
    give the same result as contiguous ones."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.normal(0, 1, (2, 3, 128, 32)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), causal=True))
    out = tfa.flash_attention(*_port(q, k, v), causal=True)
    assert out.shape == (2, 3, 128, 32)
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)
    strided = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
               .transpose(1, 2) for a in (q, k, v)]
    assert not strided[0].is_contiguous()
    np.testing.assert_allclose(
        tfa.flash_attention(*strided, causal=True).numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_4d_strided_heads_reach_the_kernel_contiguous(batch, monkeypatch):
    """Heads split by a transpose stay a strided view after the
    (b*h, t, d) reshape at batch 1; what `flash_attention` routes on must
    pass the kernel's argument checks at every batch."""
    seen = []
    impl = tfa._flash_impl

    def checked(q, k, v, *args, **kwargs):
        tfa._check_kernel_args(q, k, v)
        seen.append(q.shape)
        return impl(q, k, v, *args, **kwargs)

    monkeypatch.setattr(tfa, "_flash_impl", checked)
    x = torch.randn(batch, 64, 4 * 32).reshape(batch, 64, 4, 32)
    q = x.transpose(1, 2)                      # (b, h, t, d), strided
    out = tfa.flash_attention(q, q, q, causal=True)
    assert seen == [(batch * 4, 64, 32)] and out.shape == q.shape


def test_bfloat16():
    """bf16 in, bf16 out; P is rounded to bf16 before P.V in both."""
    q, k, v = _qkv((2, 128, 64), 128, seed=7)
    jq, jk, jv = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v))
    ref = jfa.flash_attention(jq, jk, jv, causal=True, block_q=64,
                              block_k=64)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref).astype(np.float32),
                               rtol=0.05, atol=0.05)


def test_bfloat16_online_softmax_error_scale():
    """The bound chip_smoke.py holds the bf16 kernel to, on the CPU: an
    online softmax over 64-key tiles (the port's blocked loop, which
    rounds P to bf16 at each tile's running max, as the kernel does)
    against the plain version is within 2e-3 + 2^-6 * (P|V|)/l and a
    relative L2 of 1e-2; with one key tile's values zeroed it is not."""
    from mxtpu_torch.parallel.ring_attention import _blockwise_loop

    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)[None]
               for a in _qkv((4, 256, 64), 256, seed=11))
    scale = 64 ** -0.5
    ref, lse = tfa._reference_attention_lse(q[0], k[0], v[0], scale, True)
    s = torch.einsum("bqd,bkd->bqk", q[0].float(), k[0].float()) * scale
    s = s.masked_fill(torch.ones(256, 256, dtype=torch.bool).triu(1),
                      float("-inf"))
    bound = 2e-3 + 2 ** -6 * (torch.exp(s - lse[..., None])
                              @ v[0].float().abs())

    def within(out):
        d = out[0].float() - ref.float()
        return bool(torch.all(d.abs() <= bound)) and \
            (d.norm() / ref.float().norm()).item() <= 1e-2

    assert within(_blockwise_loop(q, k, v, 64, True, scale))
    v_bad = v.clone()
    v_bad[..., 128:192, :] = 0
    assert not within(_blockwise_loop(q, k, v_bad, 64, True, scale))


def test_plain_version_matches_jax_reference():
    """`_reference_attention_lse` is a port of the JAX function of the
    same name: equal on the same inputs, causal and not."""
    q, k, v = _qkv((3, 70, 16), 50, seed=5)
    for causal in (False, True):
        jo, jl = jfa._reference_attention_lse(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 0.3, causal)
        to, tl = tfa._reference_attention_lse(*_port(q, k, v), 0.3, causal)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **F32_TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **F32_TOL)


KERNELS = {"flash_fwd": tfa.FLASH_FWD, "flash_bwd_dq": tfa.FLASH_BWD_DQ,
           "flash_bwd_dkv": tfa.FLASH_BWD_DKV}


def _wrapper_checks(kernel, q, k, v, g=None, out=None, lse=None):
    """The argument checks the wrapper launching `kernel` makes: the
    forward's, or the backward's (shared by its two kernels) with a
    cotangent, an output and an LSE that fit q unless given."""
    if kernel == "flash_fwd":
        return tfa._check_kernel_args(q, k, v)
    g = q.clone() if g is None else g
    out = q.clone() if out is None else out
    lse = torch.zeros(q.shape[:2]) if lse is None else lse
    return tfa._check_bwd_args(q, k, v, g, out, lse)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("bad", ["strided", "misaligned", "float16", "mixed",
                                 "head_dim", "mismatch", "empty", "rank"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, kernel):
    q, k, v = _port(*_qkv((2, 64, 32), 64, seed=2))
    if bad == "strided":
        q = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "misaligned":  # contiguous, 4 bytes past an aligned start
        q = torch.zeros(q.numel() + 1)[1:].view(q.shape)
        assert q.is_contiguous()
    elif bad == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        v = v.to(torch.bfloat16)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(2, 64, 48) for _ in range(3))
    elif bad == "mismatch":
        v = v[:, :32].contiguous()
    elif bad == "empty":
        q = q[:, :0]
    elif bad == "rank":
        q = q[None]
    with pytest.raises(MXNetError):
        _wrapper_checks(kernel, q, k, v)


@pytest.mark.parametrize("bad", ["g_strided", "g_dtype", "out_shape",
                                 "out_misaligned", "lse_dtype", "lse_shape"])
def test_backward_wrapper_rejects_bad_cotangent_output_or_lse(bad):
    """The backward kernels also read g and O like q, and the LSE as a
    contiguous (bh, Tq) float32 array."""
    q, k, v = _port(*_qkv((2, 64, 32), 64, seed=2))
    _wrapper_checks("flash_bwd_dq", q, k, v)  # the good arguments pass
    g = out = lse = None
    if bad == "g_strided":
        g = q.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "g_dtype":
        g = q.to(torch.bfloat16)
    elif bad == "out_shape":
        out = q[:, :32].contiguous()
    elif bad == "out_misaligned":
        out = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    elif bad == "lse_dtype":
        lse = torch.zeros(2, 64, dtype=torch.float64)
    elif bad == "lse_shape":
        lse = torch.zeros(2, 64, 1)
    with pytest.raises(MXNetError):
        _wrapper_checks("flash_bwd_dkv", q, k, v, g, out, lse)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_kernel_launcher_refuses_cpu_tensors(kernel):
    """The CUDA launchers never compute on the CPU: the plain versions
    are reached only through the routing (`_flash_impl`, the autograd
    Function's backward), for CPU tensors."""
    q, k, v = _port(*_qkv((2, 64, 32), 64, seed=2))
    before = {name: kern.launches for name, kern in KERNELS.items()}
    with pytest.raises(MXNetError, match="CUDA"):
        if kernel == "flash_fwd":
            tfa._flash_forward_cuda(q, k, v, 0.2, True, False)
        else:
            tfa._flash_backward_cuda(q, k, v, q.clone(), q.clone(),
                                     torch.zeros(2, 64), 0.2, True)
    assert {name: kern.launches for name, kern in KERNELS.items()} == before


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_launch_counter_counts_successful_launches_only(kernel):
    """`CudaKernel` raises on a non-zero CUDA error from its C entry
    point and counts only the launches that returned 0."""
    from mxtpu_torch.ops.kernel_build import CudaKernel

    kern = CudaKernel(KERNELS[kernel].source, KERNELS[kernel].symbol, [])
    codes = iter([0, 700, 0])
    kern._fn = lambda *args: next(codes)
    kern(1, 2)
    with pytest.raises(MXNetError, match="CUDA error 700"):
        kern(1, 2)
    kern(1, 2)
    assert kern.launches == 2


def test_build_reuses_the_library_of_an_unchanged_source(tmp_path,
                                                         monkeypatch):
    """The library's name hashes the source, the shared headers and the
    flags: an existing one is reused without nvcc, a missing one with no
    nvcc raises typed, and an edited header changes the name."""
    import hashlib

    from mxtpu_torch.ops import kernel_build as kb

    monkeypatch.setattr(kb, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kb.os.path, "isfile", lambda p: False)
    with pytest.raises(MXNetError, match="nvcc not found"):
        kb.build("flash_fwd.cu")
    headers = sorted(kb.CSRC.glob("*.cuh"))
    assert [h.name for h in headers] == ["hopper.cuh", "mma_bf16.cuh"]
    text = (kb.CSRC / "flash_fwd.cu").read_bytes() + b"".join(
        h.read_bytes() for h in headers)
    key = hashlib.sha256(text + " ".join(kb.NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    lib = tmp_path / ("flash_fwd-%s.so" % key)
    lib.write_bytes(b"")
    assert kb.build("flash_fwd.cu") == (lib, "")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in kb.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(kb, "CSRC", csrc)
    assert kb.library_key("flash_fwd.cu") == key
    (csrc / "mma_bf16.cuh").write_bytes(b"// edited\n")
    assert kb.library_key("flash_fwd.cu") != key


def test_build_from_another_source_directory(tmp_path, monkeypatch):
    """A copy of the sources with one line changed (as chip_smoke.py's
    fault run makes) has its own library name, and is built into the
    build directory given, never into the package's."""
    from mxtpu_torch.ops import kernel_build as kb

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in kb.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    assert kb.library_key("flash_fwd.cu", csrc) == \
        kb.library_key("flash_fwd.cu")
    src = (csrc / "flash_fwd.cu").read_text()
    (csrc / "flash_fwd.cu").write_text(
        src.replace("constexpr int V_TRANS = 1;", "constexpr int V_TRANS = 0;"))
    key = kb.library_key("flash_fwd.cu", csrc)
    assert key != kb.library_key("flash_fwd.cu")
    build_dir = tmp_path / "build"
    build_dir.mkdir()
    lib = build_dir / ("flash_fwd-%s.so" % key)
    lib.write_bytes(b"")
    monkeypatch.setattr(kb, "nvcc_path", lambda: pytest.fail("nvcc ran"))
    assert kb.build("flash_fwd.cu", csrc, build_dir) == (lib, "")
    kern = kb.CudaKernel("flash_fwd.cu", "flash_fwd", [], csrc=csrc,
                         build_dir=build_dir)
    assert (kern.csrc, kern.build_dir) == (csrc, build_dir)


def test_ptxas_summary_names_kernels_and_keeps_performance_notes():
    """`kernel_build.ptxas_summary` on lines as `nvcc -Xptxas -v` prints
    them: one entry a kernel of the port, in order, named by path and
    template arguments (the wgmma forward's sign of the scale, the
    backward's mode), then ptxas's notes of a performance loss; a kernel
    from elsewhere is left out."""
    from mxtpu_torch.ops import kernel_build as kb

    ns = "_GLOBAL__N__9b5d88fb_12_flash_fwd_cu_b294bfd0"

    def entry(path, args):
        return "_ZN%d%s%d%s6kernelI%sEEv14CUtensorMap_st" % (
            len(ns), ns, len(path), path, args)

    def lines(name, regs, spill):
        return ["ptxas info    : Compiling entry function '%s' for "
                "'sm_90a'" % name,
                "ptxas info    : Function properties for %s" % name,
                "    %d bytes stack frame, %d bytes spill stores, %d bytes "
                "spill loads" % (spill, spill, spill),
                "ptxas info    : Used %d registers, used 1 barriers, 400 "
                "bytes cmem[0]" % regs]

    fwd = entry("wg", "Li128ELi1E")
    note = ("ptxas info    : (C7512) Potential Performance Loss: "
            "wgmma.mma_async instructions are serialized due to "
            "insufficient register resources for the function '%s'" % fwd)
    log = "\n".join(["ptxas info    : 0 bytes gmem"]
                     + lines(fwd, 168, 216) + [note]
                     + lines(entry("wg", "Li64ELin1E"), 168, 0)
                     + lines(entry("tc", "Li128ELb1E"), 255, 20)
                     + lines(entry("f32", "Li16ELb0E"), 56, 0)
                     + lines(entry("tc", "Li32E"), 96, 0)
                     + lines("_Z6othervPf", 32, 8))
    assert kb.ptxas_summary(log) == [
        "wg<128,1> 168 regs, spill 216", "wg<64,-1> 168 regs, spill 0",
        "tc<128,dkv> 255 regs, spill 20", "f32<16,dq> 56 regs, spill 0",
        "tc<32> 96 regs, spill 0", note.strip()]
    assert kb.ptxas_summary("") == []

"""The port's kernels (``repro_torch.kernels``) against the JAX package's.

On the CPU the port's ``ops`` run the plain PyTorch versions; they are held
against the reference's Pallas kernels run as ``tests/test_kernels.py`` runs
them (``repro.kernels.ops``, interpret mode on the CPU), at its shapes and
tolerances: 1e-5 for float32, 2e-2 for bfloat16 (bf16 keeps 8 bits, and the
two sides round at different places).  The cases marked ``cuda`` run the
CUDA kernels against the plain versions on the card, element by element
(``ref.scaled_err``), check that faults planted in copies of the kernels'
sources fail that check, and skip without a card; the JAX cases skip where
JAX is absent (the GPU machine).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.a2a_pack import a2a_pack_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd_cuda
from repro_torch.kernels.mamba_scan import mamba_scan_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.rmsnorm_bwd import rmsnorm_bwd_cuda

RNG = np.random.RandomState(0)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


@pytest.fixture
def jax_kernels():
    """The reference's kernel dispatch and oracles (JAX on the CPU)."""
    pytest.importorskip("jax")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref

    return jops, jref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def _both(a: np.ndarray, dt: str):
    import jax.numpy as jnp

    return jnp.asarray(a, getattr(jnp, dt)), torch.from_numpy(a).to(getattr(torch, dt))


def _maxdiff(port: torch.Tensor, want) -> float:
    return float(np.abs(port.float().numpy() - np.asarray(want, np.float32)).max())


FLASH_CASES = [  # BH, S, hd, g, window, dtype, causal
    (4, 128, 32, 1, None, "float32", True),
    (6, 256, 64, 3, None, "bfloat16", True),
    (2, 128, 32, 1, 48, "float32", True),
    (4, 64, 16, 2, None, "float32", True),
    (2, 96, 16, 2, 32, "bfloat16", True),
    (16, 64, 16, 8, None, "float32", True),   # yi's GQA group of 8
    (8, 128, 16, 4, 40, "bfloat16", True),    # GQA with a window
    (2, 64, 16, 1, None, "float32", False),   # non-causal
    (4, 64, 16, 2, 24, "float32", False),     # non-causal with a window
    (8, 64, 120, 4, None, "bfloat16", True),  # h2o-danube's head_dim, GQA group of 4
    (4, 96, 120, 4, 40, "float32", True),     # ... with a window
    (2, 64, 256, 1, None, "bfloat16", True),  # gemma's head_dim
    (2, 64, 256, 1, 24, "float32", True),     # ... with a window
]


@pytest.mark.parametrize("BH,S,hd,g,win,dt,causal", FLASH_CASES)
def test_flash_attention_matches_pallas(jax_kernels, BH, S, hd, g, win, dt, causal):
    jops, _ = jax_kernels
    arrs = [RNG.randn(n, S, hd).astype(np.float32) for n in (BH, BH // g, BH // g)]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dt) for a in arrs)
    want = jops.flash_attention(jq, jk, jv, group_size=g, causal=causal, window=win,
                                block_q=32, block_k=32)
    out = ops.flash_attention(tq, tk, tv, group_size=g, causal=causal, window=win)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert _maxdiff(out, want.astype(np.float32)) < TOL[dt]


@pytest.mark.parametrize("Sq,Skv,win", [(100, 100, None), (37, 37, 16), (20, 50, None)])
def test_flash_attention_ragged_matches_reference_oracle(jax_kernels, Sq, Skv, win):
    """Lengths off any block multiple (the Pallas kernel refuses them; the
    port's kernel masks them), against the reference's oracle."""
    _, jref = jax_kernels
    arrs = [RNG.randn(n, s, 16).astype(np.float32) for n, s in ((4, Sq), (2, Skv), (2, Skv))]
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, "float32") for a in arrs)
    want = jref.flash_attention_ref(jq, jk, jv, group_size=2, window=win)
    out = ops.flash_attention(tq, tk, tv, group_size=2, window=win)
    assert _maxdiff(out, want) < TOL["float32"]


@pytest.mark.parametrize("T,d,dt", [(64, 128, "float32"), (100, 96, "bfloat16"),
                                    (256, 512, "float32"), (7, 4096, "bfloat16")])
def test_rmsnorm_matches_pallas(jax_kernels, T, d, dt):
    jops, _ = jax_kernels
    (jx, tx), (jw, tw) = _both(RNG.randn(T, d).astype(np.float32), dt), \
        _both(RNG.rand(d).astype(np.float32), dt)
    want = jops.rmsnorm(jx, jw)
    out = ops.rmsnorm(tx, tw)
    assert out.dtype == tx.dtype
    assert _maxdiff(out, want.astype(np.float32)) < TOL[dt]


def test_cpu_calls_run_the_plain_versions_uncounted():
    before = (ops.rmsnorm.launches, ops.flash_attention.launches)
    x, w = torch.randn(4, 64), torch.rand(64)
    torch.testing.assert_close(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w), rtol=0, atol=0)
    q, k = torch.randn(4, 32, 16), torch.randn(2, 32, 16)
    torch.testing.assert_close(ops.flash_attention(q, k, k, group_size=2),
                               ref.flash_attention_ref(q, k, k, group_size=2),
                               rtol=0, atol=0)
    assert (ops.rmsnorm.launches, ops.flash_attention.launches) == before


def test_backward_cpu_calls_run_the_plain_versions_uncounted():
    before = ops.launch_counts()
    x, w, dy = torch.randn(4, 64), torch.rand(64), torch.randn(4, 64)
    for a, b in zip(ops.rmsnorm_bwd(x, w, dy), ref.rmsnorm_bwd_ref(x, w, dy)):
        assert torch.equal(a, b)
    q, k, v = torch.randn(4, 32, 16), torch.randn(2, 32, 16), torch.randn(2, 32, 16)
    o, lse = ops.flash_attention(q, k, v, group_size=2, return_lse=True)
    assert torch.equal(o, ref.flash_attention_ref(q, k, v, group_size=2))
    do = torch.randn(4, 32, 16)
    for a, b in zip(ops.flash_attention_bwd(q, k, v, o, lse, do, group_size=2),
                    ref.flash_attention_bwd_ref(q, k, v, o, lse, do, group_size=2)):
        assert torch.equal(a, b)
    assert ops.launch_counts() == before


def _bwd_args(BH=4, S=8, hd=16, g=2, dt=torch.bfloat16, hdv=None, hdo=None):
    """q, k [.., hd]; v [.., hdv]; o, do [.., hdo] (both hd by default)."""
    hdv = hdv or hd
    q, k = torch.randn(BH, S, hd, dtype=dt), torch.randn(BH // g, S, hd, dtype=dt)
    v = torch.randn(BH // g, S, hdv, dtype=dt)
    o, do = (torch.randn(BH, S, hdo or hdv, dtype=dt) for _ in range(2))
    return q, k, v, o, torch.zeros(BH, S), do


@pytest.mark.parametrize("call,err", [
    (lambda: flash_attention_bwd_cuda(*_bwd_args(), group_size=2), "one CUDA device"),
    # a pair of head dims outside HEAD_DIMS, and v at a head dim that does not
    # match q's and k's pair; o at v's head dim
    (lambda: flash_attention_bwd_cuda(*_bwd_args(hd=48), group_size=2), r"\(48, 48\) not in"),
    (lambda: flash_attention_bwd_cuda(*_bwd_args(hd=96, hdv=96), group_size=2),
     r"\(96, 96\) not in"),
    (lambda: flash_attention_bwd_cuda(*_bwd_args(hd=96, hdv=64, hdo=96), group_size=2),
     "o, do"),
    (lambda: flash_attention_bwd_cuda(*_bwd_args(dt=torch.float32), group_size=2), "bfloat16"),
    (lambda: flash_attention_bwd_cuda(*_bwd_args(), group_size=4), "group_size=4"),
    (lambda: flash_attention_bwd_cuda(*_bwd_args()[:4], torch.zeros(4, 8, dtype=torch.bfloat16),
                                      _bwd_args()[5], group_size=2), "lse"),
    (lambda: flash_attention_bwd_cuda(*_bwd_args(), group_size=2, window=0), "window"),
    (lambda: flash_attention_cuda(*(torch.randn(2, 8, 96, dtype=torch.bfloat16),) * 3,
                                  group_size=1, return_lse=True), r"\(96, 96\) not in"),
    (lambda: rmsnorm_bwd_cuda(torch.randn(4, 64), torch.rand(64), torch.randn(4, 64)),
     "one CUDA device"),
    (lambda: rmsnorm_bwd_cuda(torch.randn(4, 60), torch.rand(60), torch.randn(4, 60)),
     "multiple of 8"),
    (lambda: rmsnorm_bwd_cuda(torch.randn(4, 64), torch.rand(64), torch.randn(4, 64).bfloat16()),
     "all float32"),
    (lambda: rmsnorm_bwd_cuda(torch.randn(4, 64), torch.rand(64), torch.randn(4, 32)), "dy"),
    (lambda: rmsnorm_bwd_cuda(torch.randn(1, 8200), torch.rand(8200), torch.randn(1, 8200)),
     "wider"),
])
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    with pytest.raises((ValueError, TypeError), match=err):
        call()


def test_mamba_scan_cpu_call_runs_the_plain_version_uncounted():
    a, b = torch.rand(2, 9, 8, 4) * 0.9, torch.randn(2, 9, 8, 4)
    c, h0 = torch.randn(2, 9, 4), torch.randn(2, 8, 4)
    before = ops.mamba_scan.launches
    for h in (None, h0):
        got, want = ops.mamba_scan(a, b, c, h), ref.mamba_scan_ref(a, b, c, h)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert ops.mamba_scan.launches == before


@pytest.mark.parametrize("shape,dt", [((3, 4, 8, 16), "float32"), ((2, 2, 4, 4), "float32"),
                                      ((8, 1, 2, 32), "float32"), ((2, 3, 5, 7), "bfloat16")])
def test_a2a_pack_matches_pallas(jax_kernels, shape, dt):
    """The regroup is a copy: exact, in any dtype."""
    jops, _ = jax_kernels
    jx, tx = _both(RNG.randn(*shape).astype(np.float32), dt)
    out = ops.a2a_pack(tx)
    assert out.dtype == tx.dtype and out.is_contiguous()
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jops.a2a_pack(jx).astype(np.float32)))


def test_a2a_pack_cpu_call_runs_the_plain_version_uncounted():
    x = torch.randn(3, 4, 5, 6)
    before = ops.a2a_pack.launches
    torch.testing.assert_close(ops.a2a_pack(x), ref.a2a_pack_ref(x), rtol=0, atol=0)
    torch.testing.assert_close(ops.a2a_pack(x), x.permute(1, 0, 2, 3), rtol=0, atol=0)
    assert ops.a2a_pack.launches == before


def _scan_args(B=2, S=5, di=8, N=4, dtype=torch.float32):
    return (torch.rand(B, S, di, N, dtype=dtype), torch.randn(B, S, di, N, dtype=dtype),
            torch.randn(B, S, N, dtype=dtype))


@pytest.mark.parametrize("call,err", [
    (lambda: mamba_scan_cuda(*_scan_args()), "CUDA device"),
    (lambda: mamba_scan_cuda(*_scan_args(N=3)), "must divide 32"),
    (lambda: mamba_scan_cuda(*_scan_args(N=64)), "must divide 32"),
    (lambda: mamba_scan_cuda(*_scan_args(dtype=torch.bfloat16)), "float32"),
    (lambda: mamba_scan_cuda(*_scan_args(), torch.zeros(2, 8, 4, dtype=torch.float64)),
     "float32"),
    (lambda: mamba_scan_cuda(_scan_args()[0].transpose(2, 3).contiguous().transpose(2, 3),
                             *_scan_args()[1:]), "contiguous"),
    (lambda: mamba_scan_cuda(*_scan_args(), torch.zeros(2, 8)), r"h0 \[B, di, N\]"),
    (lambda: a2a_pack_cuda(torch.randn(2, 4, 3, 8)), "CUDA device"),
    (lambda: a2a_pack_cuda(torch.randn(2, 4, 24)), r"want x \[No, Ni, blk, d\]"),
    (lambda: a2a_pack_cuda(torch.randn(2, 4, 0, 8)), "nonempty"),
    (lambda: rmsnorm_cuda(torch.randn(4, 64), torch.rand(64)), "CUDA device"),
    (lambda: rmsnorm_cuda(torch.randn(4, 60), torch.rand(60)), "multiple of 8"),
    (lambda: rmsnorm_cuda(torch.randn(4, 64).half(), torch.rand(64)), "bfloat16"),
    (lambda: rmsnorm_cuda(torch.randn(4, 64), torch.rand(64).bfloat16()), "both float32"),
    (lambda: flash_attention_cuda(*(torch.randn(2, 8, 16, dtype=torch.bfloat16),) * 3,
                                  group_size=1), "CUDA device"),
    (lambda: flash_attention_cuda(*(torch.randn(2, 8, 32, dtype=torch.bfloat16),) * 3,
                                  group_size=1), r"head dims \(32, 32\)"),
    (lambda: flash_attention_cuda(*(torch.randn(2, 8, 96, dtype=torch.bfloat16),) * 2,
                                  torch.randn(2, 8, 32, dtype=torch.bfloat16),
                                  group_size=1), r"head dims \(96, 32\)"),
    (lambda: flash_attention_cuda(*(torch.randn(2, 8, 96, dtype=torch.bfloat16),) * 2,
                                  torch.randn(2, 9, 64, dtype=torch.bfloat16),
                                  group_size=1), r"v \[BHkv, Skv, hd_v\]"),
    (lambda: flash_attention_cuda(*(torch.randn(2, 8, 16),) * 3, group_size=1),
     "bfloat16"),
    (lambda: flash_attention_cuda(torch.randn(4, 8, 16, dtype=torch.bfloat16),
                                  *(torch.randn(3, 8, 16, dtype=torch.bfloat16),) * 2,
                                  group_size=2), "group_size=2"),
])
def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(call, err):
    """No silent CPU path: the CUDA wrappers raise on CPU tensors and on
    shapes or dtypes their kernels are not built for."""
    with pytest.raises((ValueError, TypeError), match=err):
        call()


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version.
# ---------------------------------------------------------------------------


def _card(a: np.ndarray, dev, dt=torch.bfloat16):
    return torch.from_numpy(a).to(device=dev, dtype=dt)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Sq,Skv,hd,g,win,causal", [
    (128, 512, 512, 128, 8, None, True),   # yi prefill, 4 x 32 heads
    (16, 300, 300, 128, 8, None, True),    # ragged
    (16, 512, 512, 128, 8, 128, True),     # window
    (8, 100, 100, 64, 2, None, False),     # non-causal, ragged
    (8, 33, 77, 64, 4, None, True),        # Sq != Skv
    (32, 256, 256, 16, 4, None, True),     # yi smoke head_dim
    (4, 1, 1, 16, 1, None, True),          # one token
    (32, 4096, 4096, 128, 8, None, True),  # one yi sequence at its 4096 context
    (128, 4608, 4608, 120, 4, 4096, True),  # h2o-danube prefill, 4 x 32 heads, past its window
    (64, 512, 512, 256, 1, None, True),     # gemma prefill, 4 x 16 heads
    (128, 512, 512, 64, 1, None, True),     # musicgen prefill, 4 x 32 heads
    (32, 300, 300, 120, 4, None, True),     # ragged, hd 120
    (16, 300, 300, 256, 1, None, True),     # ragged, hd 256
    (32, 512, 512, 120, 4, 100, True),      # a window edge inside a 64-key tile
    (16, 512, 512, 256, 1, 50, True),       # ... inside a 32-key tile (hd 256)
    (8, 33, 77, 120, 4, None, True),        # Sq != Skv
    (8, 33, 77, 256, 2, None, False),       # Sq != Skv, non-causal
    (4, 1, 1, 120, 1, None, True),          # one token
    (8, 200, 200, 256, 1, 40, False),       # non-causal with a window
    (112, 512, 512, 128, 7, None, True),    # qwen2-vl prefill: 4 x 28 heads over 4 x 4, group 7
    (14, 300, 300, 128, 7, None, True),     # ... ragged
])
def test_flash_attention_kernel_on_card(cuda, BH, Sq, Skv, hd, g, win, causal):
    q = _card(RNG.randn(BH, Sq, hd).astype(np.float32), cuda)
    k = _card(RNG.randn(BH // g, Skv, hd).astype(np.float32), cuda)
    v = _card(RNG.randn(BH // g, Skv, hd).astype(np.float32), cuda)
    kw = dict(group_size=g, causal=causal, window=win)
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    assert ref.scaled_err(out, want) <= TOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Sq,Skv,hd,hdv,g,win,causal", [
    (160, 512, 512, 96, 64, 1, None, True),  # minicpm3's MLA prefill, 4 x 40 heads
    (40, 300, 300, 96, 64, 1, None, True),   # ragged
    (8, 33, 77, 96, 64, 2, None, False),     # Sq != Skv, GQA, non-causal
    (16, 200, 200, 96, 64, 1, 50, True),     # a window edge inside a 64-key tile
    (16, 64, 64, 24, 16, 1, None, True),     # minicpm3 smoke: q/k 24 (padded to 32), v 16
    (8, 100, 100, 24, 16, 2, 30, True),      # ... ragged, GQA, windowed
    (4, 1, 1, 96, 64, 1, None, True),        # one token
    (512, 512, 512, 192, 128, 1, None, True),  # deepseek-v2's MLA prefill, 4 x 128 heads
    (128, 300, 300, 192, 128, 1, None, True),  # ragged
    (8, 33, 77, 192, 128, 2, None, False),     # Sq != Skv, GQA, non-causal
    (16, 200, 200, 192, 128, 1, 50, True),     # a window edge inside a 32-key tile
    (4, 1, 1, 192, 128, 1, None, True),        # one token
])
def test_flash_attention_unequal_head_dims_on_card(cuda, BH, Sq, Skv, hd, hdv, g, win, causal):
    """v's head dim differs from q's and k's (MLA's expanded prefill): the
    output is [BH, Sq, hd_v], held to the plain version."""
    q = _card(RNG.randn(BH, Sq, hd).astype(np.float32), cuda)
    k = _card(RNG.randn(BH // g, Skv, hd).astype(np.float32), cuda)
    v = _card(RNG.randn(BH // g, Skv, hdv).astype(np.float32), cuda)
    kw = dict(group_size=g, causal=causal, window=win, scale=hd ** -0.5)
    n0 = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1 and out.shape == (BH, Sq, hdv)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    assert ref.scaled_err(out, want) <= TOL["bfloat16"]


# every width the repo's configs give RMSNorm (and 4104, whose 513 vectors
# fill no warp evenly), the smoke widths 8 and 96, at the decode step's and the
# prefill's T and one row more than the latter; then the widths past the
# register path's 16 warps x 4 vectors, which take the general kernel
RMSNORM_WIDTHS = (8, 96, 256, 512, 768, 1536, 2560, 3072, 3584, 3840, 4096, 4104, 5120, 6144,
                  8192)
RMSNORM_CASES = [(100, 96, torch.float32), (3, 64, torch.float32), (5, 8, torch.bfloat16)] + [
    (T, d, dt) for dt in (torch.bfloat16, torch.float32) for T in (1, 4, 2048, 2049)
    for d in RMSNORM_WIDTHS] + [
    (3, 8200, torch.float32), (300, 8200, torch.float32), (3, 16392, torch.bfloat16)] + [
    # musicgen's width, and h2o-danube's prefill of 4 x 4608 tokens
    (T, 2048, torch.bfloat16) for T in (4, 2048)] + [(18432, 3840, torch.bfloat16)]


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,dt", RMSNORM_CASES)
def test_rmsnorm_kernel_on_card(cuda, T, d, dt):
    x = _card(RNG.randn(T, d).astype(np.float32), cuda, dt)
    w = _card(RNG.rand(d).astype(np.float32) + 0.5, cuda, dt)
    n0 = ops.rmsnorm.launches
    out = ops.rmsnorm(x, w)
    torch.cuda.synchronize()
    assert ops.rmsnorm.launches == n0 + 1 and out.dtype == dt
    want = ref.rmsnorm_ref(x.float(), w.float())
    tol = TOL["bfloat16"] if dt == torch.bfloat16 else TOL["float32"]
    assert ref.scaled_err(out, want) <= tol


@pytest.mark.cuda
def test_rmsnorm_wrapper_refuses_an_unaligned_w(cuda):
    """w is read in 16-byte vectors: a w one element into its storage is
    refused."""
    x = torch.randn(4, 64, device=cuda, dtype=torch.bfloat16)
    w = torch.rand(65, device=cuda, dtype=torch.bfloat16)[1:]
    assert w.is_contiguous() and w.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte aligned"):
        rmsnorm_cuda(x, w)


def _scan_on_card(dev, B, S, di, N, with_h0, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    a = torch.rand(B, S, di, N, generator=gen, device=dev) * 0.9
    b = torch.randn(B, S, di, N, generator=gen, device=dev) * 0.1
    c = torch.randn(B, S, N, generator=gen, device=dev)
    h0 = torch.randn(B, di, N, generator=gen, device=dev) * 0.1 if with_h0 else None
    return a, b, c, h0


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,N,with_h0", [
    (4, 512, 8192, 16, False),  # falcon-mamba prefill, 4 x 512 tokens
    (4, 300, 8192, 16, False),  # ragged
    (2, 128, 1024, 16, True),   # nonzero initial state
    (2, 96, 128, 8, True),      # smoke config's d_state
    (3, 64, 16, 4, False),      # reference tests' d_state
    (3, 7, 5, 4, True),         # 60 state elements: a partial warp
    (2, 33, 40, 32, True),      # N = 32, one channel per warp
    (2, 1, 8, 1, True),         # one step, N = 1
])
def test_mamba_scan_kernel_on_card(cuda, B, S, di, N, with_h0):
    """fp32 on both sides and the state rounded alike: h_last bit for bit,
    y to 1e-5 (only the order of the readout's sum over n differs)."""
    a, b, c, h0 = _scan_on_card(cuda, B, S, di, N, with_h0)
    n0 = ops.mamba_scan.launches
    y, h = ops.mamba_scan(a, b, c, h0)
    torch.cuda.synchronize()
    assert ops.mamba_scan.launches == n0 + 1
    want_y, want_h = ref.mamba_scan_ref(a, b, c, h0)
    assert ref.scaled_err(y, want_y) <= TOL["float32"]
    assert ref.scaled_err(h, want_h) <= TOL["float32"]
    torch.testing.assert_close(h, want_h, rtol=0, atol=0)


@pytest.mark.cuda
def test_mamba_scan_wrapper_refuses_a_strided_card_tensor(cuda):
    a, b, c, _ = _scan_on_card(cuda, 2, 8, 16, 4, False)
    with pytest.raises(ValueError, match="contiguous"):
        mamba_scan_cuda(a[:, ::2], b[:, ::2], c[:, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dt", [
    ((2, 4, 768, 5120), torch.bfloat16),  # EP dispatch of 1024 tokens x top-6 per rank
    ((4, 2, 768, 5120), torch.bfloat16),
    ((3, 4, 8, 16), torch.float32),       # the reference tests' shapes
    ((2, 2, 4, 4), torch.float32),
    ((8, 1, 2, 32), torch.float32),
    ((2, 3, 5, 7), torch.bfloat16),       # 70-byte tiles: vectors and a tail, or bytes
    ((3, 5, 1, 3), torch.uint8),          # 3-byte tiles
    ((2, 2, 16, 16), torch.float64),
])
def test_a2a_pack_kernel_on_card(cuda, shape, dt):
    """A copy: bit for bit against the plain version, in any dtype."""
    x = torch.randn(*shape, device=cuda).mul(100).to(dt)
    n0 = ops.a2a_pack.launches
    out = ops.a2a_pack(x)
    torch.cuda.synchronize()
    assert ops.a2a_pack.launches == n0 + 1
    assert out.dtype == dt and out.shape == (shape[1], shape[0]) + shape[2:]
    assert torch.equal(out, ref.a2a_pack_ref(x))


@pytest.mark.cuda
def test_a2a_pack_wrapper_refuses_a_strided_card_tensor(cuda):
    x = torch.randn(4, 2, 3, 8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        a2a_pack_cuda(x.transpose(0, 1))


# The training path's kernels: the forward's lse, the flash backward and the
# RMSNorm backward, against their plain versions (bf16 at 2e-2, lse and
# delta at 1e-5).

FLASH_BWD_CASES = [  # BH, S, hd, hd_v, g, window
    (32, 512, 128, 128, 8, None),   # yi's 32 heads over 4, one sequence
    (16, 300, 128, 128, 8, None),   # ragged
    (16, 512, 128, 128, 8, 100),    # a window edge inside a 64-row tile
    (32, 256, 16, 16, 4, None),     # yi smoke's head dim
    (8, 77, 16, 16, 2, 24),         # ragged, windowed
    (4, 2, 128, 128, 1, None),      # two tokens
    (32, 2048, 128, 128, 8, None),  # yi's training shape: one 2048-token sequence
    (28, 512, 128, 128, 7, None),   # qwen2-vl's group of 7
    (16, 512, 256, 256, 1, None),   # gemma: dK, dV and dQ in column halves
    (8, 300, 256, 256, 1, 100),     # ... ragged, windowed
    (32, 512, 120, 120, 4, None),   # danube: 120 padded to 128
    (32, 600, 120, 120, 4, 100),    # ... a window edge inside a tile, ragged
    (32, 512, 64, 64, 1, None),     # musicgen
    (40, 512, 96, 64, 1, None),     # minicpm3's MLA pair (64-byte swizzle at 96)
    (8, 300, 96, 64, 2, 40),        # ... ragged, windowed, a group of 2
    (32, 512, 192, 128, 1, None),   # deepseek-v2's MLA pair (column halves of 96 and 64)
    (8, 77, 192, 128, 1, None),     # ... ragged
    (16, 256, 24, 16, 1, None),     # minicpm3 smoke's pair: 24 padded to 32
    (8, 77, 24, 16, 2, 24),         # ... ragged, windowed
]


def _bwd_err(got, want) -> float:
    """The largest of dq's ``ref.dq_scaled_err`` and dk's and dv's
    ``ref.scaled_err``: a causal first row's dq is 0 in exact arithmetic."""
    return max(ref.dq_scaled_err(got[0], want[0]),
               *(ref.scaled_err(a, b) for a, b in zip(got[1:], want[1:])))


def _flash_train_inputs(dev, BH, S, hd, g, hdv=None):
    """q [BH, S, hd], k [BH // g, S, hd], v [BH // g, S, hd_v], do [BH, S,
    hd_v] in bf16 on the card, each the head of a longer allocation (a
    planted fault reading past a row's end reads memory that is there)."""
    hdv = hdv or hd

    def mk(*shape):
        return _with_slack(_card(RNG.randn(*shape).astype(np.float32), dev).flatten()).view(shape)

    return mk(BH, S, hd), mk(BH // g, S, hd), mk(BH // g, S, hdv), mk(BH, S, hdv)


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,hd,hdv,g,win", FLASH_BWD_CASES)
def test_flash_attention_lse_on_card(cuda, BH, S, hd, hdv, g, win):
    """The training forward's output equals the serving instance's bit for
    bit, and its lse matches the plain version's at 1e-5."""
    q, k, v, _ = _flash_train_inputs(cuda, BH, S, hd, g, hdv)
    kw = dict(group_size=g, causal=True, window=win)
    n0 = ops.flash_attention.launches
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    assert lse.shape == (BH, S) and lse.dtype == torch.float32
    want, want_lse = ref.flash_attention_ref(q.float(), k.float(), v.float(), return_lse=True,
                                             **kw)
    assert ref.scaled_err(out, want) <= TOL["bfloat16"]
    assert ref.scaled_err(lse, want_lse) <= TOL["float32"]
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("BH,S,hd,hdv,g,win", FLASH_BWD_CASES)
def test_flash_attention_backward_on_card(cuda, BH, S, hd, hdv, g, win):
    """dq, dk and dv against the plain version (2e-2; dq's first row at its
    head's scale, ``ref.dq_scaled_err``), delta at 1e-5, and the same bits
    from a second call (no atomics)."""
    q, k, v, do = _flash_train_inputs(cuda, BH, S, hd, g, hdv)
    kw = dict(group_size=g, causal=True, window=win)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    n0 = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == n0 + 1
    want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                       do.float(), **kw)
    assert all(a.shape == b.shape and a.dtype == torch.bfloat16 for a, b in zip(got, want))
    assert _bwd_err(got, want) <= TOL["bfloat16"]
    *again, delta = flash_attention_bwd_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert ref.scaled_err(delta, (do.float() * o.float()).sum(-1)) <= TOL["float32"]


RMSNORM_BWD_CASES = [  # T, d, dtype
    (2048, 4096, torch.bfloat16),  # yi's width at a microbatch of 2048 tokens
    (2049, 4096, torch.bfloat16),  # ragged
    (2048, 64, torch.bfloat16),    # the smoke configs' width
    (3, 8, torch.bfloat16),
    (100, 96, torch.float32),
    (5, 4104, torch.bfloat16),     # 513 vectors: no warp filled evenly
    (5, 4000, torch.float32),      # 1000 vectors
    (1, 8192, torch.bfloat16),     # the widest the kernel takes
] + [  # the configs' other widths at a microbatch of 2048 tokens (danube, gemma,
    # musicgen, minicpm3's hidden, q_norm and kv_norm, qwen2-vl)
    (2048, d, torch.bfloat16) for d in (3840, 3072, 2048, 2560, 768, 256, 3584)] + [
    # fewer rows than the grid holds
    (1, 4096, torch.bfloat16), (4, 4096, torch.bfloat16), (130, 4096, torch.bfloat16),
    (1, 64, torch.bfloat16), (4, 256, torch.bfloat16), (130, 768, torch.bfloat16),
    # ragged narrow rows, and fp32
    (2049, 256, torch.bfloat16),   # two rows a warp
    (2047, 64, torch.bfloat16),    # four rows a warp
    (2048, 4096, torch.float32),   # 4 vectors a lane
    (2048, 256, torch.float32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("T,d,dt", RMSNORM_BWD_CASES)
def test_rmsnorm_backward_on_card(cuda, T, d, dt):
    x = _card(RNG.randn(T, d).astype(np.float32), cuda, dt)
    w = _card(RNG.rand(d).astype(np.float32) + 0.5, cuda, dt)
    dy = _card(RNG.randn(T, d).astype(np.float32), cuda, dt)
    n0 = ops.rmsnorm_bwd.launches
    dx, dw = ops.rmsnorm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert ops.rmsnorm_bwd.launches == n0 + 1 and dx.dtype == dw.dtype == dt
    want_dx, want_dw = ref.rmsnorm_bwd_ref(x.float(), w.float(), dy.float())
    tol = TOL["bfloat16"] if dt == torch.bfloat16 else TOL["float32"]
    assert ref.scaled_err(dx, want_dx) <= tol
    assert ref.scaled_err(dw, want_dw) <= tol
    assert all(torch.equal(a, b) for a, b in zip((dx, dw), rmsnorm_bwd_cuda(x, w, dy)))


@pytest.mark.cuda
@pytest.mark.parametrize("T,d", [(2048, 4096), (2049, 256), (2048, 64)])
def test_rmsnorm_backward_graph_replays_give_the_same_bits(cuda, T, d):
    """A call captured in a CUDA graph and replayed twice, with an eager call
    between the replays, gives the eager call's bits each time: dw is summed
    in a fixed order, and the grid barrier's counter is back at 0 after
    every launch."""
    x, dy = (_card(RNG.randn(T, d).astype(np.float32), cuda, torch.bfloat16) for _ in range(2))
    w = _card(RNG.rand(d).astype(np.float32) + 0.5, cuda, torch.bfloat16)
    want = rmsnorm_bwd_cuda(x, w, dy)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = rmsnorm_bwd_cuda(x, w, dy)
    for _ in range(2):
        for t in got:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert all(torch.equal(a, b) for a, b in zip(rmsnorm_bwd_cuda(x, w, dy), want))


# Faults planted in copies of the kernels' sources, each of a kind a kernel
# like these can ship with: the check above must refuse every one of them at
# the serving shapes, where the sound kernels pass it.
PLANTED_FAULTS = {  # name: (kernel, sound line, faulty line)
    "flash_last_tile_skipped_from_row_256": (
        "flash_attention", "const int kt_hi = causal ? min(nk, q_last / BK + 1) : nk;",
        "const int kt_hi = (causal ? min(nk, q_last / BK + 1) : nk) - (q0 >= 256);"),
    "flash_rescale_by_alpha_left_out": (
        "flash_attention",
        "for (int nb = 0; nb < NO; ++nb) { acc[nb][2 * i] *= alpha; acc[nb][2 * i + 1] *= alpha; }",
        "for (int nb = 0; nb < NO; ++nb) {}"),
    "flash_window_one_key_too_many": (
        "flash_attention", "ok = ok && (kp > qp - window);", "ok = ok && (kp >= qp - window);"),
    "flash_ring_read_before_its_group_landed": (
        "flash_attention", "cp_async_wait<1>();  // K tile it has landed (and Q, at it = 0)", ""),
    "flash_hd120_pad_vector_from_the_next_row": (
        "flash_attention",
        "const int bytes = gr < n && c < HD ? 16 : 0;  // zeros past the end and in the pad",
        "const int bytes = gr < n ? 16 : 0;"),
    "flash_hd256_second_half_of_the_columns_unwritten": (
        "flash_attention", "for (int nb = 0; nb < HDV / 8; ++nb)",
        "for (int nb = 0; nb < (HDV == 256 ? HDV / 16 : HDV / 8); ++nb)"),
    "flash_mla_last_v_column_block_unwritten": (
        "flash_attention", "for (int nb = 0; nb < HDV / 8; ++nb)",
        "for (int nb = 0; nb < (HDQK != HDV ? HDV / 8 - 2 : HDV / 8); ++nb)"),
    "flash_mla192_rope_columns_left_out_of_the_score": (
        "flash_attention", "for (int kk = 0; kk < KQ; ++kk) {",
        "for (int kk = 0; kk < (HDQK == 192 ? KQ - 4 : KQ); ++kk) {"),
    "flash_bwd_delta_dropped": (
        "flash_attention_bwd", "if (row < rows && lane % LPR == 0) delta[row] = s;  // rowsum(dO * O)",
        "if (row < rows && lane % LPR == 0) delta[row] = 0.f;"),
    "flash_bwd_dkdv_over_one_head_of_the_group": (
        "flash_attention_bwd", "const int bh = bkv * group + h0 + it / nqt;",
        "const int bh = bkv * group + it / nqt;"),
    "flash_bwd_diagonal_tile_unmasked": (
        "flash_attention_bwd", "const bool edge = q0 + BN > S || (causal && q0 < k0 + BM) ||",
        "const bool edge = q0 + BN > S ||"),
    "flash_bwd_last_partial_dropped": (
        "flash_attention_bwd", "for (int j = 1; j < slices; ++j) {  // the partials in slice order",
        "for (int j = 1; j < slices - 1; ++j) {"),
    "flash_bwd_mla_dv_plane_at_hdqk_width": (
        "flash_attention_bwd", "float* const rv = pv + (size_t)kp * HDV + c0v + 2 * t;",
        "float* const rv = pv + (size_t)kp * HDQK + c0v + 2 * t;"),
    "flash_bwd_hd256_second_dk_half_dropped": (
        "flash_attention_bwd",
        "make_float2(dka[4 * nb + 2 * i], dka[4 * nb + 2 * i + 1]);  // dK",
        "c0q ? make_float2(0.f, 0.f) : make_float2(dka[4 * nb + 2 * i], dka[4 * nb + 2 * i + 1]);"),
    "flash_bwd_hd120_pad_columns_unzeroed": (
        "flash_attention_bwd",
        "const int bytes = gr < n && c * 8 < HD ? 16 : 0;  // zeros past the end and in the pad",
        "const int bytes = gr < n ? 16 : 0;"),
    "flash_bwd_mla_delta_read_at_hdqk": (
        "flash_attention_bwd", "constexpr int VPR = HDV / 8;  // 16-byte vectors of a row of o or dO",
        "constexpr int VPR = HDQK / 8;"),
    "rmsnorm_last_row_not_prefetched": (
        "rmsnorm", "if (next < T_rows) load(nxt, (int)next);  // in flight while this row reduces",
        "if (next < T_rows - 1) load(nxt, (int)next);"),
    "rmsnorm_w_vector_from_the_next_column": (
        "rmsnorm", "if (i < nvec) wv[k] = wr[i];", "if (i < nvec) wv[k] = wr[i ^ 1];"),
    "rmsnorm_block_step_last_warp_left_out": (
        "rmsnorm", "return warp_sum(lane < W ? part[lane] : 0.f);",
        "return warp_sum(lane < W - 1 ? part[lane] : 0.f);"),
    "rmsnorm_bwd_last_partial_row_left_out": (
        "rmsnorm_bwd", "const int r1 = min(r0 + chunk, rows);  // this thread's share of the partial rows",
        "const int r1 = min(r0 + chunk, rows - 1);"),
    "rmsnorm_bwd_last_row_not_prefetched": (
        "rmsnorm_bwd", "if (next < T_rows) copy_row((it + kDepth) % S, (int)next);  // in flight while this row reduces",
        "if (next < T_rows - 1) copy_row((it + kDepth) % S, (int)next);"),
    "rmsnorm_bwd_segment_shuffle_reaches_the_next_row": (
        "rmsnorm_bwd", "for (int off = L >> 1; off > 0; off >>= 1) {  // inside the row's segment",
        "for (int off = L; off > 0; off >>= 1) {"),
    "rmsnorm_bwd_last_team_left_out_of_the_cta_row": (
        "rmsnorm_bwd", "for (int u = 0; u < units; ++u) s += smem[(size_t)u * d + c];  // in unit order",
        "for (int u = 0; u < units - 1; ++u) s += smem[(size_t)u * d + c];"),
    "scan_state_dropped_at_half": (
        "mamba_scan", "h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);",
        "h = __fadd_rn(__fmul_rn(av[u], t0 + u == S / 2 ? 0.f : h), bv[u]);"),
    "scan_readout_last_lane_left_out": (
        "mamba_scan", "float p = __fmul_rn(h, cv[u]);",
        "float p = n == N - 1 ? 0.f : __fmul_rn(h, cv[u]);"),
    "pack_tile_written_to_o_i": (
        "a2a_pack", "uint8_t* dst = out + (i * No + o) * tile_bytes;",
        "uint8_t* dst = out + t * tile_bytes;"),
    "pack_tail_bytes_dropped": (
        "a2a_pack", "b < tile_bytes; b += (long long)gridDim.x * kThreads)",
        "b < nvec * 16; b += (long long)gridDim.x * kThreads)"),
    "pack_chunk_stride_off_by_one_vector": (
        "a2a_pack", "const long long chunk0 = (long long)blockIdx.x * kChunk;",
        "const long long chunk0 = (long long)blockIdx.x * (kChunk + 1);"),
}


@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_planted_fault_names_a_line_of_its_source(fault):
    """Each fault's sound line occurs exactly once in its kernel's source, so
    a rewrite that strands a fault is found here and not only on the card."""
    from repro_torch.kernels import build

    kernel, sound, faulty = PLANTED_FAULTS[fault]
    assert kernel in build.KERNELS and sound != faulty
    assert (build.SRC_DIR / f"{kernel}.cu").read_text().count(sound) == 1


@pytest.fixture(scope="module")
def faulty_libraries(tmp_path_factory):
    """Every planted fault built at once, each into a library of its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    from repro_torch.kernels import build

    root = tmp_path_factory.mktemp("planted")
    jobs = {}
    for name, (kernel, sound, faulty) in PLANTED_FAULTS.items():
        src = (build.SRC_DIR / f"{kernel}.cu").read_text()
        assert src.count(sound) == 1, f"{name}: the sound line is not in {kernel}.cu"
        (root / f"{name}.cu").write_text(src.replace(sound, faulty))
        jobs[name] = (root / f"{name}.cu", root / f"{name}.so")
    build.compile_sources(jobs)
    return {name: target for name, (_, target) in jobs.items()}


def _with_slack(x: torch.Tensor) -> torch.Tensor:
    """``x`` in bf16 as the head of a longer allocation: a faulty kernel
    that reads one vector past a row's end reads memory that is there."""
    buf = torch.empty(x.numel() + 64, dtype=torch.bfloat16, device=x.device)
    return buf[:x.numel()].copy_(x)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_planted_faults_fail_the_check(cuda, faulty_libraries, monkeypatch, fault):
    import importlib

    from repro_torch.kernels import build

    kernel = PLANTED_FAULTS[fault][0]
    gen = torch.Generator(device=cuda).manual_seed(0)
    tol = TOL["bfloat16"]
    if kernel == "a2a_pack":  # a copy: the check is equality
        shape = (2, 3, 5, 7) if "tail" in fault else (2, 4, 768, 5120)
        x = torch.randn(*shape, generator=gen, device=cuda).to(torch.bfloat16)
        want = ref.a2a_pack_ref(x)  # kept alive, so no output reuses its memory
        sound = a2a_pack_cuda(x)
        module = importlib.import_module("repro_torch.kernels.a2a_pack")
        monkeypatch.setitem(build._LIBS, kernel,
                            build.load(faulty_libraries[fault], module._SIGNATURES))
        faulty = a2a_pack_cuda(x)
        torch.cuda.synchronize()
        print(f"\n[planted] {fault}: sound equal {torch.equal(sound, want)}, faulty equal "
              f"{torch.equal(faulty, want)}, faulty bytes differing "
              f"{int((faulty.view(torch.uint8) != want.view(torch.uint8)).sum())}")
        assert torch.equal(sound, want) and not torch.equal(faulty, want)
        return
    if kernel == "rmsnorm":  # the prefill shape with one row more: a ragged share
        x = torch.randn(2049, 4096, generator=gen, device=cuda).to(torch.bfloat16)
        w = (torch.rand(4096, generator=gen, device=cuda) + 0.5).to(torch.bfloat16)
        call = lambda: rmsnorm_cuda(x, w, 1e-6)  # noqa: E731
        want = ref.rmsnorm_ref(x.float(), w.float(), eps=1e-6)
    elif kernel == "rmsnorm_bwd":  # yi's microbatch with one row more; the smoke width
        T, d = (2048, 64) if "segment" in fault else (2049, 4096)
        x, dy = (torch.randn(T, d, generator=gen, device=cuda).to(torch.bfloat16)
                 for _ in range(2))
        w = (torch.rand(d, generator=gen, device=cuda) + 0.5).to(torch.bfloat16)
        call = lambda: rmsnorm_bwd_cuda(x, w, dy)  # noqa: E731
        want = ref.rmsnorm_bwd_ref(x.float(), w.float(), dy.float())
    elif kernel == "mamba_scan":
        a, b, c, _ = _scan_on_card(cuda, 4, 512, 8192, 16, False)
        call = lambda: mamba_scan_cuda(a, b, c)[0]  # noqa: E731
        want = ref.mamba_scan_ref(a, b, c)[0]
        tol = TOL["float32"]
    elif kernel == "flash_attention_bwd":  # yi's heads, one sequence; dq, dk and dv; the
        # head-dim faults at danube's, gemma's and minicpm3's heads
        BH, hd, hdv, g = ((32, 120, 120, 4) if "hd120" in fault else
                          (16, 256, 256, 1) if "hd256" in fault else
                          (40, 96, 64, 1) if "mla" in fault else (32, 128, 128, 8))
        q, k, v, do = _flash_train_inputs(cuda, BH, 512, hd, g, hdv)
        o, lse = flash_attention_cuda(q, k, v, group_size=g, return_lse=True)
        o = _with_slack(o.flatten()).view(o.shape)
        call = lambda: flash_attention_bwd_cuda(q, k, v, o, lse, do, group_size=g)[:3]  # noqa: E731
        want = ref.flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), lse,
                                           do.float(), group_size=g)
    else:  # yi's prefill; the hd faults at h2o-danube's, gemma's, deepseek-v2's and minicpm3's
        n, g, hd, hdv = ((128, 4, 120, 120) if "hd120" in fault else
                         (64, 1, 256, 256) if "hd256" in fault else
                         (128, 1, 192, 128) if "mla192" in fault else
                         (160, 1, 96, 64) if "mla" in fault else (128, 8, 128, 128))
        q, k, v = (_with_slack(torch.randn(m * 512 * d, generator=gen, device=cuda))
                   .view(m, 512, d) for m, d in ((n, hd), (n // g, hd), (n // g, hdv)))
        kw = dict(group_size=g, causal=True,
                  window=128 if "window" in fault else None)
        call = lambda: flash_attention_cuda(q, k, v, **kw)  # noqa: E731
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    sound = call()
    module = importlib.import_module(f"repro_torch.kernels.{kernel}")
    monkeypatch.setitem(build._LIBS, kernel,
                        build.load(faulty_libraries[fault], module._SIGNATURES))
    faulty = call()
    torch.cuda.synchronize()
    if kernel in ("flash_attention_bwd", "rmsnorm_bwd"):  # several outputs
        err = _bwd_err if kernel == "flash_attention_bwd" else (
            lambda got, want: max(ref.scaled_err(a, b) for a, b in zip(got, want)))
        errs = {name: (err(out, want), max(((a.float() - b.float()).abs().max()
                                            / b.float().abs().max()).item()
                                           for a, b in zip(out, want)))
                for name, out in (("sound", sound), ("faulty", faulty))}
    else:
        errs = {name: (ref.scaled_err(out, want),
                       ((out.float() - want).abs().max() / want.abs().max()).item())
                for name, out in (("sound", sound), ("faulty", faulty))}
    print(f"\n[planted] {fault}: scaled err sound {errs['sound'][0]:.6g}, faulty "
          f"{errs['faulty'][0]:.6g} (tol {tol}); error over the largest "
          f"value: sound {errs['sound'][1]:.6g}, faulty {errs['faulty'][1]:.6g}")
    # the check is ``err <= tol``: a faulty output of NaNs fails it too
    assert errs["sound"][0] <= tol and not errs["faulty"][0] <= tol

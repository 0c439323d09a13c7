"""CPU tests of the plain references against the port's plain path (the
port's smoke configs in float32, where every kernel runs its plain
version), of the chunked scan against the plain recurrence, and of the
references' training gradients against autograd through the port."""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import pytest
import torch

from portbench import weights
from portbench.reference import llama as ref_llama
from portbench.reference import mamba as ref_mamba

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _src_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "src"))


def _smoke(arch: str):
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


FAMILIES = {"yi_6b": ref_llama, "falcon_mamba_7b": ref_mamba}


def _sizes(fam, cfg) -> dict:
    """A configuration file's keys at the port's smoke sizes."""
    out = {key: get(cfg) for key, get in fam.WIDTHS.items()}
    out.update({key: getattr(cfg, field) for key, field in fam.SET.items()})
    return out


def _setup(arch: str, seed: int):
    from repro_torch.models import lm

    cfg = _smoke(arch)
    shapes = weights.leaf_shapes(lm.model_meta(cfg))
    flat = weights.draw(shapes, seed, "cpu", dtype=torch.float32)
    return cfg, shapes, flat


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_reference_logits_equal_the_ports_prefill(arch):
    from repro_torch.models import lm

    cfg, _, flat = _setup(arch, 2**31 + 5)
    params = weights.unflatten_tree(flat)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (3, 40), generator=g)
    ref = FAMILIES[arch].Model(_sizes(FAMILIES[arch], cfg), flat)
    for S in (1, 17, 40):
        want, _ = lm.prefill(cfg, params, {"tokens": toks[:, :S]}, capacity=48)
        rows = torch.arange(3)
        got = ref.logits_at(toks[:, :40], rows, torch.full((3,), S - 1))
        err = (got - want.float()).abs().max() / want.abs().max()
        assert err < 2e-5, (S, float(err))


def _recurrence(dt, x, Bm, Cm, A):
    b, S, di = x.shape
    h = torch.zeros(b, di, A.shape[1], dtype=torch.float64)
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t, :, None].double() * A.double())
        h = a * h + (dt[:, t] * x[:, t]).double()[..., None] * Bm[:, t, None, :].double()
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t].double()))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("dt_scale", [0.05, 3.0, 40.0])
def test_chunked_scan_equals_the_recurrence(dt_scale):
    g = torch.Generator().manual_seed(3)
    b, S, di, N = 2, 77, 6, 5
    dt = torch.rand(b, S, di, generator=g) * dt_scale
    x, Bm, Cm = (torch.randn(*s, generator=g) for s in ((b, S, di), (b, S, N), (b, S, N)))
    A = -torch.exp(torch.randn(di, N, generator=g))
    got = ref_mamba.scan(dt, x, Bm, Cm, A)
    want = _recurrence(dt, x, Bm, Cm, A)
    assert torch.allclose(got.double(), want, rtol=1e-4, atol=1e-5 * want.abs().max())


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_reference_training_gradient_equals_autograd_through_the_port(arch):
    from repro_torch.models import lm

    cfg, shapes, flat = _setup(arch, 9)
    g = torch.Generator().manual_seed(2)
    ids = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    params = {p: t.clone().requires_grad_() for p, t in flat.items()}
    loss, _ = lm.loss_fn(cfg, weights.unflatten_tree(params), batch)
    loss.backward()
    ref = FAMILIES[arch].Model(_sizes(FAMILIES[arch], cfg), {})
    rp = {p: ([t[i].clone().requires_grad_() for i in range(t.shape[0])]
              if p.startswith("blocks/") else t.clone().requires_grad_())
          for p, t in flat.items()}
    rl = ref.loss(rp, batch["tokens"], batch["labels"])
    rl.backward()
    assert float(rl.detach()) == pytest.approx(float(loss.detach()), rel=1e-5)
    for p in flat:
        want = params[p].grad
        got = torch.stack([t.grad for t in rp[p]]) if isinstance(rp[p], list) else rp[p].grad
        scale = max(float(want.abs().max()), 1e-12)
        assert float((got - want).abs().max()) / scale < 1e-4, p


def test_fp8_control_rounds_each_product_and_its_gradient():
    from portbench.reference.common import Matmul

    g = torch.Generator().manual_seed(4)
    x = torch.randn(8, 16, generator=g, requires_grad=True)
    w = torch.randn(16, 4, generator=g, requires_grad=True)
    y8 = Matmul("fp8")(x, w)
    y = x @ w
    rel = float((y8 - y).abs().max() / y.abs().max())
    assert 1e-3 < rel < 0.2  # e4m3: 3 mantissa bits
    y8.sum().backward()
    assert x.grad is not None and w.grad is not None
    assert math.isfinite(float(w.grad.sum()))

"""The dry-run's shapes and specs (``repro_torch.launch.specs``,
``models/params.partition_specs``, ``lm.abstract_model`` /
``abstract_cache``, ``training/train_step``'s specs) against the
reference's.

The first tests mirror ``tests/test_launch_specs.py`` case for case; the
rest hold every spec and every abstract shape to the reference's for all
ten configs.  A reference ``PartitionSpec`` is read as a tuple, which is
the port's spec.  The reference's spec functions read only a mesh's axis
names and ``devices.shape``, so the production meshes (256 and 512
devices) are given to them as such a record, with no devices behind it.
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import specs as RSP
from repro.models import lm as ref_lm
from repro.models import params as ref_params
from repro.training import train_step as ref_ts
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models import lm
from repro_torch.models.params import map_tree, partition_specs
from repro_torch.training import train_step as TS

MESHES = {"test": make_test_mesh((2, 2, 2)), "single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}


def _ref_mesh(mesh):
    """The port's mesh shape as the reference's spec functions read a mesh."""
    return types.SimpleNamespace(axis_names=mesh.axis_names,
                                 devices=np.empty(mesh.shape, dtype=np.int8))


def _flat(tree) -> dict:
    """The port's tree by "/"-joined path."""
    out = {}
    map_tree(lambda path, leaf: out.__setitem__(path, leaf), tree)
    return out


def _ref_flat(tree) -> dict:
    """The reference's pytree (dicts of arrays, structs or PartitionSpecs) by
    "/"-joined path; a PartitionSpec as a tuple."""
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(str(k.key) for k in path): (tuple(leaf) if isinstance(leaf, P) else leaf)
            for path, leaf in leaves}


def _same_struct(port: torch.Tensor, ref) -> bool:
    return tuple(port.shape) == tuple(ref.shape) and \
        str(port.dtype).removeprefix("torch.") == str(ref.dtype) and port.is_meta


# --- tests/test_launch_specs.py ----------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_structs_all_shapes(arch):
    cfg = get_config(arch)
    for shape in SHAPES.values():
        b = SP.batch_structs(cfg, shape.global_batch, shape.seq_len)
        for leaf in b.values():
            assert leaf.shape[0] == shape.global_batch
        if cfg.embed_inputs:
            assert b["tokens"].shape[1] == shape.seq_len
        else:
            assert b["embeds"].shape[-1] == cfg.d_model


def test_eligibility_matrix():
    eligible_500k = {a for a in ARCH_IDS
                     if SP.cell_eligible(get_config(a), SHAPES["long_500k"])[0]}
    assert eligible_500k == {"falcon_mamba_7b", "jamba_1_5_large_398b", "h2o_danube_3_4b"}
    for a in ARCH_IDS:  # every other shape runs everywhere
        for s in ("train_4k", "prefill_32k", "decode_32k"):
            assert SP.cell_eligible(get_config(a), SHAPES[s])[0]
    # 40 cells = 33 runnable + 7 documented skips
    runnable = sum(1 for a in ARCH_IDS for s in SHAPES.values()
                   if SP.cell_eligible(get_config(a), s)[0])
    assert runnable == 33


@pytest.mark.parametrize("arch", ["yi_6b", "deepseek_v2_236b", "jamba_1_5_large_398b",
                                  "falcon_mamba_7b"])
def test_cache_pspecs_valid(arch):
    mesh = MESHES["test"]
    cfg = get_config(arch)
    cache = lm.abstract_cache(cfg, 128, 1024)
    specs = SP.cache_pspecs(cfg, mesh, cache)
    sizes = mesh.axis_sizes
    for path, leaf in _flat(cache).items():
        spec = _flat(specs)[path]
        assert len(spec) <= leaf.dim()
        for dim, ax in zip(leaf.shape, spec):
            if ax is None:
                continue
            n = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                n *= sizes[a]
            assert dim % n == 0, (arch, tuple(leaf.shape), spec)


def test_batch_pspec_replicates_tiny_batch():
    tok = SP.decode_token_struct(get_config("yi_6b"), 1)  # long_500k batch=1
    assert SP.batch_pspecs(MESHES["test"], tok) == ()


def test_decode_token_struct_families():
    assert SP.decode_token_struct(get_config("musicgen_large"), 4).shape == (4, 1, 4)
    assert SP.decode_token_struct(get_config("yi_6b"), 4).shape == (4, 1)
    q = SP.decode_token_struct(get_config("qwen2_vl_7b"), 4)
    assert q.shape == (4, 1, 3584) and q.dtype == torch.bfloat16


# --- against the reference, every config --------------------------------------


def test_shapes_match_the_reference():
    assert SHAPES == {k: type(next(iter(SHAPES.values())))(**vars(v))
                      for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_partition_specs_match_the_reference(arch):
    """Both production meshes (and the test mesh), FSDP on and off, and the
    train step's ZeRO-1 moment specs."""
    meta, ref_meta = lm.model_meta(get_config(arch)), ref_lm.model_meta(ref_config(arch))
    for name, mesh in MESHES.items():
        for fsdp in (True, False):
            got = _flat(partition_specs(meta, mesh.axis_sizes, fsdp=fsdp))
            want = _ref_flat(ref_params.partition_specs(ref_meta, mesh.axis_sizes, fsdp=fsdp))
            assert got == want, (name, fsdp)
        assert _flat(TS.param_pspecs(get_config(arch), mesh)) == \
            _ref_flat(ref_ts.param_pspecs(ref_config(arch), _ref_mesh(mesh)))
        assert _flat(TS.opt_pspecs(get_config(arch), mesh)) == \
            _ref_flat(ref_ts.opt_pspecs(ref_config(arch), _ref_mesh(mesh)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_abstract_model_and_cache_match_eval_shape(arch):
    """Full width: every leaf's shape and dtype, on the meta device."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    got, want = _flat(lm.abstract_model(cfg)), _ref_flat(ref_lm.abstract_model(rcfg))
    assert got.keys() == want.keys()
    assert all(_same_struct(got[k], want[k]) for k in got)
    for batch, capacity in ((4, 4096), (1, 524288)):
        got = _flat(lm.abstract_cache(cfg, batch, capacity))
        want = _ref_flat(ref_lm.abstract_cache(rcfg, batch, capacity))
        assert got.keys() == want.keys()
        assert all(_same_struct(got[k], want[k]) for k in got), (batch, capacity)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_structs_and_specs_match_the_reference(arch):
    """Every shape's batch and decode token, their specs, the cache specs
    and the train step's batch spec, on every mesh."""
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape in SHAPES.values():
        B, S = shape.global_batch, shape.seq_len
        got, want = SP.batch_structs(cfg, B, S), RSP.batch_structs(rcfg, B, S)
        assert got.keys() == want.keys()
        assert all(_same_struct(got[k], want[k]) for k in got)
        tok, rtok = SP.decode_token_struct(cfg, B), RSP.decode_token_struct(rcfg, B)
        assert _same_struct(tok, rtok)
        for mesh in MESHES.values():
            rmesh = _ref_mesh(mesh)
            assert _flat(SP.batch_pspecs(mesh, got)) == _ref_flat(RSP.batch_pspecs(rmesh, want))
            assert SP.batch_pspecs(mesh, tok) == tuple(RSP.batch_pspecs(rmesh, rtok))
            assert _flat(TS.batch_pspec(mesh, got)) == _ref_flat(ref_ts.batch_pspec(rmesh, want))
    cache = lm.abstract_cache(cfg, 128, 1024)
    rcache = ref_lm.abstract_cache(rcfg, 128, 1024)
    for mesh in MESHES.values():
        assert _flat(SP.cache_pspecs(cfg, mesh, cache)) == \
            _ref_flat(RSP.cache_pspecs(rcfg, _ref_mesh(mesh), rcache))


def test_meshes_match_the_reference_shapes():
    assert (MESHES["single"].axis_names, MESHES["single"].shape) == (("data", "model"), (16, 16))
    assert (MESHES["multi"].axis_names, MESHES["multi"].shape) == \
        (("pod", "data", "model"), (2, 16, 16))
    assert MESHES["multi"].size == 512
    assert TS.dp_axes(MESHES["multi"]) == ("pod", "data")
    assert TS.dp_axes(MESHES["single"]) == ("data",)

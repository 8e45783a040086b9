"""The port's LM sharding rules and model hints against the reference's
(``repro_torch.distributed`` against ``repro.distributed``).

The rules read only a mesh's axis names and sizes, so both packages take
them at the production sizes without devices: the reference on
``jax.sharding.AbstractMesh``, the port on a shape-only
``repro_torch.launch.LMMesh``, at ``(1, 1)``, ``(4, 2)``, ``(16, 16)``
and ``(2, 16, 16)`` (``pod``, ``data``, ``model``).  For all ten
architectures at their published sizes (the reference's shapes from
``jax.eval_shape`` of its ``init_params``, the port's from
``abstract_params``), every spec equals the reference's as a tuple:

* ``spec_for_param`` and ``param_shardings`` under ``tp`` and ``fsdp``;
* ``cache_shardings`` at batch 1, 8 and 32;
* ``batch_spec``, ``input_shardings``, ``logical_to_sharding`` and
  ``_filter_spec`` over every axis combination and both profiles;
* named cases of the divisibility fallback at a 16-way model axis;
* ``to_placements`` nests a multi-axis dimension in mesh order and
  refuses any other order.

The model hints: an AST scan finds the port's ``constrain`` and
``axis_size`` calls at the reference's sites (module and function) with
its arguments, 20 in each; and with both packages' hints recorded (the
functions patched inside the test only), one forward, one prefill and
one decode step of each reduced architecture give the same set of
``(module, function, axes)`` in both (the port's mamba1 prefill adds the
two hints of ``mamba1_forward``, which the reference's inlined copy of
that block lacks).
"""
import ast
import collections
import functools
import itertools
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax._src.named_sharding import DuplicateSpecError
from jax.sharding import AbstractMesh

import repro.models.model as RM
from repro.configs import ARCH_IDS, get_config, reduced
from repro.distributed import shardctx as r_ctx
from repro.distributed import sharding as r_sh
from repro_torch.distributed import shardctx as p_ctx
from repro_torch.distributed import sharding as p_sh
from repro_torch.launch import LMMesh
from repro_torch.models import model as PM
from repro_torch.tree import paths

SRC = Path(__file__).resolve().parents[1] / "src"
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), LMMesh(sizes, names)


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = get_config(arch)
    return jax.eval_shape(lambda: RM.init_params(cfg, jax.random.PRNGKey(0)))


def _flat_ref(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(k.key) for k in path)] = leaf
    return out


def _specs(tree):
    """{path: spec tuple} of a sharding tree of either package."""
    flat = (dict(paths(tree)) if _is_port(tree) else _flat_ref(tree))
    return {k: tuple(v.spec) for k, v in flat.items()}


def _is_port(tree):
    leaf = next(v for _, v in paths(tree))
    return isinstance(leaf, p_sh.NamedSharding)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_for_param_matches_reference(arch, mesh):
    rm, pm = _meshes(mesh)
    port = dict(paths(PM.abstract_params(get_config(arch))))
    ref = _flat_ref(_ref_shapes(arch))
    assert sorted(port) == sorted(ref)
    for path, leaf in port.items():
        assert tuple(leaf.shape) == tuple(ref[path].shape), path
        got = p_sh.spec_for_param(path, tuple(leaf.shape), pm)
        want = r_sh.spec_for_param(path, ref[path].shape, rm)
        assert isinstance(got, p_sh.PartitionSpec)
        assert tuple(got) == tuple(want), (path, got, want)


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_shardings_match_reference(arch, mesh, profile):
    rm, pm = _meshes(mesh)
    port = p_sh.param_shardings(PM.abstract_params(get_config(arch)), pm,
                                profile=profile)
    ref = r_sh.param_shardings(_ref_shapes(arch), rm, profile=profile)
    assert _specs(port) == _specs(ref)
    assert all(s.mesh is pm for _, s in paths(port))


def test_divisibility_fallback_at_a_16_way_model_axis():
    """Mixtral's 8 experts do not divide a 16-way model axis: the expert
    matrices fall back to TP inside (experts replicated); granite-moe's
    32 do and shard over experts; a head count that does not divide
    drops the axis on its own dimension only."""
    rm, pm = _meshes("16x16")
    cases = [
        ("mixtral_8x7b", "layers/we_gate", (None, None, "data", "model")),
        ("mixtral_8x7b", "layers/we_up", (None, None, "data", "model")),
        ("mixtral_8x7b", "layers/we_down", (None, None, "model", "data")),
        ("granite_moe_1b_a400m", "layers/we_gate",
         (None, "model", "data", None)),
        ("granite_moe_1b_a400m", "layers/we_down",
         (None, "model", None, "data")),
        ("mixtral_8x7b", "layers/router", (None, "data", None)),
        ("olmo_1b", "embed", ("model", "data")),
        ("olmo_1b", "layers/wq", (None, "data", "model")),
    ]
    for arch, path, want in cases:
        shape = tuple(_flat_ref(_ref_shapes(arch))[path].shape)
        got = p_sh.spec_for_param(path, shape, pm)
        assert tuple(got) == want, (arch, path, got)
        assert tuple(r_sh.spec_for_param(path, shape, rm)) == want
    # a dimension that no candidate divides keeps only the axes that do
    shape = (4, 56 * 128, 7 * 128)
    for path in ("layers/wq", "layers/wo"):
        got = p_sh.spec_for_param(path, shape, pm)
        assert tuple(got) == tuple(r_sh.spec_for_param(path, shape, rm))
    assert tuple(p_sh.spec_for_param("layers/bq", (4, 56), pm)) == \
        (None, None)


# ---------------------------------------------------------------------------
# Caches, batches, inputs, logical axes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("batch", [1, 8, 32])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shardings_match_reference(arch, mesh, batch):
    rm, pm = _meshes(mesh)
    cfg = get_config(arch)
    port = p_sh.cache_shardings(pm, PM.abstract_cache(cfg, batch, 4096),
                                batch)
    ref = r_sh.cache_shardings(rm, RM.abstract_cache(cfg, batch, 4096),
                               batch)
    assert _specs(port) == _specs(ref)


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_spec_matches_reference(mesh, profile):
    rm, pm = _meshes(mesh)
    for batch in (1, 2, 3, 8, 16, 32, 64, 256, 512, 1024):
        for extra in (0, 1, 2):
            got = p_sh.batch_spec(pm, batch, extra_dims=extra,
                                  profile=profile)
            want = r_sh.batch_spec(rm, batch, extra_dims=extra,
                                   profile=profile)
            assert tuple(got) == tuple(want), (batch, extra, got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_input_and_logical_shardings_match_reference(mesh):
    rm, pm = _meshes(mesh)
    for batch in (1, 4, 8, 32, 512):
        got = p_sh.input_shardings(pm, batch)
        want = r_sh.input_shardings(rm, batch)
        assert sorted(got) == sorted(want)
        for k in got:
            assert tuple(got[k].spec) == tuple(want[k].spec), (batch, k)
    refused = 0
    for axes in _axis_combinations(3, lists=False):
        try:
            want = r_sh.logical_to_sharding(rm, *axes)
        except DuplicateSpecError:
            with pytest.raises(ValueError, match="more than one"):
                p_sh.logical_to_sharding(pm, *axes)
            refused += 1
            continue
        got = p_sh.logical_to_sharding(pm, *axes)
        assert tuple(got.spec) == tuple(want.spec), axes
    assert refused > 0


def _axis_combinations(max_dims, lists=True):
    """Every spec of up to ``max_dims`` entries (a list entry only where
    the reference takes one: ``constrain``'s axes)."""
    entries = [None, "data", "model", "pod", ("pod", "data"),
               ("data", "model"), ("pod", "data", "model"), ("model",)]
    if lists:
        entries.append(["data", "model"])
    for n in range(max_dims + 1):
        yield from itertools.product(entries, repeat=n)


@pytest.mark.parametrize("profile", ["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_filter_spec_matches_reference(mesh, profile):
    rm, pm = _meshes(mesh)
    n = 0
    for axes in _axis_combinations(3):
        got = p_ctx._filter_spec(pm, axes, profile)
        want = r_ctx._filter_spec(rm, axes, profile)
        assert tuple(got) == tuple(want), (axes, got, want)
        n += 1
    assert n == 1 + 9 + 9 ** 2 + 9 ** 3


def test_axis_size_and_use_mesh_nest_and_restore():
    _, pm = _meshes("2x16x16")
    _, small = _meshes("4x2")
    assert p_ctx.current_mesh() is None and p_ctx.axis_size("model") == 1
    with p_ctx.use_mesh(pm, profile="fsdp"):
        assert p_ctx.axis_size("pod") == 2 and p_ctx.axis_size("model") == 16
        assert p_ctx.current_profile() == "fsdp"
        with p_ctx.use_mesh(small):
            assert p_ctx.axis_size("data") == 4
            assert p_ctx.axis_size("pod") == 1
            assert p_ctx.current_profile() == "tp"
        assert p_ctx.current_mesh() is pm
        assert p_ctx.current_profile() == "fsdp"
        x = torch.ones(2, 3)
        assert p_ctx.constrain(x, "data", "model") is x   # a plain tensor
    assert p_ctx.current_mesh() is None
    assert tuple(p_ctx.named_sharding(pm, ("pod", "data"), None,
                                      "model").spec) == \
        (("pod", "data"), None, "model")


# ---------------------------------------------------------------------------
# Placements
# ---------------------------------------------------------------------------
def test_to_placements_nest_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    _, pm = _meshes("2x16x16")
    assert p_sh.to_placements(p_sh.P(("pod", "data"), None, "model"),
                              pm) == (Shard(0), Shard(0), Shard(2))
    assert p_sh.to_placements(p_sh.P(None, ("pod", "data", "model")),
                              pm) == (Shard(1),) * 3
    assert p_sh.to_placements(p_sh.P(), pm) == (Replicate(),) * 3
    assert p_sh.to_placements(p_sh.P("model", "data"), pm) == \
        (Replicate(), Shard(1), Shard(0))
    # an axis of size 1 replicates
    _, one = _meshes("1x1")
    assert p_sh.to_placements(p_sh.P("data", "model"), one) == \
        (Replicate(), Replicate())
    assert p_sh.to_placements(p_sh.P(("pod", "data")), LMMesh(
        (1, 4), ("pod", "data"))) == (Replicate(), Shard(0))
    with pytest.raises(ValueError, match="mesh order"):
        p_sh.to_placements(p_sh.P(("data", "pod")), pm)
    with pytest.raises(ValueError, match="twice"):
        p_sh.to_placements(p_sh.P("data", "data"), pm)
    # every spec the rules give converts on its mesh
    for name in MESHES:
        _, m = _meshes(name)
        for arch in ("mixtral_8x7b", "zamba2_1p2b"):
            for profile in ("tp", "fsdp"):
                for _, s in paths(p_sh.param_shardings(
                        PM.abstract_params(get_config(arch)), m, profile)):
                    assert len(s.placements) == len(m.axis_names)


def test_partition_spec_is_a_tuple_like_the_references():
    from jax.sharding import PartitionSpec as RP
    for axes in [(), (None,), ("data", None), (("pod", "data"), "model"),
                 (["data", "model"],), (("data",), ()), (["model"],)]:
        assert tuple(p_sh.P(*axes)) == tuple(RP(*axes))
        assert p_sh.P(*axes) == tuple(RP(*axes))


@pytest.mark.parametrize("shape,dim", [((2, 12), 1), ((5,), 0),
                                       ((3, 4, 7), 2), ((3, 1, 2), 1)])
def test_roll_is_torch_roll(shape, dim):
    """``distributed.ops.roll`` (slices and a concatenation, which
    DTensor takes) equals ``torch.roll`` for every shift, negative
    included."""
    from repro_torch.distributed.ops import roll
    x = torch.arange(int(np.prod(shape))).reshape(shape)
    n = shape[dim]
    for shift in range(-2 * n - 1, 2 * n + 2):
        assert torch.equal(roll(x, shift, dim), torch.roll(x, shift, dim))


def test_lm_mesh_shape_is_an_ordered_mapping():
    rm, pm = _meshes("2x16x16")
    assert pm.shape == rm.shape
    assert list(pm.shape) == ["pod", "data", "model"]
    assert pm.size == 512 and pm.device_mesh is None
    with pytest.raises(ValueError):
        LMMesh((2, 2), ("data",))


# ---------------------------------------------------------------------------
# The 20 model hints
# ---------------------------------------------------------------------------
_HINT_MODULES = ("common", "model", "moe", "ssm")


def _hint_calls(pkg):
    """(module, enclosing function, call source) of every ``constrain`` /
    ``axis_size`` call in ``pkg``'s model modules."""
    out = collections.Counter()
    for mod in _HINT_MODULES:
        tree = ast.parse((SRC / pkg / "models" / f"{mod}.py").read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Name) and node.func.id in (
                        "constrain", "axis_size"):
                    args = tuple(ast.unparse(a) for a in node.args[1:]) \
                        if node.func.id == "constrain" else \
                        tuple(ast.unparse(a) for a in node.args)
                    out[(mod, fn.name, node.func.id, args)] += 1
    return out


def test_hints_sit_at_the_references_sites():
    ref, port = _hint_calls("repro"), _hint_calls("repro_torch")
    assert sum(ref.values()) == 20
    assert port == ref


def _recorder(log, module):
    def constrain(x, *axes):
        f = sys._getframe(1)
        log.add((module, f.f_code.co_name, "constrain", tuple(axes)))
        return x

    def axis_size(name):
        f = sys._getframe(1)
        log.add((module, f.f_code.co_name, "axis_size", (name,)))
        return 1
    return constrain, axis_size


def _patch_hints(monkeypatch, pkg, log):
    for mod in _HINT_MODULES:
        m = sys.modules[f"{pkg}.models.{mod}"]
        constrain, axis_size = _recorder(log, mod)
        if hasattr(m, "constrain"):
            monkeypatch.setattr(m, "constrain", constrain)
        if hasattr(m, "axis_size"):
            monkeypatch.setattr(m, "axis_size", axis_size)


def _inputs(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    batch = {}
    if cfg.family == "vlm":
        batch["embeds"] = rng.standard_normal((b, s, cfg.d_model),
                                              dtype=np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(
            np.int32)
    if cfg.family == "encdec":
        batch["audio_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    nxt = (rng.standard_normal((b, 1, cfg.d_model), dtype=np.float32)
           if cfg.family == "vlm" else
           rng.integers(0, cfg.vocab, (b, 1)).astype(np.int32))
    return batch, nxt


def _ref_run(cfg, batch, nxt, what):
    import jax.numpy as jnp
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if what == "forward":
        RM.forward(params, jb, cfg)
        return
    cache = RM.init_cache(cfg, nxt.shape[0], 24)
    _, cache = RM.prefill(params, jb, cache, cfg)
    if what == "decode":
        RM.decode_step(params, jnp.asarray(nxt), cache, cfg)


def _port_run(cfg, batch, nxt, what):
    params = PM.init_params(cfg, 0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        if what == "forward":
            PM.forward(params, tb, cfg)
            return
        cache = PM.init_cache(cfg, nxt.shape[0], 24, device="cpu")
        _, cache = PM.prefill(params, tb, cache, cfg)
        if what == "decode":
            PM.decode_step(params, torch.from_numpy(nxt), cache, cfg)


def _sites(monkeypatch, pkg, run, cfg, batch, nxt, what):
    log = set()
    with monkeypatch.context() as mp:
        _patch_hints(mp, pkg, log)
        run(cfg, batch, nxt, what)
    return log


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_hints_fire_at_the_references_sites(arch, monkeypatch):
    """One forward, one prefill, one decode step: the same (module,
    function, axes) in both packages."""
    cfg = reduced(get_config(arch))
    batch, nxt = _inputs(cfg)
    for what in ("forward", "prefill", "decode"):
        ref = _sites(monkeypatch, "repro", _ref_run, cfg, batch, nxt, what)
        port = _sites(monkeypatch, "repro_torch", _port_run, cfg, batch,
                      nxt, what)
        if cfg.family == "ssm" and what != "forward":
            extra = {("ssm", "mamba1_forward", "constrain",
                      ("data", None, "model"))}
            assert port == ref | extra, what
        else:
            assert port == ref, (what, port ^ ref)
        assert ref, what

"""The port's launch layer against ``repro``'s.

Logical specs (``resolve_spec``, ``resolve_tree``, ``batch_axes``), the
cell registry and ``cell_options`` equal the reference's; every port
parameter's spec, mapped through ``convert.ref_path``, equals the
reference's ``param_specs`` leaf without its stacked leading None, for
every arch's smoke config; ``input_specs``, the decode cache's specs and
``train_state_specs`` equal the reference's.  The op-level counter
(``op_cost``) is held to analytic counts and to ``repro.launch.hlo_cost``
on the same programs (a loop of matmuls, nested loops, one product); a
smoke train step counted on fake tensors equals the count on real CPU
tensors, and the flash operator's counted FLOPs equal its formula.  On a
2 x 2 mesh simulated in one process (``LocalTensorMode``) a smoke model's
logits equal the unsharded port's within float32 rounding (``1e-5`` x max
|logit|; the loss within ``1e-5`` relative), ``remesh`` round-trips
bitwise and microbatches split each device's own rows; on a fake 2 x 2
mesh a prefill's and a gradient's per-device matmul FLOPs times 4 equal
the unsharded count.  The two remat policies give bitwise-equal
gradients.  ``model_flops`` and
``ideal_bytes`` equal the reference's for all 32 cells, one
production-mesh dry run (``qwen3-1.7b`` x ``decode_32k`` on 16 x 16) runs
with its per-device parameter bytes equal to the resolved shards' sum, and
importing the launch layer opens no process group and sets no variable.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_arch as jget_arch
from repro.configs import runnable_cells as jrunnable
from repro.configs import skipped_cells as jskipped
from repro.launch import cells as jcells
from repro.launch import hlo_cost
from repro.launch import mesh as jmesh
from repro.launch import roofline as jroofline
from repro.models import build_model as jbuild_model
from repro.models import input_specs as jinput_specs
from repro.train.train_loop import TrainOptions as JTrainOptions
from repro.train.train_loop import train_state_specs as jtrain_state_specs
from repro_torch import convert
from repro_torch.configs import (SHAPES, get_arch, list_archs,
                                 runnable_cells, skipped_cells)
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch import cells, dryrun, roofline
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import build_model, input_specs, sharding
from repro_torch.models import transformer
from repro_torch.models import layers as L
from repro_torch.train import (OptimizerConfig, TrainOptions,
                               build_train_step, init_train_state, remesh,
                               train_state_specs)


def spec_of(p) -> tuple:
    """A reference ``PartitionSpec`` as the port's plain tuple."""
    return tuple(p)


# ---------------------------------------------------------------------------
# Specs and cells
# ---------------------------------------------------------------------------

RESOLVE_CASES = [
    (("fsdp", "model"), False), (("batch", None), False),
    ((None, "batch", "seq2"), False), (("batch", None), True),
    (("fsdp", "model"), True),
]


@pytest.mark.parametrize("spec,multi_pod", RESOLVE_CASES)
def test_resolve_spec_equals_the_reference(spec, multi_pod):
    assert mesh_lib.resolve_spec(spec, multi_pod) == spec_of(
        jmesh.resolve_spec(P(*spec), multi_pod))


def test_resolve_tree_and_batch_axes_equal_the_reference():
    tree = {"a": ("batch",), "b": {"c": (None, "model")}}
    jtree = {"a": P("batch"), "b": {"c": P(None, "model")}}
    for mp in (False, True):
        got = mesh_lib.resolve_tree(tree, mp)
        want = jmesh.resolve_tree(jtree, mp)
        assert got["a"] == spec_of(want["a"])
        assert got["b"]["c"] == spec_of(want["b"]["c"])
        assert mesh_lib.batch_axes(mp) == jmesh.batch_axes(mp)


def test_cell_registry_equals_the_reference():
    assert runnable_cells() == jrunnable()
    assert skipped_cells() == jskipped()
    assert len(runnable_cells()) == 32 and len(skipped_cells()) == 8


def test_cell_options_equal_the_reference_for_every_cell():
    for arch, shape in runnable_cells():
        got = cells.cell_options(arch, shape)
        want = jcells.cell_options(arch, shape)
        assert dataclasses.asdict(got.train) == dataclasses.asdict(
            want.train), (arch, shape)
        assert dataclasses.asdict(got.opt) == dataclasses.asdict(want.opt)
        assert got.seq_parallel == want.seq_parallel
        assert got.cache_seq_axes == want.cache_seq_axes


def ref_leaf(tree, name):
    """The reference's spec of the port's parameter ``name``; a stacked
    leaf's spec without its leading None."""
    path, layer = convert.ref_path(name)
    for key in path:
        tree = tree[key]
    spec = spec_of(tree)
    if layer is not None:
        assert spec[0] is None
        spec = spec[1:]
    return spec


@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_equal_the_reference(arch):
    cfg = get_arch(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    specs = model.param_specs()
    jspecs = jbuild_model(jget_arch(arch, smoke=True)).param_specs()
    names = [n for n, _ in params.named_parameters()]
    assert set(names) == set(specs)
    for name in names:
        assert specs[name] == ref_leaf(jspecs, name), name
        assert len(specs[name]) == params.get_parameter(name).dim(), name


def same_dtype(torch_dtype, jax_dtype) -> bool:
    return str(torch_dtype).removeprefix("torch.") == str(
        jnp.dtype(jax_dtype))


INPUT_CASES = [("qwen3-1.7b", "train_4k"), ("rwkv6-3b", "decode_32k"),
               ("paligemma-3b", "prefill_32k"),
               ("musicgen-large", "decode_32k")]


@pytest.mark.parametrize("arch,shape", INPUT_CASES)
def test_input_specs_equal_the_reference(arch, shape):
    shapes, specs = input_specs(get_arch(arch), SHAPES[shape])
    jshapes, jspecs = jinput_specs(jget_arch(arch), JSHAPES[shape])
    assert set(shapes) == set(jshapes) == set(specs) == set(jspecs)
    for k, (shp, dt) in shapes.items():
        assert shp == jshapes[k].shape and same_dtype(dt, jshapes[k].dtype)
        assert specs[k] == spec_of(jspecs[k])


def same_tree(got, want):
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            same_tree(got[k], want[k])
    else:
        assert got == spec_of(want)


@pytest.mark.parametrize("arch,shape", [
    c for c in jrunnable() if JSHAPES[c[1]].kind == "decode"])
def test_cache_specs_equal_the_reference(arch, shape):
    axes = cells.cell_options(arch, shape).cache_seq_axes
    sh = SHAPES[shape]
    model = build_model(get_arch(arch), device="cpu")
    jshapes, jspecs = jbuild_model(jget_arch(arch)).cache_spec(
        sh.global_batch, sh.seq_len, seq_axes=axes)
    same_tree(model.cache_specs(axes), jspecs)
    shapes = model.cache_spec(sh.global_batch, sh.seq_len)
    flat = {k: v for k, v in shapes.items() if k not in ("index", "mamba")}
    flat.update({f"mamba.{k}": v for k, v in shapes.get("mamba", {}).items()})
    for k, (shp, dt) in flat.items():
        want = jshapes[k] if "." not in k else jshapes["mamba"][k[6:]]
        assert shp == want.shape and same_dtype(dt, want.dtype), k


@pytest.mark.parametrize("compress", [False, True])
def test_train_state_specs_equal_the_reference(compress):
    cfg = get_arch("qwen3-1.7b", smoke=True)
    model = build_model(cfg, device="cpu")
    got = train_state_specs(model, TrainOptions(compress_grads=compress))
    want = jtrain_state_specs(jbuild_model(jget_arch("qwen3-1.7b",
                                                     smoke=True)),
                              JTrainOptions(compress_grads=compress))
    assert set(got) == set(want)
    trees = [(got["params"], want["params"]),
             (got["opt"]["m"], want["opt"]["m"]),
             (got["opt"]["v"], want["opt"]["v"])]
    if compress:
        trees.append((got["ef_residual"], want["ef_residual"]))
    for mine, ref in trees:
        for name, spec in mine.items():
            assert spec == ref_leaf(ref, name), name
    assert got["opt"]["step"] == spec_of(want["opt"]["step"])


# ---------------------------------------------------------------------------
# The op-level counter
# ---------------------------------------------------------------------------

def count(fn, *args):
    with OpCost() as c:
        fn(*args)
    return c.record()


def hlo(fn, *args):
    return hlo_cost.analyze(jax.jit(fn).lower(*args).compile().as_text())


def test_counter_loop_of_matmuls_counts_every_trip():
    d, n = 64, 10
    x, ws = np.ones((8, d), np.float32), np.ones((n, d, d), np.float32)

    def tloop(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    def jloop(x, ws):
        return jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)[0]

    got = count(tloop, torch.tensor(x), torch.tensor(ws))
    assert got["flops_per_device"] == n * 2 * 8 * d * d
    assert got["flops_per_device"] == pytest.approx(
        hlo(jloop, x, ws)["flops_per_device"], rel=0.05)


def test_counter_nested_loops_multiply():
    d, outer, inner = 32, 4, 5
    x = np.ones((4, d), np.float32)
    ws = np.ones((outer, inner, d, d), np.float32)

    def tloop(x, ws):
        for grp in ws:
            for w in grp:
                x = x @ w
        return x

    def jloop(x, ws):
        def ob(x, grp):
            return jax.lax.scan(lambda x, w: (x @ w, None), x, grp)[0], None
        return jax.lax.scan(ob, x, ws)[0]

    got = count(tloop, torch.tensor(x), torch.tensor(ws))
    assert got["flops_per_device"] == outer * inner * 2 * 4 * d * d
    assert got["flops_per_device"] == pytest.approx(
        hlo(jloop, x, ws)["flops_per_device"], rel=0.05)


def test_counter_one_product_is_exact_and_counts_its_bytes():
    a, b = np.ones((32, 16), np.float32), np.ones((16, 8), np.float32)
    got = count(torch.matmul, torch.tensor(a), torch.tensor(b))
    assert got["flops_per_device"] == 2 * 32 * 16 * 8
    assert got["flops_per_device"] == pytest.approx(
        hlo(lambda a, b: a @ b, a, b)["flops_per_device"], rel=0.01)
    assert got["bytes_per_device"] >= (32 * 16 + 16 * 8 + 32 * 8) * 4
    # Views move nothing.
    assert count(lambda t: t.view(-1).unsqueeze(0).t(), torch.tensor(a))[
        "bytes_per_device"] == 0


def test_flash_operator_flops_equal_its_formula():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 4, 16, generator=g, requires_grad=True)
    k = torch.randn(2, 40, 2, 16, generator=g, requires_grad=True)
    v = torch.randn(2, 40, 2, 16, generator=g, requires_grad=True)
    with OpCost() as c:
        out = fa.flash_attention(q, k, v, prefix_len=5)
        out.sum().backward()
    pairs = sum(min(40, max(t + 1, 5)) for t in range(40))
    assert fa.visible_pairs(40, 40, True, 5, None, 0) == pairs
    rec = c.record()
    assert rec["calls"]["repro_torch.flash_attention"] == 1
    assert rec["calls"]["repro_torch.flash_attention_bwd"] == 1
    with OpCost(keep_ops=True) as c:
        fa.flash_attention(q.detach(), k.detach(), v.detach(), prefix_len=5)
    (row,) = [r for r in c.table() if r[0] == "repro_torch.flash_attention"]
    assert row[3] == 4 * 16 * 2 * 4 * pairs


def smoke_step_count(fake: bool):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = get_arch("qwen3-1.7b", smoke=True)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 24))
    batch = {"tokens": toks, "targets": np.roll(toks, -1, 1)}
    ctx = FakeTensorMode() if fake else torch.no_grad()
    with ctx:
        model = build_model(cfg, device="cpu")
        state = init_train_state(model, torch.Generator().manual_seed(0),
                                 OptimizerConfig())
        batch = {k: torch.tensor(v) for k, v in batch.items()}
        step = build_train_step(model, OptimizerConfig(),
                                TrainOptions(microbatches=2))
        with torch.enable_grad(), OpCost() as c:
            step(state, batch)
    return c.record()


def test_counting_on_fake_tensors_equals_counting_on_real_ones():
    real, fake = smoke_step_count(False), smoke_step_count(True)
    assert real["flops_per_device"] > 0
    assert fake == real
    assert real["calls"]["repro_torch.flash_attention"] == 8   # 2 x (2 + 2)
    assert real["calls"]["repro_torch.flash_attention_bwd"] == 4


# ---------------------------------------------------------------------------
# Sharded values and costs
# ---------------------------------------------------------------------------

@pytest.fixture
def world4():
    with mesh_lib.fake_world(4):
        from torch.distributed.device_mesh import init_device_mesh
        yield init_device_mesh("cpu", (2, 2),
                               mesh_dim_names=("data", "model"))


def smoke(vocab=None):
    cfg = get_arch("qwen3-1.7b", smoke=True)
    if vocab:
        cfg = dataclasses.replace(cfg, vocab=vocab)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(1).integers(0, cfg.vocab,
                                                          (4, 16)))
    return cfg, model, params, toks


def rank0(t):
    from torch.distributed._local_tensor import LocalTensor
    return t._local_tensors[0] if isinstance(t, LocalTensor) else t


def test_sharded_logits_equal_the_unsharded_ones(world4):
    from torch.distributed._local_tensor import LocalTensorMode
    cfg, model, params, toks = smoke()
    for p in params.parameters():
        p.data = p.data.float()
    want = model.forward(params, {"tokens": toks})
    with LocalTensorMode(frozenset(range(4))):
        sp = dryrun.shard_module(copy.deepcopy(params), model.param_specs(),
                                 world4, False)
        assert any(pl.is_shard() for p in sp.parameters()
                   for pl in p.placements)
        with sharding.mesh_context(world4, ("data",)):
            batch = {"tokens": dryrun._distribute(toks, ("batch", None),
                                                  world4, False)}
            got = rank0(model.forward(sp, batch).full_tensor())
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


def test_sharded_loss_equals_the_unsharded_one(world4):
    """The vocab-partitioned log-sum-exp and one-hot target of the chunked
    loss give the unsharded loss."""
    from torch.distributed._local_tensor import LocalTensorMode
    cfg, model, params, toks = smoke(vocab=488)
    for p in params.parameters():
        p.data = p.data.float()
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    batch["targets"][:, -1] = -1
    want = model.loss_fn(params, batch)
    with LocalTensorMode(frozenset(range(4))):
        sp = dryrun.shard_module(copy.deepcopy(params), model.param_specs(),
                                 world4, False)
        with sharding.mesh_context(world4, ("data",)):
            sb = {k: dryrun._distribute(v, ("batch", None), world4, False)
                  for k, v in batch.items()}
            got = rank0(model.loss_fn(sp, sb).full_tensor())
    assert abs(got.item() - want.item()) <= 1e-5 * abs(want.item())


def test_remesh_round_trips_bitwise(world4):
    from torch.distributed._local_tensor import LocalTensorMode
    from torch.distributed.tensor import Replicate
    _, model, params, _ = smoke()
    with LocalTensorMode(frozenset(range(4))):
        sp = dryrun.shard_module(copy.deepcopy(params), model.param_specs(),
                                 world4, False)
        state = {"params": sp, "step": torch.zeros(())}
        before = {n: p.placements for n, p in sp.named_parameters()}
        flat = {n: (world4, (Replicate(), Replicate())) for n in before}
        state = remesh(state, {"params": flat})
        assert all(p.placements == (Replicate(), Replicate())
                   for p in state["params"].parameters())
        back = {n: (world4, pl) for n, pl in before.items()}
        state = remesh(state, {"params": back})
        for n, p in state["params"].named_parameters():
            assert p.placements == before[n]
            assert torch.equal(rank0(p.full_tensor()),
                               params.get_parameter(n)), n


@pytest.mark.parametrize("rows,n,moves", [(8, 2, False), (4, 4, True)])
def test_microbatches_split_each_devices_rows(world4, rows, n, moves):
    from torch.distributed._local_tensor import LocalTensorMode
    from repro_torch.train.train_loop import _split
    x = torch.arange(rows * 3).reshape(rows, 3)
    with LocalTensorMode(frozenset(range(4))):
        dx = dryrun._distribute(x, ("batch", None), world4, False)
        with OpCost() as c:
            parts = _split(dx, n)
        got = [rank0(p.full_tensor()) for p in parts]
    assert all(p.shape == (rows // n, 3) for p in parts)
    assert sorted(torch.cat(got)[:, 0].tolist()) == x[:, 0].tolist()
    assert bool(c.record()["collective_counts_by_type"]) == moves


def mm_flops(table) -> int:
    return sum(r[3] for r in table if r[0] in ("aten.mm", "aten.bmm",
                                               "aten.addmm"))


def test_sharded_prefill_splits_the_matmul_flops_four_ways(world4):
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, model, params, toks = smoke(vocab=488)
    with OpCost(keep_ops=True) as whole:
        model.prefill(params, {"tokens": toks})
    with FakeTensorMode(allow_non_fake_inputs=True), \
            sharding.mesh_context(world4, ("data",)):
        sp = dryrun.shard_module(copy.deepcopy(params), model.param_specs(),
                                 world4, False)
        batch = {"tokens": dryrun._distribute(toks, ("batch", None), world4,
                                              False)}
        with OpCost(keep_ops=True) as part:
            model.prefill(sp, batch)
    assert mm_flops(part.table()) * 4 == mm_flops(whole.table())
    rec = part.record()
    assert rec["collective_counts_by_type"].get("all-gather", 0) > 0


def test_sharded_gradients_split_the_matmul_flops_four_ways(world4):
    """The constraints hold the gradients too: no product in the backward
    gathers a whole weight to take a partial-sum gradient."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg, model, params, toks = smoke(vocab=488)
    params = transformer.trainable(params)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}

    def grads(p, b):
        return torch.autograd.grad(model.loss_fn(p, b), list(p.parameters()))
    with OpCost(keep_ops=True) as whole:
        grads(params, batch)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            sharding.mesh_context(world4, ("data",)):
        sp = dryrun.shard_module(copy.deepcopy(params), model.param_specs(),
                                 world4, False)
        sb = {k: dryrun._distribute(v, ("batch", None), world4, False)
              for k, v in batch.items()}
        with OpCost(keep_ops=True) as part:
            grads(sp, sb)
    assert mm_flops(part.table()) * 4 == mm_flops(whole.table())


def test_remat_dots_keeps_the_gradients_and_recomputes_fewer_products():
    cfg, model, params, toks = smoke()
    params = transformer.trainable(params)
    batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
    out = {}
    try:
        for policy in ("nothing", "dots"):
            L.set_remat_policy(policy)
            with OpCost(keep_ops=True) as c:
                loss = model.loss_fn(params, batch)
                grads = torch.autograd.grad(loss, list(params.parameters()))
            out[policy] = (grads, mm_flops(c.table()))
    finally:
        L.set_remat_policy("nothing")
    for a, b in zip(out["nothing"][0], out["dots"][0]):
        assert torch.equal(a, b)
    assert out["dots"][1] < out["nothing"][1]
    with pytest.raises(ValueError):
        L.set_remat_policy("everything")


# ---------------------------------------------------------------------------
# Roofline and the dry run
# ---------------------------------------------------------------------------

def test_roofline_analytic_terms_equal_the_reference():
    for arch, shape in runnable_cells():
        assert roofline.model_flops(arch, shape) == \
            jroofline.model_flops(arch, shape)
        for od in ("float32", "bfloat16"):
            assert roofline.ideal_bytes(arch, shape, od) == \
                jroofline.ideal_bytes(arch, shape, od)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)


def test_production_mesh_dry_run_of_a_decode_cell():
    rec = dryrun.run_cell("qwen3-1.7b", "decode_32k", False, device="cpu")
    assert rec["num_devices"] == 256 and rec["mesh"] == "16x16"
    cfg = get_arch("qwen3-1.7b")
    sizes = {"data": 16, "model": 16}
    # The resolved shards' sum, from the specs and the shapes alone.
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        params = build_model(cfg, device="cpu").init_params(
            torch.Generator().manual_seed(0))
    specs = build_model(cfg, device="cpu").param_specs()
    want = 0
    for name, p in params.named_parameters():
        n = p.element_size()
        for dim, el in zip(p.shape, mesh_lib.resolve_spec(specs[name],
                                                          False)):
            axes = () if el is None else (
                el if isinstance(el, tuple) else (el,))
            while axes and dim % int(np.prod([sizes[a] for a in axes])):
                axes = axes[1:]
            n *= dim // int(np.prod([sizes[a] for a in axes]))
        want += n
    mem = rec["memory_analysis"]
    assert mem["param_bytes"] == want
    assert 0 < mem["peak_bytes"] and mem["fits"]
    oc = rec["op_cost"]
    assert oc["flops_per_device"] > 0 and oc["collective_bytes_per_device"] > 0
    assert oc["flops_per_device"] < roofline.model_flops(
        "qwen3-1.7b", "decode_32k")


def test_importing_the_launch_layer_opens_no_group_and_sets_no_variable():
    import subprocess
    import sys
    code = (
        "import os, importlib; before = dict(os.environ)\n"
        "for m in ('mesh', 'cells', 'dryrun', 'op_cost', 'roofline',"
        " 'breakdown', 'train', 'shard_host'):\n"
        "    importlib.import_module('repro_torch.launch.' + m)\n"
        "importlib.import_module('repro_torch.models.sharding')\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "assert dict(os.environ) == before\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
